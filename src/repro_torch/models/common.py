"""Shared model building blocks, in PyTorch.

Counterpart of `repro.models.common`. Parameters are plain nested dicts of
tensors. Every projection goes through `linear`, which runs the dense or the
LUT path of its site's statically resolved mode, and records its input on an
active activation tape (`tape_capture`, the k-means init's sample of a
site's inputs). Initializers draw from an explicit `torch.Generator` on its
own device and move the result to `device`; their streams are torch's, not
the reference's JAX keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.amm import LUTConfig, Mode, lut_linear
from repro_torch.core.lut_layer import ParamSpec, deploy_param_specs, init_dense
from repro_torch.core.temperature import init_log_temperature
from repro_torch.models import sharded

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SiteCfg:
    """Static config of one linear site, resolved at model build time."""

    d_in: int
    d_out: int
    mode: Mode
    lut: LUTConfig
    bias: bool = False
    name: str = ""
    # a tensor-parallel rank's role for the site ("col", "col_gather" or
    # "row": `models/sharded.py`; None: the whole site)
    tp: str | None = None


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def linear_init(gen: torch.Generator, site: SiteCfg, *, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Params of a site in its mode, as in the reference:
    DENSE     {"w": N(0, 1/d_in) [, "b": 0]}
    LUT_TRAIN {"w" (frozen: build_table stops its gradient), "centroids":
               N(0, 0.02^2), "log_t": 0 [, "b"]}; core.convert puts k-means
               centroids from activation samples in place of the random ones
    LUT_INFER {"centroids": N(0, 0.02^2), "table_q": uniform int8 in [-127, 126],
               "table_scale": 0.02 [, "b": 0]}
    """
    if site.mode in (Mode.DENSE, Mode.LUT_TRAIN):
        p = init_dense(gen, site.d_in, site.d_out, dtype=dtype, device=device)
        if site.mode == Mode.LUT_TRAIN:
            c = site.lut.codebooks(site.d_in)
            p["centroids"] = _randn(gen, (c, site.lut.k, site.lut.v), device) * 0.02
            p["log_t"] = init_log_temperature(device=device)
    elif site.mode == Mode.LUT_INFER:
        specs = deploy_param_specs(site.d_in, site.d_out, site.lut, bias=site.bias)
        p = {
            "centroids": _randn(gen, specs["centroids"].shape, device) * 0.02,
            "table_q": torch.randint(-127, 127, specs["table_q"].shape, generator=gen,
                                     device=gen.device, dtype=torch.int8).to(device),
            "table_scale": torch.full(specs["table_scale"].shape, 0.02, device=device),
        }
    else:
        raise ValueError(site.mode)
    if site.bias:
        p["b"] = torch.zeros((site.d_out,), dtype=dtype, device=device)
    return p


def linear_specs(site: SiteCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `linear_init`'s params, without allocating them."""
    if site.mode in (Mode.DENSE, Mode.LUT_TRAIN):
        p = {"w": ParamSpec((site.d_in, site.d_out), dtype)}
        if site.mode == Mode.LUT_TRAIN:
            p["centroids"] = ParamSpec((site.lut.codebooks(site.d_in), site.lut.k, site.lut.v),
                                       torch.float32)
            p["log_t"] = ParamSpec((), torch.float32)
    elif site.mode == Mode.LUT_INFER:
        specs = deploy_param_specs(site.d_in, site.d_out, site.lut, bias=site.bias)
        p = {name: specs[name] for name in ("centroids", "table_q", "table_scale")}
    else:
        raise ValueError(site.mode)
    if site.bias:
        p["b"] = ParamSpec((site.d_out,), dtype)
    return p


_TAPE: "tape_capture | None" = None        # the active activation tape (core.convert)


class tape_capture:
    """Context manager: record the input of every named linear site, keyed by
    '<prefix>/<site.name>' (the registry's `SiteSpec.tape_key`), at most
    `max_rows` rows per call. The layer loop sets the prefix per layer
    (`set_tape_prefix`)."""

    def __init__(self, max_rows: int = 4096):
        self.records: dict[str, list[torch.Tensor]] = {}
        self.prefix = ""
        self.max_rows = max_rows

    def record(self, site: SiteCfg, x: torch.Tensor) -> None:
        if not site.name:
            return
        key = f"{self.prefix}/{site.name}" if self.prefix else site.name
        rows = x.detach().reshape(-1, x.shape[-1])[: self.max_rows]
        self.records.setdefault(key, []).append(rows)

    def __enter__(self) -> "tape_capture":
        global _TAPE
        self._prev = _TAPE
        _TAPE = self
        return self

    def __exit__(self, *exc) -> bool:
        global _TAPE
        _TAPE = self._prev
        return False


def tape_active() -> bool:
    return _TAPE is not None


def set_tape_prefix(prefix: str) -> None:
    """Point later records at this key prefix (no-op without an active tape)."""
    if _TAPE is not None:
        _TAPE.prefix = prefix


def linear(site: SiteCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Apply one linear site in its statically configured mode. A LUT_TRAIN
    site's dense weight lives beside its centroids and is its frozen source."""
    if _TAPE is not None:
        _TAPE.record(site, x)
    if site.tp is not None:
        return sharded.linear(site, p, x)
    if site.mode == Mode.LUT_TRAIN:
        return lut_linear(site.lut, Mode.LUT_TRAIN, p, x, frozen=p)
    return lut_linear(site.lut, site.mode, p, x)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """(d_head/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by the angles (B, S, Dh/2) in the half-split
    layout: the first and second halves of Dh form the pairs (not
    interleaved)."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), pos (B, S) -> x rotated (`_rotate`)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    return _rotate(x, pos[:, :, None].float() * inv[None, None, :])


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x (B, S, H, Dh), pos3 (3, B, S) the (t, h,
    w) position streams. The Dh/2 frequencies split into consecutive
    `sections` (summing to Dh/2), each rotated by its own stream; with three
    equal streams this is `apply_rope`."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to d_head/2 = {dh // 2}")
    inv = rope_freqs(dh, theta, device=x.device)
    # output_size: known on the host, so no device read (and meta tensors run)
    sec_id = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(sections, device=x.device),
                                     output_size=dh // 2)                       # (Dh/2,)
    ang = pos3.float()[sec_id].movedim(0, -1) * inv                        # (B, S, Dh/2)
    return _rotate(x, ang)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device="cpu") -> Params:
    return {"table": (_randn(gen, (vocab, d), device) * 0.02).to(dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross-entropy in fp32. logits (..., vocab), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
