"""Shared model building blocks, in PyTorch.

Counterpart of `repro.models.common`. Parameters are plain nested dicts of
tensors. Every projection goes through `linear`, which runs the dense or the
LUT path of its site's statically resolved mode. Initializers draw from an
explicit `torch.Generator` on its own device and move the result to `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.amm import LUTConfig, Mode, lut_linear
from repro_torch.core.lut_layer import ParamSpec, deploy_param_specs

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


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def linear_init(gen: torch.Generator, site: SiteCfg, *, dtype=torch.float32,
                device: torch.device | str = "cpu") -> Params:
    """Params of a site in its mode (DENSE or LUT_INFER), as in the reference:
    DENSE     {"w": N(0, 1/d_in) [, "b": 0]}
    LUT_INFER {"centroids": N(0, 0.02^2), "table_q": uniform int8 in [-127, 126],
               "table_scale": 0.02 [, "b": 0]}
    """
    if site.mode == Mode.DENSE:
        p = {"w": (_randn(gen, (site.d_in, site.d_out), device) / site.d_in ** 0.5).to(dtype)}
    elif site.mode == Mode.LUT_INFER:
        specs = deploy_param_specs(site.d_in, site.d_out, site.lut, bias=site.bias)
        p = {
            "centroids": _randn(gen, specs["centroids"].shape, device) * 0.02,
            "table_q": torch.randint(-127, 127, specs["table_q"].shape, generator=gen,
                                     device=gen.device, dtype=torch.int8).to(device),
            "table_scale": torch.full(specs["table_scale"].shape, 0.02, device=device),
        }
    else:
        raise NotImplementedError(f"{site.mode} sites are not ported yet: ROADMAP Queue A item 11")
    if site.bias:
        p["b"] = torch.zeros((site.d_out,), dtype=dtype, device=device)
    return p


def linear_specs(site: SiteCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `linear_init`'s params, without allocating them."""
    if site.mode == Mode.DENSE:
        p = {"w": ParamSpec((site.d_in, site.d_out), dtype)}
    elif site.mode == Mode.LUT_INFER:
        specs = deploy_param_specs(site.d_in, site.d_out, site.lut, bias=site.bias)
        p = {name: specs[name] for name in ("centroids", "table_q", "table_scale")}
    else:
        raise NotImplementedError(f"{site.mode} sites are not ported yet: ROADMAP Queue A item 11")
    if site.bias:
        p["b"] = ParamSpec((site.d_out,), dtype)
    return p


def linear(site: SiteCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Apply one linear site in its statically configured mode."""
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


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), pos (B, S) -> x rotated in the half-split layout: the
    first and second halves of Dh form the pairs (not interleaved)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = pos[:, :, None].float() * inv[None, None, :]          # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(*_args, **_kwargs):
    raise NotImplementedError("M-RoPE (qwen2_vl_7b) is not ported yet: ROADMAP Queue A item 10")


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device="cpu") -> Params:
    return {"table": (_randn(gen, (vocab, d), device) * 0.02).to(dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]
