"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block, in PyTorch.

Counterpart of `repro.models.mamba2`. A prefill runs the chunked SSD
algorithm (quadratic inside chunks of Q tokens, a linear recurrence across
chunks); a decode step is the O(1) recurrent update of the cached state. The
LUT sites are `in_proj` and `out_proj`, through `common.linear` (the LUT
kernels on the card); the SSD scan contracts activations with activations
and stays plain tensor ops, as in the reference.

The serving cache of a block is per row: "conv", the last W-1 inputs of the
depthwise causal conv (the cache dtype), and "ssm", the state (H, P, N) in
fp32. A forward with a cache updates the listed rows in place (`rows`, all
when None) and leaves every other row untouched.

Where the reference is wrong, the port does not follow it. The reference
starts every multi-token forward with a cache from a zero state and a zero
conv window, and takes its conv tail from the chunk's padding
(src/repro/models/mamba2.py:181-195), so a prompt longer than one prefill
chunk, or a padded one, leaves the wrong state (ROADMAP, known reference
faults). Here a forward with a cache continues from the cached state and
conv window of the rows whose `cache_len` > 0 (rows at 0 start from zeros,
whatever a previous request left there), and stops each row's state at its
`valid` length: dt is 0 at the padded positions, which leaves the state
unchanged, and the conv tail is the last W-1 valid inputs. On a prompt of
exactly one chunk the two agree.

A tensor-parallel rank (`distributed/tensor_parallel.py`) runs its share of
the SSD heads with the same code: its in_proj columns, conv channels and
cache rows are its heads' (the B and C columns whole), and only the gated
norm, which normalizes the whole d_inner row, gathers across the ranks. In
training the B and C columns and channels, and the norm's scale, take a
gradient from the rank's heads only (`tensor_parallel.Layout.partial`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharded
from repro_torch.models.common import (
    ParamSpec,
    Params,
    SiteCfg,
    linear,
    linear_init,
    linear_specs,
    rmsnorm_init,
)


@dataclasses.dataclass(frozen=True)
class Mamba2Cfg:
    d_model: int
    d_inner: int           # expand * d_model
    n_heads: int           # d_inner // head_dim
    head_dim: int
    ssm_state: int         # N
    n_groups: int = 1      # B/C groups (the GQA analogue)
    conv_width: int = 4
    chunk: int = 256
    in_proj: SiteCfg = None   # d_model -> 2*d_inner + 2*G*N + H
    out_proj: SiteCfg = None  # d_inner -> d_model
    # the tensor-parallel degree its heads are split over: d_inner and
    # n_heads are a rank's share, the gated norm's scale whole
    # (`sharded.gated_rmsnorm`)
    tp: int = 1

    @property
    def d_xbc(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.ssm_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.ssm_state + self.n_heads


def mamba2_init(gen: torch.Generator, cfg: Mamba2Cfg, *, dtype=torch.float32,
                device="cpu") -> Params:
    """Params as the reference initializes them (its distributions; the
    draws are torch's): dt_bias the softplus inverse of dt ~ U[1e-3, 1e-1]
    on a log scale, A_log log U[1, 16], D ones."""
    def uniform(n):
        return torch.rand((n,), generator=gen, device=gen.device).to(device)

    dt = torch.exp(uniform(cfg.n_heads) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((cfg.conv_width, cfg.d_xbc), generator=gen, device=gen.device)
    return {
        "in_proj": linear_init(gen, cfg.in_proj, dtype=dtype, device=device),
        "out_proj": linear_init(gen, cfg.out_proj, dtype=dtype, device=device),
        "conv_w": (conv_w.to(device) * 0.1).to(dtype),
        "conv_b": torch.zeros((cfg.d_xbc,), dtype=dtype, device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(1.0 + 15.0 * uniform(cfg.n_heads)),
        "D": torch.ones((cfg.n_heads,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(cfg.d_inner * cfg.tp, dtype, device),
    }


def mamba2_specs(cfg: Mamba2Cfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `mamba2_init`'s params."""
    f32 = torch.float32
    return {
        "in_proj": linear_specs(cfg.in_proj, dtype),
        "out_proj": linear_specs(cfg.out_proj, dtype),
        "conv_w": ParamSpec((cfg.conv_width, cfg.d_xbc), dtype),
        "conv_b": ParamSpec((cfg.d_xbc,), dtype),
        "dt_bias": ParamSpec((cfg.n_heads,), f32),
        "A_log": ParamSpec((cfg.n_heads,), f32),
        "D": ParamSpec((cfg.n_heads,), f32),
        "norm": {"scale": ParamSpec((cfg.d_inner * cfg.tp,), dtype)},
    }


def mamba2_cache_specs(b: int, cfg: Mamba2Cfg, dtype=torch.bfloat16) -> Params:
    """The conv window in the cache dtype, the SSM state in fp32."""
    return {
        "conv": ParamSpec((b, cfg.conv_width - 1, cfg.d_xbc), dtype),
        "ssm": ParamSpec((b, cfg.n_heads, cfg.head_dim, cfg.ssm_state), torch.float32),
    }


def _gated_rmsnorm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    y32 = (y * F.silu(z)).float()
    var = (y32 * y32).mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv of width W over x (B, S, Ch), w (W, Ch), the
    W-1 inputs before x given by `prev` (B, W-1, Ch) (zeros when None, the
    reference's padding). Summed tap by tap in the reference's order."""
    width, s = w.shape[0], x.shape[1]
    if prev is None:
        prev = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    pad = torch.cat([prev.to(x.dtype), x], dim=1)
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i: i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da (..., Q) -> (..., Q, Q) lower-triangular decay exponents
    sum_{j<k<=i} da_k, -inf above the diagonal."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=da.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_: torch.Tensor,
                c_: torch.Tensor, *, chunk: int,
                h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, in fp32. x (B, S, H, P), dt (B, S, H) (softplus'd), A (H,)
    (negative), B_/C_ (B, S, H, N) (group-expanded), h0 (B, H, P, N) the
    initial state (zeros when None). The chunk length is the largest
    Q <= chunk that divides S, as in the reference (the fp32 sums follow it).
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32)."""
    b, s, h, p = x.shape
    n = b_.shape[-1]
    q = min(chunk, s)
    while s % q:
        q -= 1
    nc = s // q
    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = b_.reshape(b, nc, q, h, n).float()
    cc = c_.reshape(b, nc, q, h, n).float()
    da = dtc * a[None, None, None, :]

    seg = torch.cumsum(da, dim=2)                                 # (B, nc, Q, H)
    # inside a chunk: quadratic
    lmat = torch.exp(_segsum(da.transpose(2, 3)))                 # (B, nc, H, Q, Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc) * lmat
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", scores, dtc, xc)
    # each chunk's summary state: the decay from j to the chunk's end
    decay_out = torch.exp(seg[:, :, -1:, :] - seg)
    states = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn", decay_out, dtc, bc, xc)
    # across chunks: the linear recurrence
    chunk_decay = torch.exp(seg[:, :, -1, :])                     # (B, nc, H)
    hprev = xc.new_zeros((b, h, p, n)) if h0 is None else h0.float()
    hprevs = []
    for ci in range(nc):
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    decay_in = torch.exp(seg)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc, torch.stack(hprevs, dim=1), decay_in)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), hprev


def _split_xbc(cfg: Mamba2Cfg, xbc: torch.Tensor):
    """(xs, B, C) of the conv's output, B and C repeated over each group's heads."""
    di, g, n = cfg.d_inner, cfg.n_groups, cfg.ssm_state
    xs, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    rep = cfg.n_heads // g
    lead = xbc.shape[:-1]
    bmat = bmat.reshape(*lead, g, n).repeat_interleave(rep, dim=-2)
    cmat = cmat.reshape(*lead, g, n).repeat_interleave(rep, dim=-2)
    return xs.reshape(*lead, cfg.n_heads, cfg.head_dim), bmat, cmat


def write_rows(cache: Params, new: Params, rows: torch.Tensor | None) -> None:
    """In place: each cache tensor takes `new`'s values at `rows` (all when None)."""
    for name, t in cache.items():
        if rows is None:
            t.copy_(new[name].to(t.dtype))
        else:
            t[rows] = new[name][rows].to(t.dtype)


def mamba2(cfg: Mamba2Cfg, p: Params, x: torch.Tensor, *, cache: Params | None = None,
           cache_len: torch.Tensor | None = None, valid: torch.Tensor | None = None,
           rows: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). With a cache: cache_len (B,) the tokens each
    row has consumed, valid (B,) the row's valid positions of this forward
    (all S when None), rows the batch rows whose state this forward may
    change (all when None); see the module docstring."""
    b, s, _ = x.shape
    h, pd, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    # a tensor-parallel rank's in_proj is a column site: one copy in front
    zxbcdt = linear(cfg.in_proj, p["in_proj"], sharded.copy(x) if cfg.tp > 1 else x)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, cfg.d_xbc, h], dim=-1)
    v = dt_raw.float() + p["dt_bias"][None, None, :]
    dt = torch.logaddexp(v, torch.zeros_like(v))                  # jax.nn.softplus
    a = -torch.exp(p["A_log"].float())

    fresh = None
    if cache is not None:
        # rows starting a sequence begin from zeros, not from a previous request's state
        fresh = (cache_len == 0)
        prev_conv = cache["conv"].masked_fill(fresh[:, None, None], 0)
        prev_ssm = cache["ssm"].masked_fill(fresh[:, None, None, None], 0)

    if cache is None or s > 1:
        prev = None if cache is None else prev_conv
        xbc_conv = F.silu(_causal_conv(p["conv_w"], p["conv_b"], xbc, prev))
        xs, bmat, cmat = _split_xbc(cfg, xbc_conv)
        new_cache = None
        if cache is not None:
            n_valid = (torch.full((b,), s, dtype=torch.long, device=x.device)
                       if valid is None else valid.long())
            # padded positions: dt = 0 leaves the state where the last valid token left it
            at = torch.arange(s, device=x.device)[None, :, None]
            dt = dt.masked_fill(at >= n_valid[:, None, None], 0.0)
        y, hfinal = ssd_chunked(xs, dt, a, bmat, cmat, chunk=cfg.chunk,
                                h0=None if cache is None else prev_ssm)
        if cache is not None:
            # the conv tail: the last W-1 valid inputs (some from the window before)
            w1 = cfg.conv_width - 1
            seq = torch.cat([prev_conv.to(xbc.dtype), xbc], dim=1)
            idx = n_valid[:, None] + torch.arange(w1, device=x.device)[None, :]
            tail = torch.gather(seq, 1, idx[:, :, None].expand(-1, -1, seq.shape[-1]))
            new_cache = {"conv": tail, "ssm": hfinal}
    else:
        # O(1) decode: roll the conv window, update the SSM state
        conv_in = torch.cat([prev_conv, xbc.to(cache["conv"].dtype)], dim=1)
        xbc1 = F.silu(torch.einsum("bwc,wc->bc", conv_in.float(), p["conv_w"].float())
                      + p["conv_b"].float())[:, None, :].to(x.dtype)
        xs, bmat, cmat = _split_xbc(cfg, xbc1)
        xs, bmat, cmat = xs[:, 0], bmat[:, 0].float(), cmat[:, 0].float()
        dt1 = dt[:, 0, :]                                         # (B, H)
        decay = torch.exp(dt1 * a[None, :])
        hs = prev_ssm * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt1, xs.float(), bmat)
        y = torch.einsum("bhpn,bhn->bhp", hs, cmat)[:, None].to(x.dtype)
        y = y.reshape(b, 1, h, pd)
        xs = xs[:, None]
        new_cache = {"conv": conv_in[:, 1:], "ssm": hs}

    if new_cache is not None:
        write_rows(cache, new_cache, rows)
    y = y.float() + p["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = (sharded.gated_rmsnorm if cfg.tp > 1 else _gated_rmsnorm)(p["norm"]["scale"], y, z)
    return linear(cfg.out_proj, p["out_proj"], y)
