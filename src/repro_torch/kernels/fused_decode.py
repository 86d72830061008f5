"""Fused encode -> lookup LUT-AMM on Hopper: wrapper of csrc/fused_decode.cu.

Counterpart of `repro.kernels.fused_decode.fused_decode_pallas` (v3), the main
path's first choice: every LUT site whose C codebooks' fp32 centroids (plus
one N tile's codes) fit in a block's shared memory runs here.

A CPU tensor runs the plain version (`ref.fused_decode_plain`); a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.lut_amm import (
    BLOCK_N,
    MAX_SMEM,
    QUADS,
    RED_BYTES,
    _align16,
    cdiv,
    check_args,
    check_quads,
    codebook_smem_bytes,
    launch_args,
    raise_on_error,
    sm_count,
    vec4_ok,
)

launches = 0

_LIB = None
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p]


def smem_bytes(c: int, k: int, v: int) -> int:
    """Dynamic shared memory of one fused block: all C codebooks' fp32
    centroids and their norms (later reused as the reduction buffer), then
    one N tile's uint8 codes."""
    return _align16(max(c * codebook_smem_bytes(k, v), RED_BYTES)) + _align16(BLOCK_N * c)


def fits(c: int, k: int, v: int) -> bool:
    """The fused kernel's precondition on this card (the Hopper form of
    `autotune.kernel_choice`'s fit rule: the whole codebook axis resident)."""
    return smem_bytes(c, k, v) <= MAX_SMEM


def fused_geometry(n: int, c: int, k: int, v: int, m: int, n_sms: int, *,
                   quads: int | None = None) -> dict[str, int]:
    """Tile width, M ranges and shared memory of one fused launch. Each block
    owns one N tile and a contiguous range of M tiles. Every block stages
    all C codebooks (at C = 64, V = 32 its 137 KB of shared memory leave
    room for one block per SM), so the grid aims at one wave: about n_sms
    blocks, never more unless the N tiles alone exceed it. Among tile
    widths, the one giving most ranges (then the widest) wins, unless
    `quads` (an autotune record's) fixes the width."""
    check_quads(quads)
    n_tiles = cdiv(n, BLOCK_N)
    ranges = max(1, n_sms // n_tiles)
    best = None
    for quads in (quads,) if quads else QUADS:
        n_mtiles = cdiv(m, 4 * quads)
        per_range = cdiv(n_mtiles, ranges)
        m_ranges = cdiv(n_mtiles, per_range)
        if best is None or m_ranges > best[2]:
            best = (quads, per_range, m_ranges)
    quads, per_range, m_ranges = best
    smem = smem_bytes(c, k, v)
    return {
        "quads": quads,
        "m_ranges": m_ranges,
        "tiles_per_range": per_range,
        "region": smem - _align16(BLOCK_N * c),
        "smem": smem,
    }


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("fused_decode")
        lib.lutnn_fused_decode.argtypes = _ARGTYPES
        lib.lutnn_fused_decode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fused_decode(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
                 scale: torch.Tensor, *, bias: torch.Tensor | None = None,
                 act: str = "none", quads: int | None = None) -> torch.Tensor:
    """Fused encode -> lookup: (N, C*V) -> (N, M) in x.dtype. See csrc/fused_decode.cu.
    quads: the M tile's column quads (None: `fused_geometry`'s choice)."""
    global launches
    if x.device.type == "cpu":
        return ref.fused_decode_plain(x, centroids, table_q, scale, bias=bias, act=act)
    dims = check_args(x, centroids, table_q, scale, bias, act)
    n, c, k, v, m = dims[:5]
    if not fits(c, k, v):
        raise ValueError(f"fused kernel needs {smem_bytes(c, k, v)} B of shared memory for "
                         f"C={c}, K={k}, V={v}; the card allows {MAX_SMEM} (use v2)")
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    geo = fused_geometry(n, c, k, v, m, sm_count(x.device.index), quads=quads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().lutnn_fused_decode(
            *launch_args(x, centroids, table_q, scale, bias, out, dims, act),
            geo["quads"], geo["m_ranges"], geo["tiles_per_range"], geo["region"],
            geo["smem"], vec4_ok(table_q), stream,
        )
    raise_on_error(err, "fused_decode")
    launches += 1
    return out
