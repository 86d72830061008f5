"""Fused encode -> lookup LUT-AMM on Hopper: wrapper of csrc/fused_decode.cu.

Counterpart of `repro.kernels.fused_decode.fused_decode_pallas` (v3), the main
path's first choice: every LUT site whose C codebooks' fp32 centroids (plus
one 8-row N tile's codes) fit in a block's shared memory runs here. The
launch is a thread-block cluster whose ranks each hold a share of the
codebooks (`lut_amm.cluster_geometry`).

A CPU tensor runs the plain version (`ref.fused_decode_plain`); a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.lut_amm import (
    BLOCK_N,
    MAX_SMEM,
    RED_BYTES,
    _align16,
    check_args,
    cluster_lib,
    code_bytes,
    codebook_smem_bytes,
    launch_cluster_kernel,
)

launches = 0

_LIB = None


def smem_bytes(c: int, k: int, v: int) -> int:
    """Dynamic shared memory of the fused kernel's smallest launch, a cluster
    of one block holding all C codebooks' fp32 centroids and their norms
    (later the reduction buffer), plus one 8-row N tile's codes (uint8, or
    uint16 above K = 256)."""
    return (_align16(max(c * codebook_smem_bytes(k, v), RED_BYTES))
            + _align16(BLOCK_N * c * code_bytes(k)))


def fits(c: int, k: int, v: int) -> bool:
    """The fused kernel's precondition on this card (the Hopper form of
    `autotune.kernel_choice`'s fit rule: the whole codebook axis could be
    resident in one block; the launch then takes a cluster whose shares fit)."""
    return smem_bytes(c, k, v) <= MAX_SMEM


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = cluster_lib("fused_decode")
    return _LIB


def fused_decode(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
                 scale: torch.Tensor, *, bias: torch.Tensor | None = None,
                 act: str = "none", quads: int | None = None,
                 rows: int | None = None) -> torch.Tensor:
    """Fused encode -> lookup: (N, C*V) -> (N, M) in x.dtype. See csrc/fused_decode.cu.
    quads / rows: the M tile's column quads and the rows per N tile (None:
    the defaults of `lut_amm.cluster_geometry`)."""
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
    launch_cluster_kernel(_lib(), "fused_decode", x, centroids, table_q, scale, bias, out, dims,
                          act, chunked=False, rows=rows, quads=quads)
    launches += 1
    return out
