"""Closest-centroid encode on Hopper: wrapper of csrc/encode.cu.

Counterpart of `repro.kernels.dist_argmin.encode_pallas`: int32 codes (N, C)
of x (N, C*V) against centroids (C, K, V), by the device encode the LUT-AMM
kernels share (csrc/lut_common.cuh, encode_tile). Reached through
`ops.encode`; the autotuner's "encode" kind times it (block_n = rows per
block, block_c = codebooks per block; see kernels/autotune.py).

A CPU tensor runs the plain version (`ref.encode_plain`); a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import require_sm90
from repro_torch.kernels import build, ref
from repro_torch.kernels.lut_amm import (
    MAX_SMEM,
    cdiv,
    check_envelope,
    code_bytes,
    raise_on_error,
    row_stride16,
    sm_count,
)

MAX_ROWS = 32                # the default's largest N tile (rows per block)

launches = 0

_LIB = None
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("encode")
        lib.lutnn_encode.argtypes = _ARGTYPES
        lib.lutnn_encode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def smem_bytes(rows: int, chunk_c: int, k: int, v: int) -> int:
    """Shared memory of one block (csrc/encode.cu): the chunk's centroids in
    16-byte rows, their norms, the tile's sub-vectors and the codes (1 byte
    each, 2 above K = 256)."""
    rs = row_stride16(v)
    return 4 * (chunk_c * (k * rs + 4) + ((chunk_c * (k + 1) + 3) & ~3)
                + chunk_c * rows * rs) + chunk_c * rows * code_bytes(k)


def encode_geometry(n: int, c: int, k: int, v: int, n_sms: int, *,
                    block_n: int | None = None,
                    block_c: int | None = None) -> dict[str, int]:
    """One launch: a grid of independent blocks, each encoding `rows` rows
    (block_n) over `chunk_c` codebooks (block_c). The default, for at least
    one block per SM where the shape allows it: rows, the largest power of
    two up to MAX_ROWS (and up to N's) whose N tiles times C codebooks reach
    `n_sms`; then the largest chunk that still gives `n_sms` blocks, spread so
    that the chunks split C evenly. Raises ValueError for a launch that needs
    more shared memory than a block has."""
    if block_n is not None and block_n < 0 or block_c is not None and block_c < 0:
        raise ValueError(f"block_n={block_n} and block_c={block_c} must not be negative")
    rows = block_n
    if not rows:
        cap = min(MAX_ROWS, 1 << max(n - 1, 0).bit_length())
        rows = 1
        while 2 * rows <= cap and cdiv(n, 2 * rows) * c >= n_sms:
            rows *= 2
    n_tiles = cdiv(max(n, 1), rows)
    chunk_c = min(block_c or c, c)
    if not block_c:
        while chunk_c > 1 and (n_tiles * cdiv(c, chunk_c) < n_sms
                               or smem_bytes(rows, chunk_c, k, v) > MAX_SMEM):
            chunk_c -= 1
        chunk_c = cdiv(c, cdiv(c, chunk_c))
    smem = smem_bytes(rows, chunk_c, k, v)
    if smem > MAX_SMEM:
        raise ValueError(f"encode block of {rows} rows x {chunk_c} codebooks (K={k}, V={v}) "
                         f"needs {smem} B of shared memory; the card allows {MAX_SMEM}")
    n_chunks = cdiv(c, chunk_c)
    return {"rows": rows, "chunk_c": chunk_c, "n_tiles": n_tiles, "n_chunks": n_chunks,
            "blocks": n_tiles * n_chunks, "smem": smem}


def encode(x: torch.Tensor, centroids: torch.Tensor, *, block_n: int | None = None,
           block_c: int | None = None) -> torch.Tensor:
    """(N, C*V), (C, K, V) fp32 -> int32 (N, C). See csrc/encode.cu.
    block_n / block_c: rows and codebooks per block (None or 0: the
    defaults of `encode_geometry`)."""
    global launches
    if x.device.type == "cpu":
        return ref.encode_plain(x, centroids)
    require_sm90(x)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got {x.dtype} {tuple(x.shape)}")
    if centroids.dtype != torch.float32 or centroids.dim() != 3:
        raise TypeError("centroids must be (C, K, V) float32")
    n, d = x.shape
    c, k, v = centroids.shape
    if d != c * v:
        raise ValueError(f"D={d} != C*V={c}*{v}")
    check_envelope(k, v)
    if centroids.device != x.device:
        raise ValueError(f"all operands must be on {x.device}, found one on {centroids.device}")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("operands must be contiguous")
    geo = encode_geometry(n, c, k, v, sm_count(x.device.index), block_n=block_n,
                          block_c=block_c)
    out = torch.empty((n, c), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().lutnn_encode(
            x.data_ptr(), centroids.data_ptr(), out.data_ptr(), n, c, k, v,
            int(x.dtype == torch.bfloat16), geo["chunk_c"], geo["rows"], geo["smem"], stream,
        )
    raise_on_error(err, "encode")
    launches += 1
    return out
