"""Closest-centroid encode on Hopper: wrapper of csrc/encode.cu.

Counterpart of `repro.kernels.dist_argmin.encode_pallas`: int32 codes (N, C)
of x (N, C*V) against centroids (C, K, V), by the device encode the LUT-AMM
kernels share (csrc/lut_common.cuh). Reached through `ops.encode`; the
autotuner's "encode" kind times it (block_n = rows per block, block_c =
codebooks per block; see kernels/autotune.py).

A CPU tensor runs the plain version (`ref.encode_plain`); a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import require_sm90
from repro_torch.kernels import build, ref
from repro_torch.kernels.lut_amm import (
    MAX_K,
    MAX_SMEM,
    MAX_V,
    _align16,
    cdiv,
    codebook_smem_bytes,
    max_chunk,
    raise_on_error,
    sm_count,
)

ENC_ROWS = 32                # rows per encode pass, mirrored from csrc/encode.cu

launches = 0

_LIB = None
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("encode")
        lib.lutnn_encode.argtypes = _ARGTYPES
        lib.lutnn_encode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def encode_geometry(n: int, c: int, k: int, v: int, n_sms: int, *,
                    block_n: int | None = None,
                    block_c: int | None = None) -> dict[str, int]:
    """Codebook chunk, rows per block and shared memory of one launch: the
    given ones (an autotune record's), else the largest chunk that fits and
    enough row ranges for about one block per SM."""
    chunk_c = min(block_c or max_chunk(c, k, v), c)
    region = _align16(chunk_c * codebook_smem_bytes(k, v))
    smem = region + _align16(ENC_ROWS * chunk_c)
    if smem > MAX_SMEM:
        raise ValueError(f"encode chunk of {chunk_c} codebooks needs {smem} B of shared "
                         f"memory; the card allows {MAX_SMEM}")
    if block_n:
        rows = block_n
    else:
        ranges = max(1, min(cdiv(n, ENC_ROWS), n_sms // cdiv(c, chunk_c)))
        rows = cdiv(n, ranges)
    return {"chunk_c": chunk_c, "rows": rows, "region": region, "smem": smem}


def encode(x: torch.Tensor, centroids: torch.Tensor, *, block_n: int | None = None,
           block_c: int | None = None) -> torch.Tensor:
    """(N, C*V), (C, K, V) fp32 -> int32 (N, C). See csrc/encode.cu."""
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
    if k > MAX_K or v > MAX_V:
        raise ValueError(f"K={k} (max {MAX_K}) or V={v} (max {MAX_V}) not supported by the "
                         f"encode kernel")
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
            int(x.dtype == torch.bfloat16), geo["chunk_c"], geo["rows"], geo["region"],
            geo["smem"], stream,
        )
    raise_on_error(err, "encode")
    launches += 1
    return out
