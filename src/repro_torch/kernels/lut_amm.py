"""LUT-AMM v2 and v1 on Hopper: wrappers of csrc/lut_amm_v2.cu and
csrc/lut_amm_v1.cu.

`lut_amm_v2` is the counterpart of `repro.kernels.lut_amm.lut_amm_pallas`
(v2), the fit rule's kernel when the fused kernel's resident codebooks do not
fit in one block's shared memory (the down projection of qwen3_1p7b: C = 192).
`lut_amm_v1` is the counterpart of `lut_amm_pallas_v1`, the generation that
dequantizes the table to fp32 and sums in fp32; the autotuner times it and
`ops.lut_amm` runs it where a record says version 1. This module also holds
the argument checks and launch geometry the CUDA wrappers share.

A CPU tensor runs the plain version (`ref.lut_amm_v2_plain`,
`ref.lut_amm_v1_plain`); a CUDA tensor launches the kernel or raises.
`launches` and `launches_v1` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import require_sm90
from repro_torch.kernels import build, ref

ACTIVATIONS = ref.ACTIVATIONS
ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}   # lut_common.cuh Act

# launch geometry, mirrored from csrc/lut_common.cuh
THREADS = 256
BLOCK_N = 8                  # rows of x per N tile
MAX_V = 32                   # sub-vector length the encoder holds in registers
MAX_K = 256                  # codes are stored as uint8
RED_BYTES = THREADS * BLOCK_N * 4 * 4
# column quads per M tile, widest first; Q quads x (THREADS / Q) codebook groups
QUADS = (64, 32, 16, 8, 4, 2)
# H100: dynamic shared memory one block may use (227 KB, after opting in)
MAX_SMEM = 232_448
# v2 stages centroids in chunks of at most this many bytes: 64 codebooks of
# K=16, V=32, so that a decode step's 4 rows x 64 codebooks fill the block's
# 256 threads in each chunk's encode; one block per SM, as the grid aims for
V2_REGION = 139_264

launches = 0
launches_v1 = 0

_LIB = None
_LIB_V1 = None
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_ARGTYPES_V1 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def codebook_smem_bytes(k: int, v: int) -> int:
    """Shared memory of one staged codebook: its K*V centroids padded by 4
    floats and its K norms padded by 1 (csrc/lut_common.cuh centroid_stride)."""
    return 4 * ((k * v + 4) + (k + 1))


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_quads(n_tiles: int, m: int, target: int) -> int:
    """Column quads Q of a v2 M tile (4Q columns wide): the tile whose
    (N tile, M tile) grid comes closest to `target` blocks from below, the
    widest among equals. Every v2 block encodes its rows over all C
    codebooks, so blocks beyond one per SM only repeat that work."""
    best_q, best = QUADS[0], 0
    for q in QUADS:
        blocks = n_tiles * cdiv(m, 4 * q)
        if best < blocks <= target:
            best_q, best = q, blocks
    return best_q


def check_args(x, centroids, table_q, scale, bias, act) -> tuple[int, ...]:
    """Validate what the CUDA kernels take; returns (n, c, k, v, m, scale_c, scale_m)."""
    if act not in ACT_CODES:
        raise ValueError(f"act={act!r} not in {ACTIVATIONS}")
    require_sm90(x)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32 or bfloat16, got {x.dtype} {tuple(x.shape)}")
    if centroids.dtype != torch.float32 or centroids.dim() != 3:
        raise TypeError("centroids must be (C, K, V) float32")
    if table_q.dtype != torch.int8 or table_q.dim() != 3:
        raise TypeError("table_q must be (C, K, M) int8")
    n, d = x.shape
    c, k, v = centroids.shape
    m = table_q.shape[-1]
    if d != c * v:
        raise ValueError(f"D={d} != C*V={c}*{v}")
    if tuple(table_q.shape[:2]) != (c, k):
        raise ValueError(f"table_q {tuple(table_q.shape)} does not match centroids (C={c}, K={k})")
    if k > MAX_K or v > MAX_V:
        raise ValueError(f"K={k} (max {MAX_K}) or V={v} (max {MAX_V}) not supported by the kernels")
    if (scale.dtype != torch.float32 or scale.dim() != 3 or scale.shape[1] != 1
            or scale.shape[0] not in (1, c) or scale.shape[2] not in (1, m)):
        raise ValueError(f"scale must be float32 (1|C, 1, 1|M), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    tensors = [x, centroids, table_q, scale]
    if bias is not None:
        if bias.dtype != torch.float32 or tuple(bias.shape) != (m,):
            raise ValueError(f"bias must be float32 ({m},), got {bias.dtype} {tuple(bias.shape)}")
        tensors.append(bias)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, found one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    return n, c, k, v, m, scale.shape[0], scale.shape[2]


def launch_args(x, centroids, table_q, scale, bias, out, dims, act) -> list:
    """The leading arguments both C entry points share, in order."""
    n, c, k, v, m, scale_c, scale_m = dims
    return [
        x.data_ptr(), centroids.data_ptr(), table_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, c, k, v, m, scale_c, scale_m, int(x.dtype == torch.bfloat16), ACT_CODES[act],
    ]


def vec4_ok(table_q: torch.Tensor) -> int:
    """4-byte table loads need 4-aligned rows."""
    return int(table_q.shape[-1] % 4 == 0 and table_q.data_ptr() % 4 == 0)


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with cudaError_t {err}")


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("lut_amm_v2")
        lib.lutnn_lut_amm_v2.argtypes = _ARGTYPES
        lib.lutnn_lut_amm_v2.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def max_chunk(c: int, k: int, v: int) -> int:
    """The largest chunk of codebooks staged at once (V2_REGION), spread so
    that the chunks split C evenly: each chunk's encode keeps as many threads
    busy as the region allows."""
    most = max(1, min(c, V2_REGION // codebook_smem_bytes(k, v)))
    return cdiv(c, cdiv(c, most))


def check_quads(quads: int | None) -> None:
    if quads is not None and quads not in QUADS:
        raise ValueError(f"quads={quads} not in {QUADS}")


def v2_geometry(n: int, c: int, k: int, v: int, m: int, n_sms: int, *,
                quads: int | None = None, chunk_c: int | None = None) -> dict[str, int]:
    """Tile width, codebook chunk and shared memory of one v2 launch: the
    given ones (an autotune record's), else `tile_quads` and `max_chunk`."""
    check_quads(quads)
    chunk_c = min(chunk_c or max_chunk(c, k, v), c)
    region = _align16(max(chunk_c * codebook_smem_bytes(k, v), RED_BYTES))
    smem = region + _align16(BLOCK_N * chunk_c)
    if smem > MAX_SMEM:
        raise ValueError(f"v2 chunk of {chunk_c} codebooks needs {smem} B of shared memory; "
                         f"the card allows {MAX_SMEM}")
    return {
        "quads": quads or tile_quads(cdiv(n, BLOCK_N), m, n_sms),
        "chunk_c": chunk_c,
        "region": region,
        "smem": smem,
    }


def lut_amm_v2(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
               scale: torch.Tensor, *, bias: torch.Tensor | None = None,
               act: str = "none", quads: int | None = None,
               chunk_c: int | None = None) -> torch.Tensor:
    """v2 LUT-AMM: (N, C*V) -> (N, M) in x.dtype. See csrc/lut_amm_v2.cu.
    quads / chunk_c: the M tile's column quads and the codebook chunk
    (None: the defaults of `v2_geometry`)."""
    global launches
    if x.device.type == "cpu":
        return ref.lut_amm_v2_plain(x, centroids, table_q, scale, bias=bias, act=act)
    dims = check_args(x, centroids, table_q, scale, bias, act)
    n, c, k, v, m = dims[:5]
    geo = v2_geometry(n, c, k, v, m, sm_count(x.device.index), quads=quads, chunk_c=chunk_c)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().lutnn_lut_amm_v2(
            *launch_args(x, centroids, table_q, scale, bias, out, dims, act),
            geo["quads"], geo["chunk_c"], geo["region"], geo["smem"], vec4_ok(table_q), stream,
        )
    raise_on_error(err, "lut_amm_v2")
    launches += 1
    return out


def _lib_v1():
    global _LIB_V1
    if _LIB_V1 is None:
        lib = build.load("lut_amm_v1")
        lib.lutnn_lut_amm_v1.argtypes = _ARGTYPES_V1
        lib.lutnn_lut_amm_v1.restype = ctypes.c_int
        _LIB_V1 = lib
    return _LIB_V1


def v1_geometry(n: int, c: int, k: int, v: int, m: int, n_sms: int, *,
                quads: int | None = None) -> dict[str, int]:
    """Tile width, staging chunk and shared memory of one v1 launch. The
    staging chunk only bounds shared memory; the chunk of the sum is block_c."""
    check_quads(quads)
    stage_c = max_chunk(c, k, v)
    region = _align16(stage_c * codebook_smem_bytes(k, v))
    return {
        "quads": quads or tile_quads(cdiv(n, BLOCK_N), m, n_sms),
        "stage_c": stage_c,
        "region": region,
        "smem": region + _align16(BLOCK_N * stage_c),
    }


def lut_amm_v1(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
               scale: torch.Tensor, *, block_c: int | None = None,
               quads: int | None = None) -> torch.Tensor:
    """v1 LUT-AMM: (N, C*V) -> (N, M) in x.dtype, fp32 sums of t * s in
    chunks of block_c codebooks (None: the reference's default chunk). No
    bias or activation. See csrc/lut_amm_v1.cu."""
    global launches_v1
    if x.device.type == "cpu":
        return ref.lut_amm_v1_plain(x, centroids, table_q, scale, block_c=block_c)
    dims = check_args(x, centroids, table_q, scale, None, "none")
    n, c, k, v, m, scale_c, scale_m = dims
    bc = ref.v1_block_c(c, v, block_c)
    geo = v1_geometry(n, c, k, v, m, sm_count(x.device.index), quads=quads)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib_v1().lutnn_lut_amm_v1(
            x.data_ptr(), centroids.data_ptr(), table_q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), n, c, k, v, m, scale_c, scale_m, int(x.dtype == torch.bfloat16),
            geo["quads"], bc, geo["stage_c"], geo["region"], geo["smem"], vec4_ok(table_q),
            stream,
        )
    raise_on_error(err, "lut_amm_v1")
    launches_v1 += 1
    return out
