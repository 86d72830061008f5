"""LUT-AMM v2 and v1 on Hopper: wrappers of csrc/lut_amm_v2.cu and
csrc/lut_amm_v1.cu.

`lut_amm_v2` is the counterpart of `repro.kernels.lut_amm.lut_amm_pallas`
(v2), the fit rule's kernel when the fused kernel's resident codebooks do not
fit in one block's shared memory (the down projection of qwen3_1p7b: C = 192).
`lut_amm_v1` is the counterpart of `lut_amm_pallas_v1`, the generation that
dequantizes the table to fp32 and sums in fp32 in codebook order; the
autotuner times it and `ops.lut_amm` runs it where a record says version 1.
All three LUT-AMM kernels run one cluster pipeline (csrc/lut_common.cuh);
this module holds the argument checks and the launch geometry they share.

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
BLOCK_N = 8                  # rows per register tile of the direct lookup (kBlockN)
# the kernels' envelope (kMaxV, kMaxK): one codebook of K x V fp32 centroids
# must fit a block's shared memory with its sub-vectors, and codes are held
# on chip in one byte up to BYTE_K centroids, in two above
MAX_V = 64
MAX_K = 512
BYTE_K = 256
RED_BYTES = THREADS * BLOCK_N * 4 * 4
# column quads per M tile, widest first; Q quads x (THREADS / Q) codebook groups
QUADS = (64, 32, 16, 8, 4, 2)
# H100: dynamic shared memory one block may use (227 KB, after opting in)
MAX_SMEM = 232_448
# v2 and v1 stage a rank's share of the codebooks in chunks of at most this
# many bytes
V2_REGION = 140_544
# the fused and v2 kernels' cluster launch (csrc/lut_common.cuh, LutArgs):
CLUSTER_SIZES = (1, 2, 4, 8, 16)     # 16 is a non-portable size, allowed by the kernels
ROW_TILES = (8, 16, 32, 64)          # rows of x per N tile
STAGED_ROWS = 32                     # N tiles this large stage their table tile
STAGED_QUADS = (32, 16, 8, 4)        # M tiles a warp's lanes read as one table row
STAGED_ROWS_PER_THREAD = 8           # kStagedRows: most rows a thread holds in the row split
MAX_BOX_ROWS = 256                   # table rows of one TMA box (a larger ring stage: two)
TMA_ALIGN = 128                      # bytes a TMA box's shared-memory address is aligned to
MAX_STAGES = 8                       # table stages in the ring at most
RING_BYTES = 96 * 1024               # shared memory of the table ring at most
# order of the geometry ints the C entry points take (kGeoInts)
GEO_KEYS = ("cluster", "rows", "quads", "tiles_per_block", "chunk_c", "staged", "stage_c",
            "n_stages", "epi_off", "cent_off", "ring_off", "bar_off", "block_c", "vec4")

launches = 0
launches_v1 = 0

_LIB = None
_LIB_V1 = None
# x, centroids, table_q, scale, bias, out; N C K V M scale_c scale_m x_bf16 act;
# the geometry ints; smem; stream (csrc/fused_decode.cu, lut_amm_v2.cu, lut_amm_v1.cu)
CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
# x_bf16 scale_c wide S smem; out
CLUSTERS_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]


def codebook_smem_bytes(k: int, v: int) -> int:
    """The fit rule's measure of one codebook in shared memory: its K fp32
    centroid rows of V | 1 words, padded by 4 words, and its K norms padded
    by 1 (`fused_decode.fits`)."""
    return 4 * ((k * (v | 1) + 4) + (k + 1))


def code_bytes(k: int) -> int:
    """Bytes of one code held on chip: uint8 up to BYTE_K centroids, else uint16."""
    return 1 if k <= BYTE_K else 2


def row_stride16(v: int) -> int:
    """Words per staged centroid or sub-vector row in every kernel: 16-byte
    aligned rows (csrc/lut_common.cuh row_stride16)."""
    return ((v + 3) & ~3) + 4


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_quads(n_tiles: int, m: int, target: int, allowed: tuple[int, ...] = QUADS) -> int:
    """Column quads Q of an M tile (4Q columns wide): the tile whose
    (N tile, M tile) grid comes closest to `target` blocks from below, the
    widest among equals. Each block pays a fixed cost (staging and encoding
    its codebooks), so blocks beyond one per SM only repeat that work."""
    best_q, best = allowed[0], 0
    for q in allowed:
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
    check_envelope(k, v)
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


def check_envelope(k: int, v: int) -> None:
    """Raise ValueError for a codebook the kernels do not take, naming the limit."""
    if k > MAX_K or v > MAX_V:
        raise ValueError(f"K={k} (max {MAX_K}) or V={v} (max {MAX_V}) is outside the LUT "
                         f"kernels' envelope: one codebook of K x V fp32 centroids must fit a "
                         f"block's shared memory, and codes are held in at most 2 bytes")


def launch_args(x, centroids, table_q, scale, bias, out, dims, act) -> list:
    """The leading arguments both C entry points share, in order."""
    n, c, k, v, m, scale_c, scale_m = dims
    return [
        x.data_ptr(), centroids.data_ptr(), table_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, c, k, v, m, scale_c, scale_m, int(x.dtype == torch.bfloat16), ACT_CODES[act],
    ]


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with cudaError_t {err}")


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = cluster_lib("lut_amm_v2")
    return _LIB


def cluster_lib(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Load a cluster kernel's library (fused_decode, lut_amm_v2, lut_amm_v1; compiled
    with the macros `defines`) and declare its two entry points: the launch
    and the resident-cluster query."""
    lib = build.load(name, defines)
    launch = getattr(lib, f"lutnn_{name}")
    launch.argtypes = CLUSTER_ARGTYPES
    launch.restype = ctypes.c_int
    clusters = getattr(lib, f"lutnn_{name}_clusters")
    clusters.argtypes = CLUSTERS_ARGTYPES
    clusters.restype = ctypes.c_int
    return lib


def check_quads(quads: int | None) -> None:
    if quads is not None and quads not in QUADS:
        raise ValueError(f"quads={quads} not in {QUADS}")


def default_cluster(c: int) -> int:
    """Blocks per cluster of the fused, v2 and v1 launches: 16, or the largest
    size not above C, so that every rank owns at least one codebook. Fixed
    by measurement: timed over every size from 1 to 16, 16 was the fastest
    or within 0.5 us of it at every path shape (PERF.md)."""
    return max(s for s in CLUSTER_SIZES if s <= max(1, c))


def default_tile(n: int, m: int, wave: int, aligned: bool, rows: int | None = None,
                 quads: int | None = None) -> tuple[int, int]:
    """Rows per N tile and column quads per M tile by default. At decode (N
    up to 16) the N tile holds all rows; at a prefill chunk it is the
    smallest staged tile (32, then 64 rows) whose widest M tiles fit one
    wave of `wave` blocks. The M tile: `tile_quads` for that wave."""
    if rows is None:
        rows = next((r for r in ROW_TILES if r >= n), ROW_TILES[-1])
        if rows > 2 * BLOCK_N:
            widest = quads or STAGED_QUADS[0]
            rows = next((r for r in (STAGED_ROWS, 2 * STAGED_ROWS)
                         if cdiv(n, r) * cdiv(m, 4 * widest) <= wave), 2 * STAGED_ROWS)
    if rows not in ROW_TILES:
        raise ValueError(f"rows={rows} not in {ROW_TILES}")
    if quads is None:
        quads = tile_quads(cdiv(n, rows), m, wave,
                           STAGED_QUADS if aligned and rows >= STAGED_ROWS else QUADS)
    return rows, quads


def _align(b: int, a: int) -> int:
    return -(-b // a) * a


def ring_boxes(stage_rows: int, tw: int) -> int:
    """TMA boxes of one ring stage of `stage_rows` table rows x `tw` columns
    (csrc/lut_common.cuh box_rows): the fewest equal boxes of at most
    MAX_BOX_ROWS rows, or 0 where the rows do not split evenly or a box's
    bytes are no multiple of TMA_ALIGN (every box must start aligned). Such
    a tile is not staged by TMA: it gathers from global memory."""
    n = cdiv(stage_rows, MAX_BOX_ROWS)
    return n if stage_rows % n == 0 and (stage_rows // n) * tw % TMA_ALIGN == 0 else 0


def cluster_geometry(n: int, c: int, k: int, v: int, m: int, wave: int, *, chunked: bool,
                     rows: int | None = None, quads: int | None = None,
                     aligned: bool = True, block_c: int = 0) -> dict[str, int]:
    """One launch of the fused (chunked=False), v2 or v1 (chunked=True; v1
    with its chunk of the sum `block_c`, `v1_geometry`) kernel
    (csrc/lut_common.cuh, lut_cluster_body) with at most `wave` blocks, the
    blocks one wave of such clusters holds: the cluster size
    (`default_cluster`), the rows per N tile, the M tile (4 * quads columns)
    and the M tiles per block, the codebook chunk of a rank's share, whether
    the table tile is staged by TMA, the table ring, and the shared-memory
    layout. The table tile is staged only for 16-byte aligned table rows
    (`aligned`): by TMA at N tiles of STAGED_ROWS rows and more (and at 16
    rows where the whole tile fits the ring) where a ring stage splits into
    aligned TMA boxes (`ring_boxes`), and at decode (8-row tiles)
    by cp.async where the whole tile fits RING_BYTES. None picks the
    default; a launch that needs more shared memory than a block has
    raises ValueError."""
    check_quads(quads)
    if rows is not None and rows not in ROW_TILES:
        raise ValueError(f"rows={rows} not in {ROW_TILES}")
    s = default_cluster(c)
    rows_s, q = default_tile(n, m, wave, aligned, rows, quads)
    n_tiles = cdiv(max(n, 1), rows_s)
    rs = row_stride16(v)
    # a codebook's centroids (16-byte rows), its norms and the tile's sub-vectors
    per_cb = 4 * ((k * rs + 4) + (k + 1) + rows_s * rs)
    tw = 4 * q
    n_mtiles = cdiv(m, tw)
    share = cdiv(c, s)
    chunk_c = share
    if chunked:
        most = max(1, min(share, V2_REGION // per_cb))
        chunk_c = cdiv(share, cdiv(share, most))
    stage_c = max(1, min(c, MAX_BOX_ROWS // k))
    stage_c = cdiv(c, cdiv(c, stage_c))
    n_chunks = cdiv(c, stage_c)
    box = stage_c * k * tw

    tma = rows_s > BLOCK_N

    def layout(stg: bool) -> dict[str, int]:
        tiles_per_block = 1 if stg else cdiv(n_mtiles, max(1, wave // n_tiles))
        epi_off = _align16(rows_s * c * code_bytes(k))
        cent_off = epi_off + 8 * tiles_per_block * tw   # scale and bias per column
        cent = chunk_c * per_cb + 16             # + the sub-vectors' 16-byte alignment
        cent = cent if stg and tma else max(cent, RED_BYTES)
        ring_off = _align(cent_off + cent, 128)
        n_stages = 0
        ring = c * k * tw if stg else 0                 # decode: the whole tile
        if stg and tma:
            room = min(RING_BYTES, MAX_SMEM - ring_off - 8 * MAX_STAGES)
            n_stages = min(n_chunks, MAX_STAGES, max(2, room // box))
            ring = n_stages * box
        bar_off = _align16(ring_off + ring)
        return {"cluster": s, "rows": rows_s, "quads": q, "tiles_per_block": tiles_per_block,
                "chunk_c": chunk_c, "staged": int(stg), "stage_c": stage_c if stg and tma else 0,
                "n_stages": n_stages, "epi_off": epi_off, "cent_off": cent_off,
                "ring_off": ring_off, "bar_off": bar_off, "block_c": block_c,
                "smem": bar_off + 8 * (n_stages + 1),
                "n_tiles": n_tiles,
                "grid_x": cdiv(cdiv(n_mtiles, tiles_per_block), s) * s}

    # the row-split lookup holds at most STAGED_ROWS_PER_THREAD rows per thread,
    # and the ring's stages split into aligned TMA boxes
    ring_ok = q <= 32 and rows_s <= STAGED_ROWS_PER_THREAD * 8 * (32 // q) and \
        ring_boxes(stage_c * k, tw) > 0
    whole = c * k * tw <= RING_BYTES and (not tma or n_chunks <= MAX_STAGES)
    stg = (rows_s >= STAGED_ROWS or whole) and aligned and tw % 16 == 0 and \
        (not tma or ring_ok)
    geo = layout(stg)
    if stg and geo["smem"] > MAX_SMEM:
        # the tile (decode) or two ring stages (K = 512) do not fit beside the
        # centroids: the lookup gathers from global memory instead
        geo = layout(False)
    if geo["smem"] > MAX_SMEM:
        kernel = "v1" if block_c else "v2" if chunked else "fused"
        raise ValueError(f"{kernel} launch (C={c}, K={k}, V={v}, "
                         f"rows={rows_s}, quads={q}) needs {geo['smem']} B of shared memory; "
                         f"the card allows {MAX_SMEM}")
    return geo


def table_layout(table_q: torch.Tensor) -> tuple[bool, int]:
    """(aligned, vec4): whether TMA can read the table (16-byte aligned, rows
    a multiple of 16 bytes) and whether 4-byte loads can (4-aligned rows)."""
    m, ptr = table_q.shape[-1], table_q.data_ptr()
    return m % 16 == 0 and ptr % 16 == 0, int(m % 4 == 0 and ptr % 4 == 0)


@functools.lru_cache(maxsize=4096)
def cluster_plan(lib: ctypes.CDLL, name: str, dims: tuple[int, ...], x_bf16: int,
                 chunked: bool, rows: int | None, quads: int | None, aligned: bool,
                 vec4: int, block_c: int = 0) -> tuple[dict, ctypes.Array]:
    """One launch shape of the fused, v2 or v1 kernel, worked out once: the
    clusters this card holds at once with one block per SM (raises
    ValueError if none), which make one wave; the geometry for that wave
    (`cluster_geometry`); and the geometry as the C int array the entry
    points read."""
    n, c, k, v, m, scale_c, _ = dims
    s = default_cluster(c)
    resident = ctypes.c_int(0)
    # more than half an SM's shared memory a block: one block per SM
    err = getattr(lib, f"lutnn_{name}_clusters")(x_bf16, scale_c, int(k > BYTE_K), s,
                                                 MAX_SMEM // 2 + 1, ctypes.byref(resident))
    raise_on_error(err, f"{name} occupancy query")
    if resident.value < 1:
        raise ValueError(f"{name}: a cluster of {s} blocks cannot be resident on this card")
    geo = cluster_geometry(n, c, k, v, m, resident.value * s, chunked=chunked, rows=rows,
                           quads=quads, aligned=aligned, block_c=block_c)
    ints = (ctypes.c_int * len(GEO_KEYS))(*(geo[key] for key in GEO_KEYS[:-1]), vec4)
    return geo, ints


def launch_cluster_kernel(lib: ctypes.CDLL, name: str, x, centroids, table_q, scale, bias,
                          out, dims, act, *, chunked: bool, rows: int | None,
                          quads: int | None, block_c: int = 0) -> None:
    """Launch the fused, v2 or v1 kernel on the current stream with the
    launch `cluster_plan` works out; raises if it cannot run or the launch
    fails."""
    args = launch_args(x, centroids, table_q, scale, bias, out, dims, act)
    geo, ints = cluster_plan(lib, name, dims, args[13], chunked, rows, quads,
                             *table_layout(table_q), block_c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"lutnn_{name}")(*args, ints, geo["smem"], stream)
    raise_on_error(err, name)


def lut_amm_v2(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
               scale: torch.Tensor, *, bias: torch.Tensor | None = None,
               act: str = "none", quads: int | None = None,
               rows: int | None = None) -> torch.Tensor:
    """v2 LUT-AMM: (N, C*V) -> (N, M) in x.dtype. See csrc/lut_amm_v2.cu.
    quads / rows: the M tile's column quads and the rows per N tile (None:
    the defaults of `cluster_geometry`)."""
    global launches
    if x.device.type == "cpu":
        return ref.lut_amm_v2_plain(x, centroids, table_q, scale, bias=bias, act=act)
    dims = check_args(x, centroids, table_q, scale, bias, act)
    out = torch.empty((dims[0], dims[4]), dtype=x.dtype, device=x.device)
    if dims[0] == 0:
        return out
    launch_cluster_kernel(_lib(), "lut_amm_v2", x, centroids, table_q, scale, bias, out, dims,
                          act, chunked=True, rows=rows, quads=quads)
    launches += 1
    return out


def _lib_v1():
    global _LIB_V1
    if _LIB_V1 is None:
        _LIB_V1 = cluster_lib("lut_amm_v1")
    return _LIB_V1


def v1_geometry(n: int, c: int, k: int, v: int, m: int, wave: int, *,
                block_c: int | None = None, rows: int | None = None,
                quads: int | None = None, aligned: bool = True) -> dict[str, int]:
    """One v1 launch: v2's cluster launch (`cluster_geometry`, chunked), with
    v1's chunk of the sum, the reference's `bc` unless given, reduced to a
    divisor of C (`ref.v1_block_c`). The chunk sets the order of the sums and
    nothing else: any launch gives the same bytes. Raises ValueError for a
    launch that needs more shared memory than a block has."""
    return cluster_geometry(n, c, k, v, m, wave, chunked=True, rows=rows, quads=quads,
                            aligned=aligned, block_c=ref.v1_block_c(c, v, block_c))


def lut_amm_v1(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
               scale: torch.Tensor, *, block_c: int | None = None,
               quads: int | None = None, rows: int | None = None) -> torch.Tensor:
    """v1 LUT-AMM: (N, C*V) -> (N, M) in x.dtype, fp32 sums of t * s in
    chunks of block_c codebooks (None: the reference's default chunk). No
    bias or activation. quads / rows: the M tile's column quads and the rows
    per N tile (None: the defaults of `cluster_geometry`). See
    csrc/lut_amm_v1.cu."""
    global launches_v1
    if x.device.type == "cpu":
        return ref.lut_amm_v1_plain(x, centroids, table_q, scale, block_c=block_c)
    dims = check_args(x, centroids, table_q, scale, None, "none")
    n, c, k, v, m = dims[:5]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    launch_cluster_kernel(_lib_v1(), "lut_amm_v1", x, centroids, table_q, scale, None, out,
                          dims, "none", chunked=True, rows=rows, quads=quads,
                          block_c=ref.v1_block_c(c, v, block_c))
    launches_v1 += 1
    return out
