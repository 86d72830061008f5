"""Shape-keyed kernel-version and launch-parameter autotuner for the LUT kernels.

Counterpart of `repro.kernels.autotune`: the same record format, cache file
format, key format and precedence, with the TPU's tiling model replaced by the
CUDA wrappers' own launch parameters and the H100's numbers.

A `BlockConfig` names one launch of one kernel; 0 in a field means "the
wrapper's own default". Per kernel:

  version 2 (`lut_amm.lut_amm_v2`, csrc/lut_amm_v2.cu),
  version 3 (`fused_decode.fused_decode`, csrc/fused_decode.cu) and
  version 1 (`lut_amm.lut_amm_v1`, csrc/lut_amm_v1.cu), all three
  thread-block cluster launches (`lut_amm.cluster_geometry`):
      block_n  rows per N tile, the tile one cluster encodes and shares
               (8-64; N tiles of 32 rows and more stage their table tiles)
      block_m  columns per M tile, 4 x the tile's column quads
      block_c  fused and v2: 0 (the cluster size is fixed by C,
               `lut_amm.default_cluster`, and v2's codebook chunk by shared
               memory); v1: codebooks summed per chunk before the chunk
               joins the output (the reference's bc; it sets the fp32 order
               of the sums, and only it)
  kind "encode" (`dist_argmin.encode`, csrc/encode.cu)
      block_n  rows per block;  block_m  0;  block_c  codebooks per block

A fused or v2 record with block_c != 0 was written for the one-block kernels
that came before the cluster launch (block_c was C, or v2's chunk); its
fields describe a launch that no longer exists, so it takes the wrapper's
default launch (`cluster_launch`), keeping its version. A v1 record of the
one-block v1 kernel (block_n = 8) names a launch the cluster kernel offers
(`v1_launch`); an encode record whose block does not fit shared memory any
more takes the default launch (`encode_launch`).

Keys are `kind|n=|m=|c=|k=|v=|dtype=|backend=` as in the reference, with
backend `cuda-sm90` for tensors on the card and `torch-cpu` for CPU tensors.
The reference's records carry backend `tpu` or `cpu` and are never read
for the card, so one cache file can hold both packages' records.

`kernel_choice` is the hot-path consumer: a record (measured, restored from
an artifact, or analytic) always wins; with no record the port's fit rule
(`fit_version`) applies: the fused kernel when its codebooks fit in a block's
shared memory, else v2. `tune` sweeps versions 3, 2, 1 and their candidates,
timed by a `measure(cfg, version) -> seconds` callable (`kernels.measure`,
CUDA events on the card). Without one, `predict_us`, a roofline model with
the H100's numbers, ranks only the versions, each at its wrapper's default
launch: the model is set by device-memory bytes at these shapes, which do not
depend on the tile, so it cannot tell launches apart, and an analytic record
keeps block_m = block_c = 0. Records carry `measured` so a timed winner is
never replaced by a projection. Cache path: $REPRO_AUTOTUNE_CACHE, else
~/.cache/repro_torch/autotune.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import tempfile
from typing import Any, Callable

import torch

from repro_torch.kernels import dist_argmin as enc_mod
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as lut_mod
from repro_torch.kernels import ref
from repro_torch.roofline.analysis import FP32_FLOPS, HBM_BW, INT8_OPS

# H100 SXM (NVIDIA's data sheet, `roofline.analysis`): device memory rate,
# fp32 outside the tensor cores, int8 tensor-core rate; L2 rate (rough) for
# staging centroids
L2_BYTES_S = 10e12
LAUNCH_S = 4e-6              # fixed cost of one kernel launch on the device
CLUSTER_SYNC_S = 1e-6        # a cluster's two barriers and its code exchange (rough)
ORDERED_ADD_S = 4e-9         # v1: one element's dequantize, multiply and add per codebook
                             # in a thread's ordered chain (rough)
N_SMS = 132

# the versions `tune` sweeps, in the order that wins a tie: the fit rule's
# preference (fused, then v2), then v1
KERNEL_VERSIONS = (3, 2, 1)
VERSION_FUSED = 3
BACKEND_CUDA = "cuda-sm90"

_CACHE_VERSION = 1
_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One launch choice of one LUT kernel (fields per kernel: module docstring)."""

    block_n: int
    block_m: int
    block_c: int

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)

    @property
    def quads(self) -> int | None:
        return self.block_m // 4 or None


DEFAULT = BlockConfig(0, 0, 0)


def backend_for(device: str | torch.device) -> str:
    """The key's backend for kernels run on `device`."""
    device = torch.device(device)
    return BACKEND_CUDA if device.type == "cuda" else f"torch-{device.type}"


def backend_of(t: torch.Tensor) -> str:
    """The key's backend for kernels given tensor `t`."""
    return backend_for(t.device)


def dtype_name(dtype: torch.dtype) -> str:
    """"float32" / "bfloat16": the reference's `str(x.dtype)`."""
    return str(dtype).removeprefix("torch.")


def shape_key(kind: str, n: int, m: int, c: int, k: int, v: int, dtype: str,
              backend: str) -> str:
    return f"{kind}|n={n}|m={m}|c={c}|k={k}|v={v}|dtype={dtype}|backend={backend}"


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(_ENV_CACHE)
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "autotune.json"


def _read_entries(path: pathlib.Path) -> dict[str, dict[str, Any]]:
    """Entries of a cache file; an unreadable or foreign file counts as empty."""
    try:
        raw = json.loads(path.read_text())
        ok = isinstance(raw, dict) and raw.get("version") == _CACHE_VERSION
        return dict(raw["entries"]) if ok else {}
    except (OSError, ValueError, KeyError, TypeError):
        return {}


class AutotuneCache:
    """JSON-backed winner store; writes are atomic (tmp file, os.replace)."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path is not None else default_cache_path()
        self._entries: dict[str, dict[str, Any]] | None = None

    def load(self) -> dict[str, dict[str, Any]]:
        if self._entries is None:
            self._entries = _read_entries(self.path)
        return self._entries

    def get(self, key: str) -> dict[str, Any] | None:
        return self.load().get(key)

    def put(self, key: str, record: dict[str, Any]) -> None:
        self.load()[key] = record

    def save(self) -> None:
        """Write this cache's entries over the file's current ones, so that
        records another process (or the reference package) wrote meanwhile
        under other keys survive."""
        payload = {"version": _CACHE_VERSION,
                   "entries": {**_read_entries(self.path), **self.load()}}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise


_DEFAULT_CACHE: AutotuneCache | None = None


def get_cache() -> AutotuneCache:
    """The process cache at `default_cache_path()` (re-opened when the
    environment variable points elsewhere)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != default_cache_path():
        _DEFAULT_CACHE = AutotuneCache()
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# candidates and the analytic model
# ---------------------------------------------------------------------------

def candidates(kind: str, n: int, m: int, c: int, k: int, v: int,
               version: int = 2) -> list[BlockConfig]:
    """Every launch the tuner tries for one kernel and shape. Fused, v2 and
    v1: the rows per N tile (8 at decode; 32 and 64 rows, the staged table,
    at a prefill chunk) and the column quads of the M tile; v1 also its
    chunk of the sum (the reference's, and all of C). The encode: its rows
    per block (the default's, 8 and 32, at most N's power of two) and its
    codebooks per block (the default's, 4 and 16). Empty for the fused
    kernel when its codebooks do not fit."""
    bn = lut_mod.BLOCK_N
    if kind == "encode":
        geo = enc_mod.encode_geometry(n, c, k, v, N_SMS)
        cap = 1 << max(n - 1, 0).bit_length()
        rows = sorted({geo["rows"], min(bn, cap), min(enc_mod.MAX_ROWS, cap)})
        chunks = sorted({geo["chunk_c"], min(c, 4), min(c, 16)})
        return [BlockConfig(r, 0, cc) for r in rows for cc in chunks]
    if version >= VERSION_FUSED and not fused_mod.fits(c, k, v):
        return []
    small = next((r for r in lut_mod.ROW_TILES if r >= n), lut_mod.ROW_TILES[-1])
    row_tiles = [small] if small <= 2 * bn else [lut_mod.STAGED_ROWS, 2 * lut_mod.STAGED_ROWS]
    sums = sorted({ref.v1_block_c(c, v), c}) if version == 1 else [0]
    return [BlockConfig(rows, 4 * q, bc) for bc in sums for rows in row_tiles
            for q in (lut_mod.STAGED_QUADS if rows >= lut_mod.STAGED_ROWS else lut_mod.QUADS)]


def cluster_launch(cfg: BlockConfig) -> dict[str, int | None]:
    """The fused / v2 wrapper's launch keywords for a record's fields; a
    record of the one-block kernels (block_c != 0) takes the default launch."""
    if cfg.block_c:
        return {"rows": None, "quads": None}
    return {"rows": cfg.block_n or None, "quads": cfg.quads}


def v1_launch(cfg: BlockConfig) -> dict[str, int | None]:
    """The v1 wrapper's launch keywords for a record's fields. A record of the
    one-block v1 kernel (block_n 8, block_m 4Q) names 8-row N tiles and an M
    tile the cluster kernel offers; an M tile it does not offer takes the
    default. block_c, the order of the sums, is kept."""
    quads = cfg.quads if cfg.quads in lut_mod.QUADS else None
    return {"rows": cfg.block_n or None, "quads": quads, "block_c": cfg.block_c or None}


def encode_launch(cfg: BlockConfig, n: int, c: int, k: int, v: int) -> dict[str, int | None]:
    """The encode wrapper's launch keywords for a record's fields; a record
    whose block does not fit shared memory (one written for the kernel that
    staged row ranges pass by pass) takes the default launch."""
    launch = {"block_n": cfg.block_n or None, "block_c": cfg.block_c or None}
    try:
        enc_mod.encode_geometry(n, c, k, v, N_SMS, **launch)
    except ValueError:
        return {"block_n": None, "block_c": None}
    return launch


def predict_us(kind: str, n: int, m: int, c: int, k: int, v: int, cfg: BlockConfig,
               *, version: int = 2, n_sms: int = N_SMS) -> float:
    """Roofline estimate (microseconds) of one launch on an H100: the larger
    of its device-memory bytes (x, centroids, the table once per N tile,
    output) and its operations (fp32 encode, int8 lookup), plus what every
    block pays in sequence, spread over the blocks one wave runs at once, and
    a launch. Fused, v2 and v1 blocks pay for their cluster rank's share of
    the codebooks (staging it from L2, encoding the N tile's rows over it)
    and the cluster's barriers; v1 then its elements' ordered fp32 chains of
    C multiply-adds. An encode block pays for staging its chunk's centroids
    and rows and encoding them."""
    cb = lut_mod.codebook_smem_bytes(k, v)
    if kind == "encode":
        geo = enc_mod.encode_geometry(n, c, k, v, n_sms, block_n=cfg.block_n or None,
                                      block_c=cfg.block_c or None)
        rows, cc = geo["rows"], geo["chunk_c"]
        hbm = n * c * v * 4 + c * k * v * 4 + n * c * 4
        ops = 2.0 * n * c * k * v / FP32_FLOPS
        serial = ((cc * cb + rows * cc * v * 4) / (L2_BYTES_S / n_sms)
                  + 2.0 * rows * cc * k * v / (FP32_FLOPS / n_sms))
        waves = lut_mod.cdiv(geo["blocks"], n_sms)
        return (max(hbm / HBM_BW, ops) + waves * serial + LAUNCH_S) * 1e6
    s = lut_mod.default_cluster(c)
    # one wave of whole clusters (the card may hold fewer: a cluster's blocks
    # share a GPC)
    if version == 1:
        geo = lut_mod.v1_geometry(n, c, k, v, m, n_sms // s * s, **v1_launch(cfg))
    else:
        geo = lut_mod.cluster_geometry(n, c, k, v, m, n_sms // s * s, chunked=version == 2,
                                       **cluster_launch(cfg))
    blocks = geo["n_tiles"] * geo["grid_x"]
    share = lut_mod.cdiv(c, geo["cluster"])
    hbm = n * c * v * 4 + c * k * v * 4 + c * k * m * geo["n_tiles"] + n * m * 4
    ops = 2.0 * n * c * k * v / FP32_FLOPS + n * c * m / INT8_OPS
    serial = (share * cb / L2_BYTES_S
              + 2.0 * geo["rows"] * share * k * v / (FP32_FLOPS / n_sms)
              + (CLUSTER_SYNC_S if geo["cluster"] > 1 else 0.0))
    if version == 1:
        # each thread's elements, every codebook in order
        per_thread = lut_mod.cdiv(min(n, geo["rows"]) * 4 * geo["quads"], lut_mod.THREADS)
        serial += geo["tiles_per_block"] * per_thread * c * ORDERED_ADD_S
    waves = lut_mod.cdiv(blocks, n_sms)
    return (max(hbm / HBM_BW, ops) + waves * serial + LAUNCH_S) * 1e6


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def lookup(kind: str, n: int, m: int, c: int, k: int, v: int, *, dtype: str = "float32",
           backend: str = BACKEND_CUDA, cache: AutotuneCache | None = None) -> BlockConfig:
    """The recorded launch for a shape, else DEFAULT (each wrapper's own)."""
    rec = (cache or get_cache()).get(shape_key(kind, n, m, c, k, v, dtype, backend))
    if rec is None:
        return DEFAULT
    return BlockConfig(rec["block_n"], rec["block_m"], rec["block_c"])


def resolve_blocks(kind: str, n: int, m: int, c: int, k: int, v: int, dtype: str,
                   backend: str, block_n: int | None, block_m: int | None,
                   block_c: int | None) -> BlockConfig:
    """Fill unspecified fields from the record (or the wrappers' defaults)."""
    if block_n is None or block_m is None or block_c is None:
        tuned = lookup(kind, n, m, c, k, v, dtype=dtype, backend=backend)
        block_n = tuned.block_n if block_n is None else block_n
        block_m = tuned.block_m if block_m is None else block_m
        block_c = tuned.block_c if block_c is None else block_c
    return BlockConfig(block_n, block_m, block_c)


def tune(kind: str, n: int, m: int, c: int, k: int, v: int, *, dtype: str = "float32",
         backend: str = BACKEND_CUDA, cache: AutotuneCache | None = None,
         measure: Callable[[BlockConfig, int], float] | None = None,
         versions: tuple[int, ...] | None = None,
         save: bool = True) -> tuple[BlockConfig, dict[str, Any]]:
    """Pick the best (version, launch) for one shape and record it.

    measure: `(cfg, version) -> seconds`, timed on the card
    (`kernels.measure`); a candidate the wrapper refuses (ValueError: it
    does not fit this shape) is skipped. Without it, `predict_us` scores
    each version at its default launch (DEFAULT); a tie goes to the version
    swept first. versions: defaults to KERNEL_VERSIONS for kind "lut_amm"."""
    cache = cache or get_cache()
    key = shape_key(kind, n, m, c, k, v, dtype, backend)
    if versions is None:
        versions = KERNEL_VERSIONS if kind == "lut_amm" else (2,)
    best_cfg, best_t, best_ver = None, math.inf, versions[0]
    for ver in versions:
        cands = candidates(kind, n, m, c, k, v, ver)
        if measure is None and cands:
            cands = [DEFAULT]
        for cand in cands:
            if measure is not None:
                try:
                    t_us = measure(cand, ver) * 1e6
                except ValueError:
                    continue
            else:
                t_us = predict_us(kind, n, m, c, k, v, cand, version=ver)
            if t_us < best_t:
                best_cfg, best_t, best_ver = cand, t_us, ver
    if best_cfg is None:
        raise RuntimeError(f"no candidate of {key} ran")
    record = {
        **best_cfg.as_dict(),
        "predicted_us": best_t,
        "measured": measure is not None,
        "source": "cuda_events" if measure is not None else "roofline_model",
    }
    if kind == "lut_amm":
        record["version"] = best_ver
    cache.put(key, record)
    if save:
        cache.save()
    return best_cfg, record


def kernel_choice(n: int, m: int, c: int, k: int, v: int, *, dtype: str = "float32",
                  backend: str = BACKEND_CUDA,
                  cache: AutotuneCache | None = None) -> tuple[int, BlockConfig, bool]:
    """(version, launch, from_record) for `ops.lut_amm`. A record always
    wins (a record without "version" means v2, as in the reference); with
    none, `fit_version` at the default launch."""
    rec = (cache or get_cache()).get(shape_key("lut_amm", n, m, c, k, v, dtype, backend))
    if rec is not None:
        return (int(rec.get("version", 2)),
                BlockConfig(rec["block_n"], rec["block_m"], rec["block_c"]), True)
    return fit_version(c, k, v), DEFAULT, False


def fit_version(c: int, k: int, v: int) -> int:
    """The no-record fit rule: the fused kernel when all C codebooks' fp32
    centroids plus one N tile's codes fit in a block's shared memory on this
    card, else v2."""
    return VERSION_FUSED if fused_mod.fits(c, k, v) else 2
