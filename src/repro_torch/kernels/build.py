"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
Hopper only (`sm_90a`). Libraries land in `<repo>/build/kernels/`, named by
a hash of the sources and flags, so a checkout builds what it needs at first
use and a changed source can never load a stale library. Nothing here runs
at import time: a machine without nvcc or a card can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "fused_decode": "fused_decode.cu",
    "lut_amm_v2": "lut_amm_v2.cu",
    "lut_amm_v1": "lut_amm_v1.cu",
    "encode": "encode.cu",
}
HEADERS = ("lut_common.cuh",)
# -split-compile runs each source's optimization passes on 4 threads, which
# cuts the build's wall time (chip_smoke's [build] line, PERF.md)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile=4",
)

_LIBS: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def build_dir() -> Path:
    """`build/kernels` at the root of the checkout (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library of kernel `name` compiled with the macros `defines`, named
    by a hash of its sources and flags."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build(names: tuple[str, ...] | list[str] | None = None,
          defines: tuple[str, ...] = ()) -> dict[str, float]:
    """Compile every named kernel whose library is missing, all nvcc processes
    at once, with the preprocessor macros `defines`. Returns {name: seconds}
    for the ones compiled. The compiler's report (registers, shared memory,
    spills from `-Xptxas -v`) is kept in `build/kernels/<name>.log` (without
    macros)."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for name in names:
        target = lib_path(name, defines)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((name, target, tmp, proc, time.perf_counter()))
    times: dict[str, float] = {}
    failed = []
    for name, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if not defines:
            (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)          # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return times


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library `name` (compiled with the macros `defines`), built
    first if needed."""
    lib = _LIBS.get((name, defines))
    if lib is None:
        path = lib_path(name, defines)
        if not path.exists():
            build([name], defines)
        lib = _LIBS[name, defines] = ctypes.CDLL(str(path))
    return lib

