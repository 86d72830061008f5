"""Device-time measurement for the autotuner, with CUDA events on the card.

Counterpart of `repro.kernels.measure`. `measure_lut_amm` builds the operands
of one lut_amm shape once and returns a `measure(cfg, version) -> seconds`
callable that `autotune.tune` sweeps; `measure_encode` does the same for the
encode kernel. Each candidate runs `warmup` times off the clock, then
`reps` timed runs of which the median counts.

Each timed run is one call between two CUDA events, with a spin on the
device and an L2 flush enqueued ahead of it: the host's enqueue of a wrapper
call (tens of microseconds) then overlaps the spin instead of being timed,
and the call finds its table cold in L2, as the model's 27 layers of tables
leave it. Without a card the measurement fails; it never falls back to the
CPU's clock.

Knobs (env, the reference's names): REPRO_AUTOTUNE_MEASURE=1 switches the
engine warm-up to measurement; REPRO_AUTOTUNE_MEASURE_REPS (default 5) and
REPRO_AUTOTUNE_MEASURE_WARMUP (default 1) bound each candidate's cost.
"""

from __future__ import annotations

import os
import statistics
from typing import Callable

import torch

from repro_torch.kernels import autotune

SPIN_CYCLES = 1_000_000      # ~0.5 ms of device time ahead of each timed call
FLUSH_BYTES = 64 << 20       # more than the H100's 50 MB of L2


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def measure_enabled() -> bool:
    """Whether the engine warm-up times candidates on the card (env flag)."""
    return os.environ.get("REPRO_AUTOTUNE_MEASURE", "0").lower() not in ("", "0", "false", "no")


def device_time_ms(fn: Callable[[], object], *, reps: int, warmup: int = 1,
                   flush: torch.Tensor | None = None) -> float:
    """Median device time (ms) of one call of `fn`, timed with CUDA events
    around the call after a device spin and (when given) an L2 flush."""
    for _ in range(max(1, warmup)):
        fn()
    events = []
    for _ in range(max(1, reps)):
        torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _card(device: str | torch.device | None) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measuring kernels needs the card; got device {dev} "
                           f"(cuda available: {torch.cuda.is_available()})")
    return dev


def _knobs(warmup: int | None, reps: int | None) -> tuple[int, int]:
    return (warmup if warmup is not None else _env_int("REPRO_AUTOTUNE_MEASURE_WARMUP", 1),
            reps if reps is not None else _env_int("REPRO_AUTOTUNE_MEASURE_REPS", 5))


def measure_lut_amm(n: int, m: int, c: int, k: int, v: int, *, dtype: str = "float32",
                    device: str | torch.device | None = None, warmup: int | None = None,
                    reps: int | None = None,
                    seed: int = 0) -> Callable[[autotune.BlockConfig, int], float]:
    """A `measure(cfg, version) -> seconds` callable for one lut_amm shape.
    Operands: activations in `dtype`, fp32 centroids, an int8 table with the
    m-shared (1, 1, M) scale, the layout deployed kernel sites carry."""
    from repro_torch.kernels import ops

    dev = _card(device)
    warmup, reps = _knobs(warmup, reps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, c * v), generator=gen, device=dev).to(getattr(torch, dtype))
    p = torch.randn((c, k, v), generator=gen, device=dev)
    tq = torch.randint(-127, 128, (c, k, m), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.full((1, 1, m), 0.02, device=dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def measure(cfg: autotune.BlockConfig, version: int = 2) -> float:
        def fn():
            return ops.lut_amm(x, p, tq, scale, version=version, blocks=cfg)
        return device_time_ms(fn, reps=reps, warmup=warmup, flush=flush) * 1e-3

    return measure


def measure_encode(n: int, c: int, k: int, v: int, *, dtype: str = "float32",
                   device: str | torch.device | None = None, warmup: int | None = None,
                   reps: int | None = None,
                   seed: int = 0) -> Callable[[autotune.BlockConfig, int], float]:
    """A `measure(cfg, version) -> seconds` callable for one encode shape
    (`version` is ignored: the encode has one kernel)."""
    from repro_torch.kernels import ops

    dev = _card(device)
    warmup, reps = _knobs(warmup, reps)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, c * v), generator=gen, device=dev).to(getattr(torch, dtype))
    p = torch.randn((c, k, v), generator=gen, device=dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def measure(cfg: autotune.BlockConfig, version: int = 2) -> float:
        def fn():
            return ops.encode(x, p, block_n=cfg.block_n, block_c=cfg.block_c)
        return device_time_ms(fn, reps=reps, warmup=warmup, flush=flush) * 1e-3

    return measure
