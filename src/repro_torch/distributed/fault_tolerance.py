"""Retry classification and backoff, straggler detection and a heartbeat
file, for the serving supervisor and the training loop.

Counterpart of `repro.distributed.fault_tolerance`: `is_retryable`,
`Backoff`, `StepGuard`, `StragglerMonitor` and `HeartbeatFile`, under the
same names and with the same behaviour, plus one rule of the card's own. A CUDA error
(an illegal memory access, a device-side assert, any `CUDA error: ...`)
leaves the process's CUDA context poisoned: every later call on it fails
too, so a retry in place cannot succeed. Such an error is fatal here, the
worker dies and the supervisor respawns it with a fresh context. An
out-of-memory error (`torch.cuda.OutOfMemoryError`) is not one of them and
stays retryable, as the reference classifies it.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Callable

import torch

# what the message of an error from a poisoned CUDA context holds; the last
# is the port's own launch check (kernels/lut_amm.py, raise_on_error), which
# reports the sticky error of an earlier kernel too
_CUDA_FATAL = ("cuda error", "illegal memory access", "device-side assert", "cudaerror_t")
_CUDA_ERRORS = (RuntimeError,) + ((torch.AcceleratorError,)
                                  if hasattr(torch, "AcceleratorError") else ())


def is_retryable(e: Exception) -> bool:
    """Preemptions and transient errors are retryable; programming errors
    (TypeError, ValueError from shapes) and CUDA errors are not."""
    if isinstance(e, (TypeError, ValueError, KeyError, AssertionError)):
        return False
    msg = str(e).lower()
    if isinstance(e, _CUDA_ERRORS) and not isinstance(e, torch.cuda.OutOfMemoryError):
        if any(m in msg for m in _CUDA_FATAL):
            return False
    fatal_markers = ("invalid argument", "rank", "incompatible shapes")
    return not any(m in msg for m in fatal_markers)


@dataclasses.dataclass(frozen=True)
class Backoff:
    """Capped exponential backoff schedule: base * factor^attempt, <= cap.
    The supervisor's and the router's restart and requeue delays."""

    base_s: float = 0.1
    factor: float = 2.0
    cap_s: float = 5.0

    def __post_init__(self) -> None:
        if self.base_s < 0 or self.factor < 1.0 or self.cap_s < 0:
            raise ValueError(f"invalid backoff: {self}")

    def delay(self, attempt: int) -> float:
        """Delay before retry `attempt` (0-based)."""
        return min(self.base_s * self.factor ** attempt, self.cap_s)


@dataclasses.dataclass
class StepGuard:
    """Runs a step with up to `max_retries` retries of a retryable error;
    a fatal one propagates at once, exhaustion raises RuntimeError."""

    max_retries: int = 2
    backoff_s: float = 0.0
    on_failure: Callable[[Exception, int], None] | None = None

    def run(self, fn: Callable[[], Any]) -> Any:
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classification below
                if not is_retryable(e):
                    raise
                last = e
                if self.on_failure:
                    self.on_failure(e, attempt)
                if self.backoff_s:
                    time.sleep(self.backoff_s * (attempt + 1))
        raise RuntimeError(f"step failed after {self.max_retries + 1} attempts") from last


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time EMA; flags a step slower than `threshold` x EMA
    (after `warmup_steps`). A flagged step does not move the EMA."""

    threshold: float = 2.0
    decay: float = 0.9
    warmup_steps: int = 5

    _ema: float = 0.0
    _n: int = 0
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps:
            self._ema = seconds if self._ema == 0 else (
                self.decay * self._ema + (1 - self.decay) * seconds)
            return False
        slow = seconds > self.threshold * self._ema
        if slow:
            self.events.append({"step": step, "seconds": seconds, "ema": self._ema})
        else:
            self._ema = self.decay * self._ema + (1 - self.decay) * seconds
        return slow

    @property
    def ema(self) -> float:
        return self._ema


class HeartbeatFile:
    """Liveness breadcrumb for an external supervisor: one JSON record per
    step, the file rewritten each time."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int, **extra: Any) -> None:
        self.path.write_text(json.dumps({"step": step, "t": time.time(), **extra}))
