"""Deterministic fault injection for the serving stack.

Counterpart of `repro.serving.faults`, under the same names and wire format:

  * `FaultSpec`     — a declarative, JSON-round-trippable schedule of faults
                      (latency spikes, step exceptions, one worker kill).
  * `FaultInjector` — the live hook built from a spec. The engine calls
                      `on_step()` at the top of every `step()`; it sleeps
                      (spike), raises `InjectedFault` (transient: retried in
                      place by `StepGuard`, or the worker restarts), or raises
                      `InjectedKill` (a simulated hard crash: a
                      `BaseException`, so no `except Exception` absorbs it;
                      the supervised worker exits with `KILL_EXIT`).

Determinism: a probabilistic fault is drawn from `random.Random` seeded per
(spec.seed, call index, channel), the call index being the injector's own
counter, not the engine's step count: a retried step advances to the next
draw (fail once, succeed on retry), and the whole sequence is reproducible
for a seed. The reference seeds `random.Random` with that tuple, which
Python 3.11+ refuses; here the seed is an int, the first 8 bytes of a
blake2b digest of the tuple's repr, so the draws are this module's own (not
the reference's, which cannot run).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import time
from typing import Any

KILL_EXIT = 43               # a supervised worker's exit code for an InjectedKill


class InjectedFault(RuntimeError):
    """A transient, retryable step failure (`fault_tolerance.is_retryable`)."""


class InjectedKill(BaseException):
    """A simulated hard worker crash. A `BaseException` (like
    `KeyboardInterrupt`): retry guards catching `Exception` must not absorb a
    dead process. The supervised worker turns it into `os._exit(KILL_EXIT)`;
    in-process harnesses catch it explicitly."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault schedule. All-zero defaults inject nothing."""

    seed: int = 0
    spike_p: float = 0.0                 # P(latency spike) per on_step call
    spike_s: float = 0.02                # spike duration (sleep)
    error_p: float = 0.0                 # P(InjectedFault) per on_step call
    error_steps: tuple[int, ...] = ()    # explicit call indices that raise
    kill_at_step: int | None = None      # call index that raises InjectedKill

    def __post_init__(self) -> None:
        for name in ("spike_p", "error_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} must be a probability")
        if self.spike_s < 0:
            raise ValueError(f"spike_s={self.spike_s} must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["error_steps"] = list(self.error_steps)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "error_steps" in kw:
            kw["error_steps"] = tuple(kw["error_steps"])
        return cls(**kw)

    @property
    def active(self) -> bool:
        return bool(self.spike_p or self.error_p or self.error_steps
                    or self.kill_at_step is not None)


def draw_seed(seed: int, n: int, channel: str) -> int:
    """The int seed of one draw: blake2b of repr((seed, n, channel))."""
    h = hashlib.blake2b(repr((seed, n, channel)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FaultInjector:
    """Live hook object; one per engine/worker incarnation. `events` records
    every injected fault as (call_index, kind)."""

    def __init__(self, spec: FaultSpec, *, sleep=time.sleep):
        self.spec = spec
        self.calls = 0
        self.events: list[tuple[int, str]] = []
        self._sleep = sleep

    def _draw(self, n: int, channel: str) -> float:
        # independent stream per (seed, call, channel): a spike draw never
        # perturbs the error draw sequence
        return random.Random(draw_seed(self.spec.seed, n, channel)).random()

    def on_step(self) -> None:
        """Engine hook, called at the top of every `ServingEngine.step()`:
        may sleep, raise `InjectedFault` or raise `InjectedKill`. At most one
        fault fires per call; kill > error > spike when schedules collide."""
        n = self.calls
        self.calls += 1
        s = self.spec
        if s.kill_at_step is not None and n == s.kill_at_step:
            self.events.append((n, "kill"))
            raise InjectedKill(f"injected worker kill at call {n}")
        if n in s.error_steps or (s.error_p and self._draw(n, "err") < s.error_p):
            self.events.append((n, "error"))
            raise InjectedFault(f"injected step fault at call {n}")
        if s.spike_p and self._draw(n, "spike") < s.spike_p:
            self.events.append((n, "spike"))
            self._sleep(s.spike_s)

    def counts(self) -> dict[str, int]:
        out = {"kill": 0, "error": 0, "spike": 0}
        for _, kind in self.events:
            out[kind] += 1
        return out
