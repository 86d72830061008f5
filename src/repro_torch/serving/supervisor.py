"""Supervised serving: the engine in a worker process, restarted from the
LUTArtifact on a crash.

Counterpart of `repro.serving.supervisor`, with the same names, wire format
and semantics. `EngineSupervisor` runs a `ServingEngine` in a child process
started by `spawn` (a fresh interpreter and its own CUDA context, so a
poisoned context never survives a restart), built entirely from a
LUTArtifact path, and supervises it:

  * **Restart on crash**: any worker death (a step error past the in-worker
    `StepGuard` retries, a CUDA error, which is never retried in place, an
    `InjectedKill`, a segfault) is followed by a respawn from the artifact
    after a capped exponential backoff. A worker healthy for
    `healthy_after_s` resets the consecutive-crash count; `max_restarts`
    consecutive crashes fail the supervisor closed, every live request
    resolving as "error". A worker that cannot see the card dies (it never
    falls back to the CPU), and its crash report, the error's text, is the
    supervisor's `_last_crash`.
  * **Requeue with a retry budget**: requests inside the dead worker are
    resubmitted to the fresh one (generation restarts; subscribers get a
    ("restart", None) event; per-request seeded sampling makes the replay
    token-identical), each spending one unit of `retry_budget`; past it the
    request resolves "error" ("lost"). Deadlines are absolute.
  * **Fault injection**: a `faults.FaultSpec` is shipped as a dict to the
    first worker incarnation (`faults_once`), which wires a `FaultInjector`
    into its engine.

`engine_kwargs` cross the pipe as JSON-safe values: `device` ("cuda", the
default, or "cpu"), `compute_dtype` and `kv_dtype` by name and the draft by
its plan name. On
the card the parent builds the kernels once before the first spawn (nvcc, no
CUDA context), so replicas do not each compile and a worker's time to ready
holds no compile. The worker reports the monotonic time of each start-up
step (entered: interpreter and torch import done; CUDA context; artifact
loaded; autotune records restored; engine built), kept per incarnation in
`startups` and shown in `stats()`; on the card its stats carry its own
allocator's device memory (`device_mem_*_bytes`).

The parent object implements the backend interface of `server.EnginePump`
(submit/cancel/stats/pending/healthy/close/abort_pending).
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import threading
import time
import traceback
from typing import Any, Callable

from repro_torch.distributed.fault_tolerance import Backoff, StepGuard
from repro_torch.serving.engine import engine_refusal, validate_spec
from repro_torch.serving.faults import KILL_EXIT

_STATS_PERIOD_S = 0.25
# one kernel build at a time in this process: the replicas of a router wait
# for the first one's nvcc and then find the libraries built
_BUILD_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _worker_main(
    conn,
    artifact_path: str,
    engine_kwargs: dict[str, Any],
    fault_dict: dict[str, Any] | None,
    step_retries: int,
) -> None:
    """Worker entry point: load the artifact, build the engine, serve the
    pipe. Crashes are the supervisor's problem: this function either runs
    forever or exits the process. The "ready" message carries the engine's
    stats and the monotonic time of each start-up step."""
    stamps = {"entered": time.monotonic()}    # the interpreter and torch imported
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import counters
    from repro_torch.serving.artifact import load_artifact, restore_autotune_snapshot
    from repro_torch.serving.engine import ServingEngine, TokenTap, submit_from_spec
    from repro_torch.serving.faults import FaultInjector, FaultSpec, InjectedKill

    def stats() -> dict[str, Any]:
        # the kernels' launch counts, the faults injected and survived in
        # place (a kill is never reported: the process is gone), and on the
        # card this process's own device memory in PyTorch's allocator (the
        # CUDA context and kernel images are outside it)
        out = {**eng.stats(), **counters.stats()}
        if injector is not None:
            out.update({f"faults_{k}": n for k, n in injector.counts().items() if k != "kill"})
        if device.type == "cuda":
            out.update(device_mem_reserved_bytes=torch.cuda.memory_reserved(device),
                       device_mem_peak_reserved_bytes=torch.cuda.max_memory_reserved(device),
                       device_mem_allocated_bytes=torch.cuda.memory_allocated(device))
        return out

    try:
        engine_kwargs = dict(engine_kwargs)
        # no card: raise here, and the supervisor reports it (no CPU fallback)
        device = resolve_device(engine_kwargs.pop("device", None))
        if device.type == "cuda":
            torch.zeros(1, device=device)         # the process's CUDA context
            torch.cuda.synchronize(device)
        stamps["cuda"] = time.monotonic()
        art = load_artifact(artifact_path, restore_autotune=False, device=device)
        stamps["loaded"] = time.monotonic()
        restore_autotune_snapshot(artifact_path)
        stamps["restored"] = time.monotonic()
        injector = (
            FaultInjector(FaultSpec.from_dict(fault_dict)) if fault_dict else None
        )
        # engine_kwargs crossed the pipe JSON-safe, so the draft arrives as a
        # plan NAME resolved here against the same artifact; restarts reload
        # both plans
        draft_plan = engine_kwargs.pop("draft_plan", None)
        if engine_kwargs.get("spec_decode") and draft_plan is not None:
            draft = load_artifact(artifact_path, plan=draft_plan,
                                  restore_autotune=False, device=device)
            engine_kwargs.update(
                draft_bundle=draft.bundle, draft_params=draft.params)
        eng = ServingEngine(
            art.bundle, art.params, autotune_lut=False, faults=injector,
            device=device, **engine_kwargs,
        )
        stamps["engine"] = time.monotonic()
        tap = TokenTap(eng, consume=True)
        guard = StepGuard(max_retries=step_retries)
        e2g: dict[int, int] = {}          # engine rid -> supervisor grid
        g2e: dict[int, int] = {}
        conn.send(("ready", {**stats(), "startup": stamps}))
        last_stats = time.monotonic()
        while True:
            timeout = 0.0 if eng.has_work() else 0.02
            while conn.poll(timeout):
                cmd, payload = conn.recv()
                if cmd == "submit":
                    grid, spec = payload
                    rid = submit_from_spec(eng, spec)
                    e2g[rid] = grid
                    g2e[grid] = rid
                elif cmd == "cancel":
                    rid = g2e.get(payload)
                    if rid is not None:
                        eng.cancel(rid)   # retirement flows back via tap
                elif cmd == "stop":
                    conn.send(("stopped", None))
                    return
                timeout = 0.0
            if eng.has_work():
                # transient step faults retry in-place; exhaustion crashes
                # the worker and the supervisor takes over
                guard.run(eng.step)
            tokens, done = tap.poll()
            for rid, toks in tokens:
                if rid in e2g:
                    conn.send(("tokens", (e2g[rid], toks)))
            for req in done:
                grid = e2g.pop(req.rid, None)
                if grid is not None:
                    g2e.pop(grid, None)
                    conn.send(("done", (grid, req.status, req.out_tokens)))
            now = time.monotonic()
            if tokens or done or now - last_stats > _STATS_PERIOD_S:
                conn.send(("stats", stats()))
                last_stats = now
    except InjectedKill:
        os._exit(KILL_EXIT)              # simulated hard crash: no goodbye
    except BaseException as e:           # noqa: BLE001 — report, then die
        traceback.print_exc()
        try:
            conn.send(("crash", repr(e)))    # a CUDA error's text included
        except Exception:                # noqa: BLE001 — pipe may be gone
            pass
        os._exit(1)


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ReqState:
    grid: int
    spec: dict[str, Any]
    deadline: float | None               # absolute time.monotonic()
    on_event: Callable[[tuple[str, Any]], None] | None
    tokens: list[int] = dataclasses.field(default_factory=list)
    status: str | None = None            # terminal status once done
    retries: int = 0
    in_worker: bool = False              # sent to the CURRENT worker
    done_ev: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def done(self) -> bool:
        return self.status is not None


class EngineSupervisor:
    """Crash-supervised serving backend over a LUTArtifact directory."""

    def __init__(
        self,
        artifact_path: str | os.PathLike,
        *,
        engine_kwargs: dict[str, Any] | None = None,
        faults: Any | None = None,        # faults.FaultSpec
        faults_once: bool = True,
        retry_budget: int = 1,
        max_restarts: int = 3,
        backoff: Backoff = Backoff(base_s=0.05, factor=2.0, cap_s=2.0),
        step_retries: int = 1,
        healthy_after_s: float = 5.0,
        mp_context: str = "spawn",
    ):
        self.artifact_path = str(artifact_path)
        self.engine_kwargs = dict(engine_kwargs or {})
        self.faults = faults
        self.faults_once = faults_once
        self.retry_budget = retry_budget
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.step_retries = step_retries
        self.healthy_after_s = healthy_after_s
        self._ctx = mp.get_context(mp_context)
        self._needs_kernels = str(self.engine_kwargs.get("device", "cuda")).startswith("cuda")

        self._lock = threading.RLock()
        self._requests: dict[int, _ReqState] = {}
        self._outbox: list[int] = []      # grids not yet sent to any worker
        self._cancelbox: list[int] = []   # grids to cancel in the worker
        self._next_grid = 0
        self._stats: dict[str, Any] = {}
        self._stats_t = time.monotonic()  # when _stats last heard from a worker
        self._last_crash: str | None = None
        self.counters = {"spawns": 0, "restarts": 0, "requeued": 0, "lost": 0}
        # per worker incarnation: seconds from spawn to each start-up step
        self.startups: list[dict[str, float]] = []
        self._spawn_t = 0.0
        self._stop = False
        self._failed = False
        self._ready = threading.Event()   # first worker came up
        self._monitor = threading.Thread(
            target=self._run, name="engine-supervisor", daemon=True
        )
        self._monitor.start()

    # -- backend interface (mirrors server.EnginePump) ---------------------
    @property
    def healthy(self) -> bool:
        return not self._failed and not self._stop

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until the first worker is serving (or `timeout`)."""
        return self._ready.wait(timeout)

    def submit(self, spec: dict[str, Any],
               on_event: Callable[[tuple[str, Any]], None] | None = None) -> int:
        # validate BEFORE the pipe hop: a malformed field (non-numeric
        # priority/deadline_s, bad prompt) must surface as a ValueError here
        # — HTTP 400 — not as a worker crash loop on the far side
        validate_spec(spec)
        with self._lock:
            if not self.healthy:
                raise RuntimeError(
                    f"supervisor failed (last crash: {self._last_crash})"
                )
            grid = self._next_grid
            self._next_grid += 1
            deadline_s = spec.get("deadline_s")
            st = _ReqState(
                grid=grid, spec=dict(spec), on_event=on_event,
                deadline=(None if deadline_s is None
                          else time.monotonic() + float(deadline_s)),
            )
            self._requests[grid] = st
            self._outbox.append(grid)
        return grid

    def cancel(self, grid: int) -> bool:
        with self._lock:
            st = self._requests.get(grid)
            if st is None or st.done:
                return False
            if not st.in_worker and grid in self._outbox:
                self._outbox.remove(grid)
                self._finish(st, "cancelled")
            else:
                self._cancelbox.append(grid)
            return True

    def stats(self) -> dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
            s.update(self.counters)
            s["backend"] = "supervised"
            s["pending"] = sum(not r.done for r in self._requests.values())
            s["failed"] = int(self._failed)
            # how stale the worker-reported gauges (queue_depth,
            # active_slots, ...) are — the router's load scorer caps on this
            s["stats_age_s"] = time.monotonic() - self._stats_t
            s["startups"] = [dict(st) for st in self.startups]
        return s

    def pending(self) -> int:
        with self._lock:
            return sum(not r.done for r in self._requests.values())

    def abort_pending(self) -> int:
        with self._lock:
            live = [r for r in self._requests.values() if not r.done]
            for st in live:
                self._finish(st, "error")
            self._outbox.clear()
            return len(live)

    def wait(self, grid: int, timeout: float | None = None) -> _ReqState:
        """Block until `grid` is terminal; returns its state record."""
        st = self._requests[grid]
        if not st.done_ev.wait(timeout):
            raise TimeoutError(f"request {grid} not terminal after {timeout}s")
        return st

    def results(self) -> dict[int, _ReqState]:
        with self._lock:
            return dict(self._requests)

    def close(self) -> None:
        self._stop = True
        self._monitor.join(timeout=30)

    # -- internals ---------------------------------------------------------
    def _finish(self, st: _ReqState, status: str,
                tokens: list[int] | None = None) -> None:
        if st.done:
            return
        st.status = status
        if tokens is not None:
            st.tokens = list(tokens)
        st.done_ev.set()
        if st.on_event is not None:
            try:
                st.on_event(("done", (status, st.tokens)))
            except Exception:            # noqa: BLE001
                pass

    def _dispatch(self, st: _ReqState, ev: tuple[str, Any]) -> None:
        if st.on_event is not None:
            try:
                st.on_event(ev)
            except Exception:            # noqa: BLE001
                pass

    def _send_request(self, conn, st: _ReqState) -> None:
        """Ship one live request to the current worker, shrinking its
        deadline to the remaining budget (terminal "timeout" if spent)."""
        spec = dict(st.spec)
        if st.deadline is not None:
            remaining = st.deadline - time.monotonic()
            if remaining <= 0:
                self._finish(st, "timeout")
                return
            spec["deadline_s"] = remaining
        conn.send(("submit", (st.grid, spec)))
        st.in_worker = True

    def _on_worker_ready(self, conn, stats: dict[str, Any]) -> None:
        """A (re)started worker is serving: requeue every live request.

        Requests that were inside the dead worker spend one retry; past
        `retry_budget` they resolve as "error" rather than looping forever.
        """
        with self._lock:
            now = time.monotonic()
            stamps = stats.pop("startup", {})
            self.startups.append({f"{k}_s": t - self._spawn_t for k, t in stamps.items()}
                                 | {"ready_s": now - self._spawn_t})
            self._stats = stats
            self._stats_t = now
            for grid in sorted(g for g, r in self._requests.items() if not r.done):
                st = self._requests[grid]
                if st.in_worker:          # was lost with the previous worker
                    st.retries += 1
                    if st.retries > self.retry_budget:
                        self.counters["lost"] += 1
                        self._finish(st, "error")
                        continue
                    self.counters["requeued"] += 1
                    if st.tokens:
                        st.tokens = []
                        self._dispatch(st, ("restart", None))
                st.in_worker = False
                self._send_request(conn, st)
            self._outbox.clear()          # everything live was just sent
        self._ready.set()

    def _pump(self, conn) -> None:
        """Send queued submits/cancels to the live worker."""
        with self._lock:
            grids, self._outbox = self._outbox, []
            cancels, self._cancelbox = self._cancelbox, []
            for grid in grids:
                st = self._requests[grid]
                if not st.done:
                    self._send_request(conn, st)
            for grid in cancels:
                st = self._requests[grid]
                if not st.done and st.in_worker:
                    conn.send(("cancel", grid))

    def _handle(self, msg: tuple[str, Any], conn) -> None:
        kind, payload = msg
        if kind == "ready":
            self._on_worker_ready(conn, payload)
        elif kind == "tokens":
            grid, toks = payload
            with self._lock:
                st = self._requests.get(grid)
                if st is not None and not st.done:
                    st.tokens.extend(toks)
                    self._dispatch(st, ("tokens", toks))
        elif kind == "done":
            grid, status, out_tokens = payload
            with self._lock:
                st = self._requests.get(grid)
                if st is not None:
                    self._finish(st, status, out_tokens)
        elif kind == "stats":
            with self._lock:
                self._stats = payload
                self._stats_t = time.monotonic()
        elif kind == "crash":
            self._last_crash = payload

    def _fail_closed(self, reason: str) -> None:
        """Terminal supervisor failure: resolve every live rid as "error",
        refuse new submits, unblock wait_ready — nothing hangs forever."""
        self._last_crash = reason
        with self._lock:
            self._failed = True
            for st in [r for r in self._requests.values() if not r.done]:
                self.counters["lost"] += 1
                self._finish(st, "error")
        self._ready.set()

    def _check_artifact(self) -> str | None:
        """Parent-side serveability probe before every worker (re)spawn.

        A worker built from a vanished or corrupted artifact dies on load,
        restarts, dies again — a crash loop that burns `max_restarts` on a
        condition no respawn can fix (and the multi-replica router multiplies
        how often this path runs). Catch it here and fail closed with an
        actionable error instead; an artifact of a family the engine refuses
        (`engine.engine_refusal`: enc-dec, vision-LM) fails closed the same
        way. Returns the error string, or None when the
        artifact still looks serveable."""
        from repro_torch.configs import arch_from_dict
        from repro_torch.serving.artifact import check_artifact_dir

        try:
            manifest = check_artifact_dir(self.artifact_path)
            refusal = engine_refusal(arch_from_dict(manifest["arch"]))
        except (FileNotFoundError, ValueError, OSError, KeyError, TypeError) as e:
            return (f"artifact at {self.artifact_path} is not serveable: {e} "
                    f"— refusing to (re)spawn a worker that cannot load it")
        if refusal is not None:
            return (f"artifact at {self.artifact_path} is not serveable: {refusal} "
                    f"— refusing to (re)spawn a worker whose engine would refuse it")
        return None

    def _build_kernels(self) -> str | None:
        """Build the CUDA kernels in this process before the first spawn
        (nvcc needs no CUDA context), so that no worker compiles and a
        worker's time to ready holds no compile. Returns the error string of
        a failed build, or None."""
        from repro_torch.kernels import build

        try:
            with _BUILD_LOCK:
                build.build()
        except RuntimeError as e:
            return f"kernel build failed: {e}"
        return None

    def _run(self) -> None:
        consecutive = 0
        incarnation = 0
        proc = None
        while not self._stop:
            err = self._check_artifact()
            if err is None and incarnation == 0 and self._needs_kernels:
                err = self._build_kernels()
            if err is not None:
                self._fail_closed(err)
                return
            fault_dict = None
            if self.faults is not None and (incarnation == 0 or not self.faults_once):
                fault_dict = self.faults.to_dict()
            parent_conn, child_conn = self._ctx.Pipe()
            proc = self._ctx.Process(
                target=_worker_main,
                args=(child_conn, self.artifact_path, self.engine_kwargs,
                      fault_dict, self.step_retries),
                daemon=True,
            )
            self._spawn_t = time.monotonic()
            proc.start()
            child_conn.close()
            self.counters["spawns"] += 1
            incarnation += 1
            born = time.monotonic()
            saw_ready = False
            stopped_clean = False
            while not self._stop:
                try:
                    if saw_ready:
                        self._pump(parent_conn)
                    if parent_conn.poll(0.02):
                        msg = parent_conn.recv()
                        if msg[0] == "ready":
                            saw_ready = True
                        elif msg[0] == "stopped":
                            stopped_clean = True
                            break
                        self._handle(msg, parent_conn)
                        continue
                except (EOFError, OSError, BrokenPipeError):
                    break
                if not proc.is_alive():
                    # drain any buffered messages the dying worker flushed
                    try:
                        while parent_conn.poll(0):
                            self._handle(parent_conn.recv(), parent_conn)
                    except (EOFError, OSError, BrokenPipeError):
                        pass
                    break
            if self._stop or stopped_clean:
                self._shutdown_worker(proc, parent_conn)
                break
            # worker died: decide whether (and when) to restart
            alive_for = time.monotonic() - born
            if saw_ready and alive_for >= self.healthy_after_s:
                consecutive = 0
            consecutive += 1
            self.counters["restarts"] += 1
            parent_conn.close()
            if consecutive > self.max_restarts:
                self._fail_closed(
                    self._last_crash
                    or f"{consecutive} consecutive worker crashes "
                       f"(max_restarts={self.max_restarts})"
                )
                return
            time.sleep(self.backoff.delay(consecutive - 1))
        if proc is not None and self._stop:
            self._shutdown_worker(proc, None)

    def _shutdown_worker(self, proc, conn) -> None:
        if conn is not None:
            try:
                conn.send(("stop", None))
            except (OSError, BrokenPipeError):
                pass
        proc.join(timeout=5)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
        if conn is not None:
            conn.close()
