"""Multi-replica router: one front end, N supervised engines.

Counterpart of `repro.serving.router`, with the same names, policies,
counters and weights. N `EngineSupervisor` replicas serve one LUTArtifact
behind an `EngineRouter` that implements the backend interface of
`server.EnginePump`, so `server.FrontEnd` serves it unchanged. On the card
the replicas are worker processes, each with its own CUDA context (they may
share one card).

  * **Least-loaded placement**: each replica's load score is the router's
    exact in-flight count, maxed with the worker-reported `queue_depth +
    active_slots` while that report is fresh (`stats_staleness_s`); ties go
    to the lowest index.
  * **Prefix affinity** (`routing="prefix_affinity"`): a request is keyed on
    the first full KV page of its prompt (`affinity_key`) and the replicas
    are ranked by rendezvous (highest-random-weight, HRW) hashing
    (`_hrw_weight`, blake2b of repr((key, replica)), as in the reference:
    the same prompt picks the same replica index in both packages), so
    same-prefix sessions share a replica and its prefix cache. When the
    favorite's score reaches `spill_threshold` and a strictly less loaded
    replica exists the request spills there (`spills`), else it sticks
    (`affinity_hits`).
  * **Failover**: a replica whose supervisor fails closed is marked dead
    (`failovers`) and its requests are requeued onto a survivor
    (`requeues`), with a retry budget, the remaining deadline and a backoff;
    subscribers get ("restart", None). Past the budget, or with no survivor,
    a request resolves "error" (`lost`).
  * **Observability**: `stats()` sums the numeric engine counters over the
    replicas, adds the routing counters and a `per_replica` sub-dict that
    `server.metrics_text` renders as `lutnn_replica_*{replica="i"}`.

Lock discipline: supervisor callbacks run under the supervisor's lock and
call into the router, so the router never calls a lock-taking supervisor
method while holding `_lock` (only the lock-free `healthy` flag).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Callable

from repro_torch.distributed.fault_tolerance import Backoff
from repro_torch.serving.engine import validate_spec
from repro_torch.serving.supervisor import EngineSupervisor

ROUTING_POLICIES = ("least_loaded", "prefix_affinity")

_POLL_PERIOD_S = 0.02


def affinity_key(prompt: list[int], page_size: int) -> tuple[int, ...]:
    """The token-id tuple prefix-affinity hashes on: the first full KV page
    of the prompt (mirroring `kv_pool`'s page-size tokenization, so the
    affinity domain is exactly the unit the prefix cache shares), or the
    whole prompt when it is shorter than one page."""
    return tuple(prompt[:page_size])


def _hrw_weight(key: tuple, replica: int) -> int:
    """Rendezvous (highest-random-weight) hash of (key, replica): each key
    ranks every replica; removing a dead replica promotes that key's
    next-ranked survivor without re-ranking any other key."""
    h = hashlib.blake2b(repr((key, replica)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


@dataclasses.dataclass
class _Replica:
    index: int
    sup: EngineSupervisor
    inflight: set[int] = dataclasses.field(default_factory=set)  # live grids
    routed: int = 0                  # requests ever placed here
    dead: bool = False               # failed closed; excluded from routing
    load_report: int = 0             # worker-reported queue_depth+active_slots
    report_t: float = -1e9           # monotonic time the report was measured


@dataclasses.dataclass
class _RoutedRequest:
    grid: int
    spec: dict[str, Any]
    deadline: float | None           # absolute time.monotonic()
    on_event: Callable[[tuple[str, Any]], None] | None
    replica: int | None = None       # index currently serving this request
    sub_grid: int | None = None      # grid inside that replica's supervisor
    tokens: list[int] = dataclasses.field(default_factory=list)
    status: str | None = None
    retries: int = 0                 # router-level failover requeues spent
    queued_for_retry: bool = False   # sits in a retry/route box right now
    done_ev: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def done(self) -> bool:
        return self.status is not None


class EngineRouter:
    """N supervised engine replicas sharing one artifact, one backend."""

    def __init__(
        self,
        artifact_path: str | os.PathLike,
        *,
        replicas: int = 2,
        routing: str = "least_loaded",
        engine_kwargs: dict[str, Any] | None = None,
        supervisor_kwargs: dict[str, Any] | None = None,
        faults: Any = None,           # FaultSpec | [FaultSpec|None per replica]
        retry_budget: int = 2,
        backoff: Backoff = Backoff(base_s=0.05, factor=2.0, cap_s=1.0),
        affinity_page_size: int | None = None,
        spill_threshold: int | None = None,
        stats_staleness_s: float = 1.0,
    ):
        if replicas < 1:
            raise ValueError(f"replicas={replicas}: need >= 1")
        if routing not in ROUTING_POLICIES:
            raise ValueError(
                f"routing={routing!r}: must be one of {ROUTING_POLICIES}")
        self.routing = routing
        self.retry_budget = retry_budget
        self.backoff = backoff
        engine_kwargs = dict(engine_kwargs or {})
        # the affinity key unit defaults to the engines' actual KV page size
        # so affinity domains and prefix-cache share units coincide
        self.affinity_page_size = (
            affinity_page_size
            if affinity_page_size is not None
            else int(engine_kwargs.get("page_size", 16)))
        # favorite saturation = more live work than decode slots (a queue is
        # forming); below it affinity always sticks
        self.spill_threshold = (
            spill_threshold
            if spill_threshold is not None
            else int(engine_kwargs.get("n_slots", 4)))
        self.stats_staleness_s = stats_staleness_s

        fault_list = (list(faults) if isinstance(faults, (list, tuple))
                      else [faults] + [None] * (replicas - 1))
        if len(fault_list) != replicas:
            raise ValueError(
                f"faults: got {len(fault_list)} specs for {replicas} replicas")

        self._lock = threading.RLock()
        self._requests: dict[int, _RoutedRequest] = {}
        self._next_grid = 0
        self._retrybox: list[int] = []    # failover requeues (charge a retry)
        self._routebox: list[int] = []    # never reached a worker (no charge)
        self._wake = threading.Event()
        self._stop = False
        self.counters = {
            "routed": 0, "affinity_hits": 0, "spills": 0,
            "failovers": 0, "requeues": 0, "lost": 0,
        }
        self.exit_summary: str | None = None   # set by close()

        sup_kwargs = dict(supervisor_kwargs or {})
        self._replicas = [
            _Replica(i, EngineSupervisor(
                artifact_path, engine_kwargs=engine_kwargs,
                faults=fault_list[i], **sup_kwargs,
            ))
            for i in range(replicas)
        ]
        self._monitor = threading.Thread(
            target=self._run, name="engine-router", daemon=True)
        self._monitor.start()

    # -- backend interface (mirrors server.EnginePump) ---------------------
    @property
    def healthy(self) -> bool:
        """True iff >= 1 replica can still take traffic (drives /readyz)."""
        return not self._stop and any(
            not r.dead and r.sup.healthy for r in self._replicas)

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until >= 1 replica is serving (or every replica has failed,
        or `timeout`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for rep in self._replicas:
                if rep.sup.wait_ready(timeout=0.05) and rep.sup.healthy:
                    return True
            if all(not r.sup.healthy for r in self._replicas):
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False

    def submit(self, spec: dict[str, Any],
               on_event: Callable[[tuple[str, Any]], None] | None = None) -> int:
        validate_spec(spec)
        with self._lock:
            if not self.healthy:
                raise RuntimeError(
                    "router failed: every replica is dead "
                    f"({self._replica_summary()})")
            grid = self._next_grid
            self._next_grid += 1
            deadline_s = spec.get("deadline_s")
            st = _RoutedRequest(
                grid=grid, spec=dict(spec), on_event=on_event,
                deadline=(None if deadline_s is None
                          else time.monotonic() + float(deadline_s)),
            )
            self._requests[grid] = st
        self._send(st)
        return grid

    def cancel(self, grid: int) -> bool:
        with self._lock:
            st = self._requests.get(grid)
            if st is None or st.done:
                return False
            rep = (self._replicas[st.replica]
                   if st.replica is not None else None)
            sub = st.sub_grid
            if rep is None or sub is None or st.queued_for_retry:
                # not inside any worker: terminal here and now
                st.queued_for_retry = False
                self._finish_locked(st, "cancelled")
                return True
        return rep.sup.cancel(sub)        # retirement flows back via events

    def stats(self) -> dict[str, Any]:
        # snapshot replica objects outside any supervisor call, then poll
        # each supervisor WITHOUT the router lock (lock discipline above)
        with self._lock:
            reps = list(self._replicas)
            counters = dict(self.counters)
            pending = sum(not r.done for r in self._requests.values())
        agg: dict[str, Any] = {}
        per: dict[str, dict[str, Any]] = {}
        ages: list[float] = []
        for rep in reps:
            s = rep.sup.stats()
            s["routed"] = rep.routed
            s["inflight"] = len(rep.inflight)
            s["dead"] = int(rep.dead or not rep.sup.healthy)
            per[str(rep.index)] = s
            ages.append(s.get("stats_age_s", 0.0))
            for k, v in s.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg[k] = agg.get(k, 0) + v
        agg.update(counters)
        agg["backend"] = "router"
        agg["replicas"] = len(reps)
        agg["replicas_live"] = sum(1 - p["dead"] for p in per.values())
        agg["replicas_dead"] = sum(p["dead"] for p in per.values())
        agg["pending"] = pending
        agg["failed"] = int(not self.healthy)
        agg["stats_age_s"] = max(ages) if ages else 0.0
        agg["per_replica"] = per
        return agg

    def pending(self) -> int:
        with self._lock:
            return sum(not r.done for r in self._requests.values())

    def abort_pending(self) -> int:
        """Force-resolve every live request as "error" (drain deadline
        expiry), then best-effort abort inside each replica."""
        with self._lock:
            live = [r for r in self._requests.values() if not r.done]
            for st in live:
                st.queued_for_retry = False
                self._finish_locked(st, "error")
            self._retrybox.clear()
            self._routebox.clear()
        for rep in self._replicas:
            try:
                rep.sup.abort_pending()
            except Exception:            # noqa: BLE001 — replica may be dead
                pass
        return len(live)

    def close(self) -> None:
        """Router-level drain: stop routing, close every replica, aggregate
        their exit states into `exit_summary`."""
        self._stop = True
        self._wake.set()
        self._monitor.join(timeout=30)
        # snapshot BEFORE closing: sup.close() flips healthy on replicas
        # that were serving fine, which would read as "dead" here
        self.exit_summary = self._replica_summary()
        for rep in self._replicas:
            rep.sup.close()

    # -- test/bench conveniences (mirror EngineSupervisor) -----------------
    def wait(self, grid: int, timeout: float | None = None) -> _RoutedRequest:
        st = self._requests[grid]
        if not st.done_ev.wait(timeout):
            raise TimeoutError(f"request {grid} not terminal after {timeout}s")
        return st

    def results(self) -> dict[int, _RoutedRequest]:
        with self._lock:
            return dict(self._requests)

    # -- internals ---------------------------------------------------------
    def _replica_summary(self) -> str:
        return ", ".join(
            f"replica {r.index}: "
            + ("dead" if r.dead or not r.sup.healthy else "live")
            + (f" ({r.sup._last_crash})" if r.dead and r.sup._last_crash else "")
            for r in self._replicas)

    def _finish_locked(self, st: _RoutedRequest, status: str,
                       tokens: list[int] | None = None) -> None:
        if st.done:
            return
        st.status = status
        if tokens is not None:
            st.tokens = list(tokens)
        st.done_ev.set()
        self._dispatch(st, ("done", (status, st.tokens)))

    def _dispatch(self, st: _RoutedRequest, ev: tuple[str, Any]) -> None:
        if st.on_event is not None:
            try:
                st.on_event(ev)
            except Exception:            # noqa: BLE001 — a bad subscriber
                pass                     # must not poison the router

    def _mark_dead_locked(self, rep: _Replica) -> None:
        if not rep.dead:
            rep.dead = True
            self.counters["failovers"] += 1

    def _queue_retry_locked(self, st: _RoutedRequest) -> None:
        if not st.done and not st.queued_for_retry:
            st.queued_for_retry = True
            self._retrybox.append(st.grid)
            self._wake.set()

    # -- load scoring + placement ------------------------------------------
    def _score_locked(self, rep: _Replica, now: float) -> int:
        """Live load: router-tracked in-flight count (exact), maxed with the
        worker-reported queue_depth+active_slots when that report is fresh
        (its total age — supervisor stats push + router poll — is capped)."""
        score = len(rep.inflight)
        if now - rep.report_t <= self.stats_staleness_s:
            score = max(score, rep.load_report)
        return score

    def _pick_locked(self, st: _RoutedRequest, now: float) -> _Replica | None:
        alive = [r for r in self._replicas if not r.dead and r.sup.healthy]
        if not alive:
            return None
        if self.routing == "prefix_affinity" and st.spec.get("prompt"):
            key = affinity_key(st.spec["prompt"], self.affinity_page_size)
            fav = max(alive, key=lambda r: _hrw_weight(key, r.index))
            fav_score = self._score_locked(fav, now)
            if fav_score >= self.spill_threshold:
                best = min(alive,
                           key=lambda r: (self._score_locked(r, now), r.index))
                if self._score_locked(best, now) < fav_score:
                    self.counters["spills"] += 1
                    return best
            self.counters["affinity_hits"] += 1
            return fav
        return min(alive, key=lambda r: (self._score_locked(r, now), r.index))

    def _send(self, st: _RoutedRequest) -> None:
        """Place one request on a live replica (outside `_lock` for the
        actual submit — see the lock-discipline note in the module doc)."""
        with self._lock:
            if st.done:
                return
            now = time.monotonic()
            rep = self._pick_locked(st, now)
            if rep is None:
                self.counters["lost"] += 1
                self._finish_locked(st, "error")
                return
            remaining = None
            if st.deadline is not None:
                remaining = st.deadline - now
                if remaining <= 0:       # expired while down/queued
                    self._finish_locked(st, "timeout")
                    return
            st.replica = rep.index
            st.sub_grid = None
            rep.inflight.add(st.grid)
            rep.routed += 1
            self.counters["routed"] += 1
            spec = dict(st.spec)
            if remaining is not None:
                spec["deadline_s"] = remaining
        grid, idx = st.grid, rep.index
        try:
            sub = rep.sup.submit(
                spec, on_event=lambda ev: self._on_replica_event(grid, idx, ev))
        except RuntimeError:
            # replica failed between pick and submit: the request never ran
            # there, so re-route without charging its retry budget
            with self._lock:
                rep.inflight.discard(grid)
                self._mark_dead_locked(rep)
                if not st.done and not st.queued_for_retry:
                    st.replica = None
                    st.queued_for_retry = True
                    self._routebox.append(grid)
            self._wake.set()
            return
        with self._lock:
            st.sub_grid = sub

    # -- replica event bridge ----------------------------------------------
    def _on_replica_event(self, grid: int, rep_index: int,
                          ev: tuple[str, Any]) -> None:
        kind, payload = ev
        with self._lock:
            st = self._requests.get(grid)
            if st is None or st.done or st.replica != rep_index:
                return                   # stale event from a failed-over run
            rep = self._replicas[rep_index]
            if kind == "tokens":
                st.tokens.extend(payload)
                self._dispatch(st, ev)
            elif kind == "restart":
                # the replica's own worker restarted: replay is coming,
                # subscribers (and we) discard partial output
                st.tokens = []
                self._dispatch(st, ev)
            elif kind == "done":
                status, out_tokens = payload
                rep.inflight.discard(grid)
                if (status == "error" and not rep.sup.healthy
                        and not self._stop):
                    # the replica failed closed underneath this request —
                    # that "error" is the replica's verdict, not the
                    # request's: fail over to a survivor
                    self._mark_dead_locked(rep)
                    self._queue_retry_locked(st)
                    return
                self._finish_locked(st, status, out_tokens)

    # -- monitor thread ----------------------------------------------------
    def _run(self) -> None:
        while not self._stop:
            self._poll_loads()
            self._scan_replicas()
            retries, routes = self._drain_boxes()
            for grid in routes:
                st = self._requests.get(grid)
                if st is not None:
                    self._send(st)
            for grid in retries:
                self._requeue(grid)
            if not (retries or routes):
                self._wake.wait(_POLL_PERIOD_S)
                self._wake.clear()

    def _poll_loads(self) -> None:
        """Refresh each live replica's cached load report (outside `_lock`,
        then record under it). The report's effective age folds in the
        supervisor's own stats_age_s so a wedged worker's last gauges do
        not masquerade as fresh."""
        now = time.monotonic()
        for rep in self._replicas:
            if rep.dead or not rep.sup.healthy:
                continue
            s = rep.sup.stats()
            with self._lock:
                rep.load_report = (int(s.get("queue_depth", 0))
                                   + int(s.get("active_slots", 0)))
                rep.report_t = now - float(s.get("stats_age_s", 1e9))

    def _scan_replicas(self) -> None:
        """Safety net: flag replicas that failed closed with no live rids
        (no error events will arrive to trigger the callback path), and
        requeue any stranded in-flight grids exactly once."""
        for rep in self._replicas:
            if rep.dead or rep.sup.healthy:
                continue
            with self._lock:
                self._mark_dead_locked(rep)
                for grid in sorted(rep.inflight):
                    st = self._requests.get(grid)
                    if st is not None and st.replica == rep.index:
                        self._queue_retry_locked(st)
                rep.inflight.clear()

    def _drain_boxes(self) -> tuple[list[int], list[int]]:
        with self._lock:
            retries, self._retrybox = self._retrybox, []
            routes, self._routebox = self._routebox, []
        return retries, routes

    def _requeue(self, grid: int) -> None:
        """Failover path: spend one retry, discard streamed tokens, back
        off, re-route onto a survivor with the remaining deadline."""
        with self._lock:
            st = self._requests.get(grid)
            if st is None or st.done:
                return
            st.queued_for_retry = False
            st.replica = None
            st.retries += 1
            if st.retries > self.retry_budget:
                self.counters["lost"] += 1
                self._finish_locked(st, "error")
                return
            self.counters["requeues"] += 1
            if st.tokens:
                st.tokens = []
                self._dispatch(st, ("restart", None))
            attempt = st.retries - 1
        time.sleep(self.backoff.delay(attempt))
        self._send(st)
