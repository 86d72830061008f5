"""The port's process layer (serving/server.py, supervisor.py, faults.py,
distributed/fault_tolerance.py and the engine's front-end helpers) against
the reference where the reference is sound, and on its own in the
reference's route, status, drain and supervisor scenarios.

Reduced config (2 layers, d_model 64, vocab 128) on the CPU. Supervised
tests spawn real worker processes; every wait has a timeout, so nothing can
hang the suite."""

import asyncio
import json
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import server as jserver
from repro_torch import configs as tcfg
from repro_torch.core.amm import Mode
from repro_torch.distributed.fault_tolerance import Backoff, StepGuard, is_retryable
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving.artifact import save_artifact
from repro_torch.serving.engine import ServingEngine, TokenTap
from repro_torch.serving.faults import (
    KILL_EXIT,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    InjectedKill,
)
from repro_torch.serving.server import EXIT_STRANDED, EnginePump, FrontEnd, metrics_text
from repro_torch.serving.supervisor import EngineSupervisor
from repro_torch.weights import params_from_numpy

SMALL = dict(n_layers=2, d_model=64, vocab=128)
ENGINE_KW = dict(n_slots=2, max_seq=64, prefill_chunk=4, device="cpu")
WAIT_S = 120          # the longest any one request may take here


def _port_model(**arch):
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"),
                                           **dict(SMALL, lut_use_kernel=True, **arch)),
                          Mode.LUT_INFER)
    return tb, tb.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def small():
    return _port_model()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, small):
    path = tmp_path_factory.mktemp("sup") / "artifact"
    save_artifact(path, *small)
    return path


def _specs(n=3):
    return [{"prompt": [i * 3 + 1, i * 3 + 2, i * 3 + 3], "max_tokens": 4} for i in range(n)]


# ---------------------------------------------------------------------------
# against the reference: request specs, metrics text, token tap, fault specs
# ---------------------------------------------------------------------------

SPECS = [
    {"prompt": [1, 2, 3]},
    {"prompt": [], "max_tokens": 2},
    {"prompt": (4, 5), "priority": 3, "deadline_s": 0.5, "spec_decode": False},
    {"prompt": [1], "temperature": 0.8, "top_k": 50, "top_p": 0.9, "seed": 7, "eos_id": 2},
    {"prompt": [1], "deadline_s": 2},
    {"prompt": "bad"},
    {"prompt": [1, "2"]},
    {"prompt": [1, True]},
    {"prompt": [1], "priority": "high"},
    {"prompt": [1], "priority": True},
    {"prompt": [1], "priority": 1.5},
    {"prompt": [1], "deadline_s": "soon"},
    {"prompt": [1], "deadline_s": False},
    {"prompt": [1], "spec_decode": 1},
    {"prompt": [1], "stream": True},
    {"prompt": [1], "unknown": 0},
    {"max_tokens": 3},
    [1, 2, 3],
    "prompt",
]


def _verdict(fn, spec):
    try:
        fn(spec)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_validate_spec_matches_reference(i):
    """The same specs are accepted, and rejected with the same message."""
    spec = SPECS[i]
    assert tengine.SPEC_KEYS == jengine.SPEC_KEYS
    assert _verdict(tengine.validate_spec, spec) == _verdict(jengine.validate_spec, spec)


STATS = [
    {"a": 1, "b": 2.5, "skip": "str", "flag": True, "completed": 0, "decode_tok_s": 1e-7},
    {"routed": 3, "pending": 0, "backend": "router",
     "per_replica": {"0": {"routed": 2, "queue_depth": 1, "backend": "supervised",
                           "startups": [{"ready_s": 1.5}]},
                     "1": {"routed": 1, "queue_depth": 0, "dead": 1},
                     "10": {"routed": 0, "stats_age_s": 0.25}}},
]


@pytest.mark.parametrize("i", range(len(STATS)))
def test_metrics_text_matches_reference(i):
    """Equal Prometheus text for the same stats, with and without the
    router's per-replica labels."""
    assert metrics_text(STATS[i]) == jserver.metrics_text(STATS[i])
    assert metrics_text(STATS[i], prefix="x_") == jserver.metrics_text(STATS[i], prefix="x_")


def test_token_tap_matches_reference():
    """The same requests through the reference engine and the port's, from
    the same params, polled after every step: equal token events and equal
    finished requests, with and without consume."""
    kw = dict(SMALL, lut_use_kernel=False)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tb, jax.tree.map(np.asarray, jparams), device="cpu")
    eng_kw = dict(n_slots=2, max_seq=32, prefill_chunk=4)
    prompts = [[5, 9, 2], [11, 3, 8, 13, 21, 34, 1, 7], [40, 41, 42]]
    engines = ((jengine.ServingEngine(jb, jparams, **eng_kw), jengine.TokenTap),
               (ServingEngine(tb, tparams, device="cpu", **eng_kw), TokenTap))
    for consume in (False, True):      # the second round's first poll reports the first's too
        streams = []
        for eng, tap_cls in engines:
            tap = tap_cls(eng, consume=consume)
            for n, p in enumerate(prompts):
                eng.submit(p, max_tokens=3 + n)
            eng.cancel(eng.submit([9, 9], max_tokens=4))
            events = []
            for _ in range(40):
                if not eng.has_work():
                    break
                eng.step()
                toks, done = tap.poll()
                events.append((toks, [(r.rid, r.status, list(r.out_tokens)) for r in done]))
            assert not eng.has_work()
            assert len(eng.finished) == (0 if consume else len(prompts) + 1)
            streams.append(events)
        assert streams[1] == streams[0] and len(streams[0]) > 3


def test_fault_spec_round_trips_like_the_reference():
    specs = [FaultSpec(), FaultSpec(seed=3, spike_p=0.5, spike_s=0.01, error_p=0.25,
                                    error_steps=(2, 5), kill_at_step=7)]
    for spec in specs:
        d = spec.to_dict()
        assert FaultSpec.from_dict(json.loads(json.dumps(d))) == spec
        assert d == jfaults.FaultSpec.from_dict(d).to_dict()
        assert FaultSpec.from_dict(dict(d, unknown=1)) == spec
        assert spec.active == jfaults.FaultSpec.from_dict(d).active
    for bad in ({"spike_p": 1.5}, {"error_p": -0.1}, {"spike_s": -1.0}):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
    assert KILL_EXIT == 43 and issubclass(InjectedFault, RuntimeError)
    assert not issubclass(InjectedKill, Exception)


# ---------------------------------------------------------------------------
# the port's own: injector determinism, retry classification
# ---------------------------------------------------------------------------

def test_injector_deterministic_and_counts():
    """An int seed per draw: the same spec gives the same events, another
    seed other ones; kill > error > spike; explicit error steps fire."""
    def run(seed):
        slept = []
        inj = FaultInjector(FaultSpec(seed=seed, spike_p=0.3, error_p=0.2, error_steps=(1,),
                                      kill_at_step=40), sleep=slept.append)
        for _ in range(40):
            try:
                inj.on_step()
            except InjectedFault:
                pass
        with pytest.raises(InjectedKill):
            inj.on_step()
        return inj.events, inj.counts(), slept

    a, b, c = run(0), run(0), run(1)
    assert a == b and a[0] != c[0]
    events, counts, slept = a
    assert (1, "error") in events and events[-1] == (40, "kill")
    assert counts["kill"] == 1 and counts["error"] >= 2 and counts["spike"] >= 2
    assert slept == [0.02] * counts["spike"]
    assert tfaults.draw_seed(0, 3, "err") == tfaults.draw_seed(0, 3, "err") != \
        tfaults.draw_seed(0, 3, "spike")
    quiet = FaultInjector(FaultSpec())
    for _ in range(5):
        quiet.on_step()
    assert quiet.events == [] and quiet.calls == 5


def test_is_retryable_treats_cuda_errors_as_fatal():
    for e in (RuntimeError("CUDA error: an illegal memory access was encountered"),
              RuntimeError("CUDA error: device-side assert triggered"),
              torch.AcceleratorError("CUDA error: unspecified launch failure"),
              RuntimeError("fused_decode kernel launch failed with cudaError_t 700"),
              ValueError("shape"), TypeError("x"), KeyError("k"),
              RuntimeError("Incompatible shapes"), RuntimeError("invalid argument")):
        assert not is_retryable(e), e
    for e in (InjectedFault("injected"), RuntimeError("transient"),
              torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")):
        assert is_retryable(e), e
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFault("once more")
        return "done"

    assert StepGuard(max_retries=2).run(flaky) == "done" and len(calls) == 3
    with pytest.raises(RuntimeError, match="illegal memory access"):
        StepGuard(max_retries=5).run(lambda: (_ for _ in ()).throw(
            RuntimeError("CUDA error: an illegal memory access was encountered")))
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        StepGuard(max_retries=1).run(lambda: (_ for _ in ()).throw(InjectedFault("x")))
    assert [Backoff(0.1, 2.0, 0.5).delay(i) for i in range(4)] == [0.1, 0.2, 0.4, 0.5]


def test_engine_fault_hook_and_retry_in_place_keep_tokens(small):
    """A transient fault at step 3, retried in place by StepGuard, gives
    the fault-free run's tokens; a kill propagates past an Exception guard."""
    def run(faults):
        eng = ServingEngine(*small, faults=faults, **ENGINE_KW)
        for s in _specs():
            tengine.submit_from_spec(eng, s)
        guard = StepGuard(max_retries=1)
        while eng.has_work():
            guard.run(eng.step)
        return [r.out_tokens for r in sorted(eng.finished, key=lambda r: r.rid)]

    inj = FaultInjector(FaultSpec(error_steps=(3,)))
    assert run(inj) == run(None)
    assert inj.counts() == {"kill": 0, "error": 1, "spike": 0}
    eng = ServingEngine(*small, faults=FaultInjector(FaultSpec(kill_at_step=0)), **ENGINE_KW)
    eng.submit([1, 2], max_tokens=2)
    with pytest.raises(InjectedKill):
        StepGuard(max_retries=3).run(eng.step)


# ---------------------------------------------------------------------------
# the HTTP front end: routes, streaming, shedding, drain, pump death
# ---------------------------------------------------------------------------

async def _http(port, method, path, body=None):
    """One HTTP/1.1 exchange; returns (status_code, raw_body_bytes)."""
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), 10)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), WAIT_S)   # the server closes the connection
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


class StubBackend:
    """A backend with a pending count the test controls (drain tests)."""

    def __init__(self, pending=0):
        self.n = pending
        self.aborted = 0
        self.closed = False
        self.healthy = True

    def pending(self):
        return self.n

    def abort_pending(self):
        self.aborted, self.n = self.n, 0
        return self.aborted

    def stats(self):
        return {"pending": self.n, "queue_depth": 0}

    def cancel(self, rid):
        return False

    def close(self):
        self.closed = True


def _serve(backend, scenario, **fe_kw):
    async def main():
        fe = FrontEnd(backend, port=0, **fe_kw)
        await fe.start()
        await scenario(fe)
        fe.request_shutdown()
        return await asyncio.wait_for(fe.serve_forever(), WAIT_S)
    return asyncio.run(main())


def test_routes_streaming_and_status_codes(small):
    pump = EnginePump(ServingEngine(*small, **ENGINE_KW))

    async def scenario(fe):
        p = fe.port
        assert (await _http(p, "GET", "/healthz"))[0] == 200
        assert (await _http(p, "GET", "/readyz"))[0] == 200
        assert (await _http(p, "GET", "/nope"))[0] == 404
        assert (await _http(p, "GET", "/generate"))[0] == 405
        assert (await _http(p, "GET", "/cancel"))[0] == 405
        for body, msg in (({"prompt": "bad"}, b"list of ints"),
                          ({"prompt": [1], "priority": "high"}, b"priority must be an int"),
                          ({"prompt": [1], "deadline_s": "soon"}, b"deadline_s must be a number"),
                          ([1, 2], b"JSON object")):
            code, resp = await _http(p, "POST", "/generate", body)
            assert code == 400 and msg in resp, resp
        code, body = await _http(p, "POST", "/generate", {"prompt": [1, 2, 3], "max_tokens": 3})
        resp = json.loads(body)
        assert code == 200 and resp["status"] == "ok" and resp["n_tokens"] == 3
        code, body = await _http(p, "POST", "/generate",
                                 {"prompt": [5, 6, 7], "max_tokens": 4, "stream": True})
        lines = [json.loads(ln) for ln in body.decode().splitlines()]
        assert code == 200 and set(lines[0]) == {"rid"}
        assert [ln["token"] for ln in lines[1:-1]] == lines[-1]["tokens"]
        assert lines[-1]["status"] == "ok" and lines[-1]["n_tokens"] == 4
        st = json.loads((await _http(p, "GET", "/stats"))[1])
        assert st["backend"] == "local" and st["completed"] == 2 and st["restarts"] == 0
        assert st["plain_calls"] > 0 and st["launches_fused_decode"] == 0    # CPU: plain
        code, body = await _http(p, "GET", "/metrics")
        assert code == 200 and b"lutnn_serving_completed 2" in body
        assert b"lutnn_serving_queue_depth" in body
        code, body = await _http(p, "POST", "/cancel", {"rid": 999})
        assert code == 200 and json.loads(body) == {"cancelled": False}
        assert (await _http(p, "POST", "/cancel", {"x": 1}))[0] == 400

    assert _serve(pump, scenario) == 0


def test_shed_maps_to_429(small):
    """A queue of 1 behind a slot pinned by slow (spike-injected) steps: the
    next arrival at equal priority is shed at submit and answers 429."""
    eng = ServingEngine(*small, **dict(ENGINE_KW, n_slots=1), max_queue=1,
                        faults=FaultInjector(FaultSpec(spike_p=1.0, spike_s=0.05)))
    pump = EnginePump(eng)

    async def scenario(fe):
        p = fe.port
        occupants = [asyncio.create_task(_http(p, "POST", "/generate",
                                               {"prompt": [1, 2], "max_tokens": 60}))]
        for _ in range(200):                      # rid 0 in the slot
            await asyncio.sleep(0.02)
            if pump.stats()["active_slots"] == 1:
                break
        occupants.append(asyncio.create_task(_http(p, "POST", "/generate",
                                                   {"prompt": [3, 4], "max_tokens": 60})))
        for _ in range(200):                      # rid 1 queued: the queue is full
            await asyncio.sleep(0.02)
            if pump.stats()["queue_depth"] == 1:
                break
        code, body = await _http(p, "POST", "/generate", {"prompt": [7, 8], "max_tokens": 2})
        assert code == 429 and json.loads(body)["status"] == "shed"
        for rid in (0, 1):
            code, body = await _http(p, "POST", "/cancel", {"rid": rid})
            assert json.loads(body)["cancelled"] is True
        for t in occupants:
            assert json.loads((await t)[1])["status"] == "cancelled"

    assert _serve(pump, scenario) == 0


def test_drain_clean_refusing_and_stranded():
    stub = StubBackend(pending=0)

    async def nothing(fe):
        pass

    assert _serve(stub, nothing) == 0 and stub.closed and stub.aborted == 0

    stub = StubBackend(pending=1)

    async def main():
        fe = FrontEnd(stub, port=0, drain_timeout_s=10.0)
        await fe.start()
        fe.request_shutdown()
        await asyncio.sleep(0.05)                 # the drain loop is waiting
        code, body = await _http(fe.port, "GET", "/readyz")
        assert code == 503 and b"draining" in body
        assert (await _http(fe.port, "POST", "/generate", {"prompt": [1]}))[0] == 503
        assert (await _http(fe.port, "GET", "/healthz"))[0] == 200
        stub.n = 0                                # in-flight work completes
        return await asyncio.wait_for(fe.serve_forever(), WAIT_S)

    assert asyncio.run(main()) == 0 and stub.aborted == 0
    stub = StubBackend(pending=2)
    assert _serve(stub, nothing, drain_timeout_s=0.1) == EXIT_STRANDED
    assert stub.aborted == 2 and stub.closed


def test_pump_death_resolves_requests_and_refuses_new(small):
    eng = ServingEngine(*small, **dict(ENGINE_KW, n_slots=1),
                        faults=FaultInjector(FaultSpec(kill_at_step=0)))
    pump = EnginePump(eng)
    events = []
    done = threading.Event()

    def on_event(ev):
        events.append(ev)
        if ev[0] == "done":
            done.set()

    pump.submit({"prompt": [1, 2, 3], "max_tokens": 4}, on_event)
    assert done.wait(timeout=WAIT_S)
    assert events[-1][1][0] == "error" and not pump.healthy and pump.pending() == 0
    with pytest.raises(RuntimeError, match="engine died"):
        pump.submit({"prompt": [1], "max_tokens": 1})
    pump.close()


# ---------------------------------------------------------------------------
# the supervisor: worker processes, kill and requeue, failing closed
# ---------------------------------------------------------------------------

def test_kill_restart_requeue_token_parity(artifact):
    """The fault-free run (with a cancel from the outbox and a deadline
    spent before the worker saw it), then a worker killed at its second
    step: restarted from the artifact, every request requeued and replayed
    to the same tokens; the start-up of each incarnation is recorded."""
    base = EngineSupervisor(artifact, engine_kwargs=ENGINE_KW)
    try:
        grids = [base.submit(s) for s in _specs()]
        g_cancel = base.submit({"prompt": [9, 9], "max_tokens": 4})
        assert base.cancel(g_cancel) is True and base.cancel(g_cancel) is False
        g_late = base.submit({"prompt": [8, 8], "max_tokens": 4, "deadline_s": 1e-4})
        baseline = {g: base.wait(g, timeout=WAIT_S) for g in grids}
        assert all(st.status == "ok" for st in baseline.values())
        assert base.wait(g_cancel, timeout=WAIT_S).status == "cancelled"
        assert base.wait(g_late, timeout=WAIT_S).status == "timeout"
        st = base.stats()
        assert st["restarts"] == 0 and st["backend"] == "supervised"
        assert st["plain_calls"] > 0 and st["launches_lut_amm_v2"] == 0
        (startup,) = st["startups"]
        assert 0 < startup["entered_s"] <= startup["cuda_s"] <= startup["loaded_s"] <= \
            startup["restored_s"] <= startup["engine_s"] <= startup["ready_s"]
    finally:
        base.close()

    events: dict[int, list] = {}
    sup = EngineSupervisor(artifact, engine_kwargs=ENGINE_KW,
                           faults=FaultSpec(kill_at_step=1), retry_budget=2)
    try:
        grids = [sup.submit(s, on_event=events.setdefault(i, []).append)
                 for i, s in enumerate(_specs())]
        states = {g: sup.wait(g, timeout=WAIT_S) for g in grids}
        st = sup.stats()
        assert st["restarts"] >= 1 and st["requeued"] >= 1 and st["lost"] == 0
        assert len(st["startups"]) == st["spawns"] >= 2
        for g in grids:
            assert states[g].status == "ok"
            assert states[g].tokens == list(baseline[g].tokens), g
            streamed = []
            for kind, payload in events[g]:
                if kind == "tokens":
                    streamed.extend(payload)
                elif kind == "restart":
                    streamed = []
            assert streamed == states[g].tokens
    finally:
        sup.close()


def test_crash_loop_exhausts_restarts_and_fails_closed(artifact):
    sup = EngineSupervisor(artifact, engine_kwargs=ENGINE_KW,
                           faults=FaultSpec(kill_at_step=0), faults_once=False,
                           retry_budget=5, max_restarts=1, healthy_after_s=3600.0)
    try:
        g = sup.submit({"prompt": [1, 2, 3], "max_tokens": 4})
        assert sup.wait(g, timeout=WAIT_S).status == "error"
        assert sup.stats()["failed"] == 1 and not sup.healthy and sup.pending() == 0
        with pytest.raises(RuntimeError, match="supervisor failed"):
            sup.submit({"prompt": [1], "max_tokens": 1})
    finally:
        sup.close()


def test_missing_or_vanished_artifact_fails_closed(artifact, tmp_path):
    """A missing artifact fails closed before any spawn (and before any
    kernel build); one that vanishes before a restart, after one probe."""
    sup = EngineSupervisor(tmp_path / "nope", max_restarts=50)    # the card's default device
    try:
        assert sup.wait_ready(timeout=WAIT_S) and not sup.healthy
        assert sup.stats()["spawns"] == 0
        with pytest.raises(RuntimeError, match="not serveable"):
            sup.submit({"prompt": [1], "max_tokens": 1})
    finally:
        sup.close()
    copy = tmp_path / "artifact"
    shutil.copytree(artifact, copy)
    sup = EngineSupervisor(copy, engine_kwargs=ENGINE_KW, faults=FaultSpec(kill_at_step=1),
                           max_restarts=50)
    try:
        assert sup.wait_ready(timeout=WAIT_S)
        g = sup.submit({"prompt": [1, 2, 3], "max_tokens": 8})
        shutil.rmtree(copy)
        assert sup.wait(g, timeout=WAIT_S).status == "error"
        assert not sup.healthy and sup.pending() == 0 and sup.stats()["spawns"] == 1
    finally:
        sup.close()


def test_worker_without_the_card_dies_and_is_reported(artifact, monkeypatch):
    """A worker asked for the card where there is none raises at start-up
    (no CPU fallback); the supervisor restarts it, then fails closed with
    the worker's error text."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "build", lambda *a, **k: {})    # no nvcc without the toolkit
    sup = EngineSupervisor(artifact, engine_kwargs=dict(ENGINE_KW, device="cuda:0"),
                           max_restarts=1, backoff=Backoff(0.01, 1.0, 0.01))
    try:
        assert sup.wait_ready(timeout=WAIT_S) and not sup.healthy
        assert "no CUDA device" in sup._last_crash
        assert sup.stats()["spawns"] == 2
    finally:
        sup.close()


def test_launcher_http_mode_in_process_and_argument_checks():
    """`launch.serve --port 0` without an artifact serves an in-process
    engine: the address line carries the real port, /generate streams,
    SIGTERM exits 0; the supervised and routed modes refuse what the
    reference's launcher refuses."""
    import re
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from repro_torch.launch import serve

    for argv, msg in ((["--port", "0", "--supervise"], "requires --artifact"),
                      (["--supervise", "--artifact", "x"], "requires --port"),
                      (["--replicas", "2", "--port", "0"], "requires --artifact"),
                      (["--fault-json", "{}", "--port", "0"], "--replicas >= 2"),
                      (["--replicas", "0"], "must be >= 1")):
        with pytest.raises(SystemExit):
            serve.main(argv)
    env = {"PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--port", "0",
         "--use-kernel", "--layers", "2", "--d-model", "64", "--vocab", "128", "--max-seq", "64",
         "--prefill-chunk", "8", "--slots", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        m = re.search(r"on http://127\.0\.0\.1:(\d+) ", line)
        assert m and int(m.group(1)) > 0, line
        url = f"http://127.0.0.1:{m.group(1)}"
        with urllib.request.urlopen(url + "/readyz", timeout=WAIT_S) as resp:
            assert resp.status == 200
        req = urllib.request.Request(url + "/generate", data=json.dumps(
            {"prompt": [1, 2, 3], "max_tokens": 4, "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            lines = [json.loads(ln) for ln in resp.read().decode().splitlines()]
        assert lines[-1]["status"] == "ok" and len(lines) == 6
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
