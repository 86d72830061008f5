"""The port's multi-replica router: its rendezvous weights against the
reference's, and the reference's router scenarios on their own
(least-loaded placement with token parity, failover after a replica dies,
all replicas dead, prefix affinity with spill, cancel and abort, and the
launcher's HTTP mode over routed replicas with an injected kill).

Reduced config (2 layers, d_model 64, vocab 128) on the CPU; each router
spawns 2 worker processes, and every wait has a timeout."""

import json
import re
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serving import router as jrouter
from repro_torch import configs as tcfg
from repro_torch.core.amm import Mode
from repro_torch.serving.artifact import save_artifact
from repro_torch.serving.faults import FaultSpec
from repro_torch.serving.router import EngineRouter, _hrw_weight, affinity_key
from repro_torch.serving.supervisor import EngineSupervisor

ENGINE_KW = dict(n_slots=2, max_seq=64, prefill_chunk=4, device="cpu")
WAIT_S = 120
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                           d_model=64, vocab=128, lut_use_kernel=True),
                          Mode.LUT_INFER)
    path = tmp_path_factory.mktemp("router") / "artifact"
    save_artifact(path, tb, tb.init(torch.Generator().manual_seed(0), device="cpu"))
    return path


def _specs(n=3):
    return [{"prompt": [i * 3 + 1, i * 3 + 2, i * 3 + 3], "max_tokens": 4} for i in range(n)]


@pytest.fixture(scope="module")
def baseline(artifact):
    """Fault-free tokens of one supervised engine, per spec index."""
    sup = EngineSupervisor(artifact, engine_kwargs=ENGINE_KW)
    try:
        grids = [sup.submit(s) for s in _specs()]
        states = {g: sup.wait(g, timeout=WAIT_S) for g in grids}
        assert all(st.status == "ok" for st in states.values())
        return [list(states[g].tokens) for g in grids]
    finally:
        sup.close()


def test_affinity_and_rendezvous_weights_match_reference():
    """200 seeded prompts: the same key, the same blake2b weights and so
    the same favorite replica (of 2, 3 and 4) in both packages; removing
    the favorite promotes the runner-up without re-ranking the rest."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        prompt = rng.integers(0, 151936, int(rng.integers(1, 40))).tolist()
        page = int(rng.choice([8, 16]))
        key = affinity_key(prompt, page)
        assert key == jrouter.affinity_key(prompt, page) == tuple(prompt[:page])
        for n in (2, 3, 4):
            weights = [_hrw_weight(key, i) for i in range(n)]
            assert weights == [jrouter._hrw_weight(key, i) for i in range(n)]
        ranked = sorted(range(4), key=lambda i: -_hrw_weight(key, i))
        survivors = ranked[1:]
        assert sorted(survivors, key=lambda i: -_hrw_weight(key, i)) == survivors


def test_router_validates_construction(tmp_path):
    with pytest.raises(ValueError, match="replicas"):
        EngineRouter(tmp_path, replicas=0)
    with pytest.raises(ValueError, match="routing"):
        EngineRouter(tmp_path, routing="round_robin")
    with pytest.raises(ValueError, match="faults"):
        EngineRouter(tmp_path, replicas=2, faults=[None, None, None])


def test_least_loaded_parity_cancel_and_abort(artifact, baseline):
    r = EngineRouter(artifact, replicas=2, engine_kwargs=ENGINE_KW)
    try:
        assert r.wait_ready(timeout=WAIT_S) and r.healthy
        grids = [r.submit(s) for s in _specs()]
        states = {g: r.wait(g, timeout=WAIT_S) for g in grids}
        for i, g in enumerate(grids):
            assert states[g].status == "ok" and states[g].tokens == baseline[i], g
        s = r.stats()
        assert s["backend"] == "router" and s["routed"] == 3 and s["lost"] == 0
        assert s["replicas"] == 2 and s["replicas_live"] == 2 and s["failovers"] == 0
        per = s["per_replica"]
        assert per["0"]["routed"] >= 1 and per["1"]["routed"] >= 1
        assert per["0"]["routed"] + per["1"]["routed"] == 3 and s["pending"] == 0
        # the workers' launch counters add up across replicas (plain versions here)
        assert s["plain_calls"] == per["0"]["plain_calls"] + per["1"]["plain_calls"] > 0
        g = r.submit({"prompt": [1, 2, 3], "max_tokens": 50})
        assert r.cancel(g) is True
        assert r.wait(g, timeout=WAIT_S).status == "cancelled"
        assert r.cancel(g) is False and r.cancel(999) is False
        with pytest.raises(ValueError, match="priority must be an int"):
            r.submit({"prompt": [1], "priority": "high"})
        g2 = r.submit({"prompt": [4, 5, 6], "max_tokens": 50})
        assert r.abort_pending() >= 1
        assert r.wait(g2, timeout=WAIT_S).status == "error" and r.pending() == 0
    finally:
        r.close()
    assert "live" in r.exit_summary


def test_failover_token_parity_after_replica_death(artifact, baseline):
    """Replica 0 crash-loops past max_restarts and fails closed; its
    requests replay on replica 1 to the fault-free tokens, and a subscriber
    that honours the restart events reconstructs exactly those tokens."""
    events: list[tuple[int, tuple]] = []
    lock = threading.Lock()

    def sub(i):
        def on_event(ev):
            with lock:
                events.append((i, ev))
        return on_event

    r = EngineRouter(artifact, replicas=2, engine_kwargs=ENGINE_KW, retry_budget=2,
                     faults=[FaultSpec(kill_at_step=1), None],
                     supervisor_kwargs=dict(faults_once=False, max_restarts=1,
                                            healthy_after_s=3600.0))
    try:
        assert r.wait_ready(timeout=WAIT_S)
        grids = [r.submit(s, on_event=sub(i)) for i, s in enumerate(_specs())]
        states = {g: r.wait(g, timeout=WAIT_S) for g in grids}
        for i, g in enumerate(grids):
            assert states[g].status == "ok" and states[g].tokens == baseline[i], g
        s = r.stats()
        assert s["failovers"] == 1 and s["requeues"] >= 1 and s["lost"] == 0
        assert s["replicas_live"] == 1 and s["replicas_dead"] == 1 and r.healthy
        failed_over = [g for g in grids if states[g].retries > 0]
        assert failed_over
        with lock:
            per_req: dict[int, list] = {}
            for i, ev in events:
                per_req.setdefault(i, []).append(ev)
        for g in failed_over:
            streamed: list[int] = []
            for kind, payload in per_req.get(g, []):
                if kind == "tokens":
                    streamed.extend(payload)
                elif kind == "restart":
                    streamed = []
            assert streamed == states[g].tokens, g
        lone = r.submit({"prompt": [42, 43], "max_tokens": 2})
        assert r.wait(lone, timeout=WAIT_S).status == "ok"
    finally:
        r.close()
    assert "dead" in r.exit_summary


def test_all_replicas_dead_fails_closed(artifact):
    r = EngineRouter(artifact, replicas=2, engine_kwargs=ENGINE_KW, retry_budget=1,
                     faults=[FaultSpec(kill_at_step=0), FaultSpec(kill_at_step=0)],
                     supervisor_kwargs=dict(faults_once=False, max_restarts=1,
                                            healthy_after_s=3600.0))
    try:
        assert r.wait_ready(timeout=WAIT_S)
        g = r.submit({"prompt": [1, 2, 3], "max_tokens": 4})
        assert r.wait(g, timeout=WAIT_S).status == "error"
        s = r.stats()
        assert s["replicas_live"] == 0 and s["lost"] >= 1
        assert not r.healthy and r.pending() == 0
        with pytest.raises(RuntimeError, match="every replica is dead"):
            r.submit({"prompt": [1], "max_tokens": 1})
    finally:
        r.close()


def test_prefix_affinity_sticks_and_spills(artifact):
    kw = dict(ENGINE_KW, paged=True, page_size=8)
    r = EngineRouter(artifact, replicas=2, routing="prefix_affinity", engine_kwargs=kw)
    try:
        assert r.wait_ready(timeout=WAIT_S) and r.affinity_page_size == 8
        same = {"prompt": list(range(1, 17)), "max_tokens": 2}
        reps = set()
        for _ in range(3):
            st = r.wait(r.submit(dict(same)), timeout=WAIT_S)
            assert st.status == "ok"
            reps.add(st.replica)
        assert len(reps) == 1
        fav = reps.pop()
        assert fav == max(range(2), key=lambda i: _hrw_weight(affinity_key(same["prompt"], 8), i))
        s = r.stats()
        assert s["affinity_hits"] == 3 and s["spills"] == 0
        assert s["per_replica"][str(fav)]["prefix_hits"] > 0
        assert s["per_replica"][str(1 - fav)]["routed"] == 0
        grids = [r.submit(dict(same)) for _ in range(2 * kw["n_slots"])]
        assert all(r.wait(g, timeout=WAIT_S).status == "ok" for g in grids)
        s = r.stats()
        assert s["spills"] >= 1 and s["affinity_hits"] + s["spills"] == 3 + len(grids)
    finally:
        r.close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT_S) as resp:
        return resp.status, resp.read()


def test_launcher_http_mode_over_routed_replicas(artifact, baseline):
    """`launch.serve --port 0 --replicas 2 --fault-json ...` prints the
    bound address, serves /generate (streamed) with the fault-free tokens
    after replica 0's worker is killed, shows the restart in /metrics, and
    exits 0 on SIGTERM."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
           "--artifact", str(artifact), "--port", "0", "--replicas", "2", "--slots", "2",
           "--max-seq", "64", "--prefill-chunk", "4", "--fault-json", '{"kill_at_step": 1}',
           "--fault-replica", "0"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    try:
        line = proc.stdout.readline()
        m = re.search(r"serving .* on http://127\.0\.0\.1:(\d+) ", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(m.group(1))
        assert _get(port, "/readyz")[0] == 200
        outs = [None] * 3

        def gen(i):
            body = json.dumps(dict(_specs()[i], stream=True)).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body)
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                outs[i] = [json.loads(ln) for ln in resp.read().decode().splitlines()]

        threads = [threading.Thread(target=gen, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        for i, lines in enumerate(outs):
            assert lines[-1]["status"] == "ok" and lines[-1]["tokens"] == baseline[i]
        metrics = _get(port, "/metrics")[1].decode()
        restarts = int(re.search(r"^lutnn_serving_restarts (\d+)", metrics, re.M).group(1))
        assert restarts >= 1 and 'lutnn_replica_routed{replica="1"}' in metrics
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
