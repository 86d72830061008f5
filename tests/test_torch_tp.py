"""Tensor-parallel serving of the port at tp=2, two gloo ranks on the CPU,
against the reference's unsharded and tp=2 engines (as
tests/test_serving_sharded.py drives them) and the port's unsharded engine.

Both packages serve the same reference-written artifacts (reduced
qwen3_1p7b, 2 layers): the reference's own `lut_use_kernel=False` one (its
tests' model: per-codebook scales) and a `lut_use_kernel=True` one (m-shared
scales, the port's LUT sites through the kernels' plain versions). For each
of the dense, paged and artifact-loaded engines, with the reference tests'
requests: greedy tokens equal the reference's unsharded engine's and its
tp=2 engine's; the logits are within 1e-4 of the port's unsharded engine's;
with m-shared tables every LUT site's output (a column site's columns, a
row site's reduced output) is the unsharded site's bytewise. Also the
launcher's `--tp 2`, its refusals, and the engine's refusals (the MoE, SSM
and hybrid families are served: tests/test_torch_tp_families.py)."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.amm import Mode as JMode
from repro.serving import artifact as jart
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.distributed.tensor_parallel import tp_refusal
from repro_torch.launch.mesh import HostMesh, backend_for
from repro_torch.serving.engine import ServingEngine
from tests._subproc import SRC
from tests._tp_ranks import (
    ARTIFACT_REQS,
    DENSE_REQS,
    PAGED_REQS,
    collect,
    serve_variants,
    start_ranks,
)

LOGIT_ATOL = 1e-4
VARIANTS = ("plain", "kernel")      # lut_use_kernel False / True
CASES = ("dense", "paged", "artifact")
REQS = {"dense": DENSE_REQS, "paged": PAGED_REQS, "artifact": ARTIFACT_REQS}


def _ref_tokens(bundle, params, reqs, **kw):
    eng = JServingEngine(bundle, params, n_slots=2, max_seq=32, prefill_chunk=4,
                         autotune_lut=False, **kw)
    for prompt, n in reqs:
        eng.submit(prompt, max_tokens=n)
    return [r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{variant: {"ref": {case: tokens}, "ref_tp": {case: tokens}, "ranks":
    [rank 0's serve_variant result, rank 1's]}}."""
    root = tmp_path_factory.mktemp("tp")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(root / "autotune.json"))
        return _serve_all(root)


def _serve_all(root) -> dict:
    refs, arts = {}, {}
    for variant in VARIANTS:
        arch = jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                lut_use_kernel=variant == "kernel")
        bundle = jcfg.build_model(arch, JMode.LUT_INFER)
        refs[variant] = (bundle, bundle.init(jax.random.PRNGKey(0)))
        arts[variant] = str(root / variant)
        jart.save_artifact(arts[variant], bundle, refs[variant][1], autotune_snapshot=False)
    # the reference's tp=2 engines (as its sharded tests build them) and the
    # port's ranks run beside the reference's unsharded engines here
    code = textwrap.dedent(f"""
        import json
        from repro.launch.mesh import make_host_mesh
        from repro.serving.artifact import load_artifact
        from repro.serving.engine import ServingEngine
        res = {{}}
        for variant in {VARIANTS!r}:
            art = load_artifact({str(root)!r} + "/" + variant, restore_autotune=False)
            mesh = make_host_mesh(data=1, model=2)
            res[variant] = {{}}
            for case, reqs, kw in (("dense", {DENSE_REQS!r}, {{}}),
                                   ("paged", {PAGED_REQS!r}, {{"paged": True, "page_size": 4}}),
                                   ("artifact", {ARTIFACT_REQS!r}, {{}})):
                eng = ServingEngine(art.bundle, art.params, n_slots=2, max_seq=32,
                                    prefill_chunk=4, autotune_lut=False, mesh=mesh, **kw)
                for prompt, n in reqs:
                    eng.submit(prompt, max_tokens=n)
                res[variant][case] = [r.out_tokens for r in
                                      sorted(eng.run_until_done(), key=lambda r: r.rid)]
        print("REF_TP=" + json.dumps(res))
        """)
    ref_tp = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC,
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"))
    ranks = start_ranks(serve_variants, 2, arts)
    out = {variant: {"art": arts[variant], "ref": {
        "dense": _ref_tokens(bundle, params, DENSE_REQS),
        "paged": _ref_tokens(bundle, params, PAGED_REQS),
        "artifact": _ref_tokens(bundle, params, ARTIFACT_REQS)}}
        for variant, (bundle, params) in refs.items()}
    per_rank = collect(ranks)
    stdout, stderr = ref_tp.communicate(timeout=600)
    assert ref_tp.returncode == 0, stderr
    line = next(ln for ln in stdout.splitlines() if ln.startswith("REF_TP="))
    for variant, toks in json.loads(line[len("REF_TP="):]).items():
        out[variant]["ref_tp"] = toks
        out[variant]["ranks"] = [r[variant] for r in per_rank]
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_tp2_tokens_equal_the_reference(served, variant, case):
    got = served[variant]["ranks"][0]["tp"][case]["tokens"]
    assert got == served[variant]["ref"][case], (variant, case)
    assert got == served[variant]["ref_tp"][case], (variant, case)
    assert got == served[variant]["ranks"][0]["plain"][case]["tokens"]
    assert all(len(t) == n for t, (_, n) in zip(got, REQS[case]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_tp2_logits_within_bound_on_every_rank(served, variant, case):
    ranks = served[variant]["ranks"]
    want = ranks[0]["plain"][case]["logits"]
    for rank in ranks:
        got = rank["tp"][case]["logits"]
        assert len(got) == len(want) > 0
        for (g, lens), (w, _) in zip(got, want):
            assert g.shape == w.shape
            assert float(np.abs(g - w).max()) <= LOGIT_ATOL
    # every rank ends each forward with the same logits (rank 0 samples)
    for (a, _), (b, _) in zip(ranks[0]["tp"][case]["logits"], ranks[1]["tp"][case]["logits"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_tp2_lut_sites_bytewise_on_m_shared_tables(served, case):
    ranks = served["kernel"]["ranks"]
    want = ranks[0]["plain"][case]["sites"]
    n_lut = {"col": 0, "row": 0}
    for r, rank in enumerate(ranks):
        got = rank["tp"][case]["sites"]
        assert [(n, m) for n, m, _, _ in got] == [(n, m) for n, m, _, _ in want]
        for (name, mode, role, y), (_, _, _, y0) in zip(got, want):
            if role == "col":
                m = y.shape[-1]
                y0 = y0[..., r * m: (r + 1) * m]
            assert y.shape == y0.shape, (name, role)
            if mode == Mode.LUT_INFER.value:
                assert np.array_equal(y, y0), (case, r, name, role)
                n_lut[role] += 1
            else:                     # layer 0 stays dense: row partials in another order
                np.testing.assert_allclose(y, y0, rtol=1e-5, atol=1e-5)
    assert n_lut["col"] > 0 and n_lut["row"] > 0


def test_tp2_places_shards_by_the_rules(served):
    ranks = served["kernel"]["ranks"]
    dense = ranks[0]["tp"]["dense"]
    roles = dense["layout"]
    assert roles["segments/1/attn/q"] == "col" and roles["segments/1/attn/o"] == "row"
    assert roles["segments/1/mlp/down"] == "row" and dense["vocab"]
    # qwen3 reduced: 4 heads, 2 KV heads, d_head 32, V 16 -> q's M 128 / 2
    assert dense["param_shapes"]["table_q"][-1] == 64
    assert dense["param_shapes"]["table_scale"] == (1, 1, 64)
    # each rank's dense cache holds its KV head; the paged pool its KV head too
    assert all(shape[3] == 1 for shape in dense["cache"])
    assert all(shape[3] == 1 for shape in ranks[0]["tp"]["paged"]["pool"])
    # the collectives per forward: embedding, o and down per layer, logits
    st = ranks[1]["tp"]["dense"]["stats"]
    forwards = st["prefill_forwards"] + st["decode_forwards"]
    assert forwards > 0 and ranks[1]["tp"]["dense"]["counters"]["all_reduce"] == 6 * forwards


def _launch(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                           *args], capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))


def test_launcher_tp2_serves_the_same_tokens(served):
    art = served["kernel"]["art"]
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                               "--artifact", art, "--requests", "3", "--slots", "2", "--max-seq",
                               "64", "--prefill-chunk", "8", "--max-tokens", "6", *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
             for extra in ([], ["--tp", "2"])]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    reqs = [[ln for ln in out.splitlines() if ln.strip().startswith("req ")] for out, _ in outs]
    assert reqs[0] and reqs[0] == reqs[1]
    assert "tp=2 over gloo" in outs[1][0]


def test_launcher_tp2_http_serves_and_drains(served):
    """HTTP mode over a local pump at tp 2: rank 0 serves /generate, the
    follower runs its forwards; SIGTERM drains and every rank exits."""
    from repro_torch.serving.artifact import load_artifact

    art = served["kernel"]["art"]
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                             "--artifact", art, "--tp", "2", "--port", "0", "--max-seq", "64",
                             "--prefill-chunk", "8"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    try:
        line = proc.stdout.readline()
        assert "tp=2 over gloo" in line, line
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        body = json.dumps({"prompt": [1, 2, 3, 4, 5], "max_tokens": 5}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body), timeout=60) as r:
            got = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    loaded = load_artifact(art, device="cpu", restore_autotune=False)
    eng = ServingEngine(loaded.bundle, loaded.params, n_slots=4, max_seq=64, prefill_chunk=8,
                        autotune_lut=False, device="cpu")
    eng.submit([1, 2, 3, 4, 5], max_tokens=5)
    assert got["status"] == "ok" and got["tokens"] == eng.run_until_done()[0].out_tokens


def _rank_processes(pid: int) -> list[int]:
    """The launcher's spawned rank processes (not multiprocessing's resource
    tracker)."""
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        kids = [int(k) for k in f.read().split()]
    out = []
    for k in kids:
        with open(f"/proc/{k}/cmdline", "rb") as f:
            if b"spawn_main" in f.read():
                out.append(k)
    return out


def test_launcher_tp2_ends_when_a_follower_dies(served, tmp_path):
    """A follower rank that dies ends rank 0's server with exit 1 (its next
    collective could only wait for the dead peer)."""
    err = tmp_path / "stderr.txt"
    with open(err, "w") as ferr:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--device",
                                 "cpu", "--artifact", served["kernel"]["art"], "--tp", "2",
                                 "--port", "0", "--max-seq", "64", "--prefill-chunk", "8"],
                                stdout=subprocess.PIPE, stderr=ferr, text=True,
                                env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    try:
        line = proc.stdout.readline()
        assert "tp=2 over gloo" in line, line
        followers = _rank_processes(proc.pid)
        assert len(followers) == 1
        os.kill(followers[0], signal.SIGKILL)
        assert proc.wait(timeout=60) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "tp rank 1 exited with code -9" in err.read_text()


@pytest.mark.parametrize("extra, why", [
    (["--replicas", "2", "--port", "0"], "--replicas does not compose with --tp > 1"),
    (["--supervise", "--port", "0"], "--supervise does not support --tp > 1 yet"),
    (["--spec-decode"], "--spec-decode does not compose with --tp > 1"),
])
def test_launcher_tp_refusals_exit_2(served, extra, why):
    r = _launch("--artifact", served["kernel"]["art"], "--tp", "2", *extra, timeout=60)
    assert r.returncode == 2 and why in r.stderr


def test_left_out_families_are_refused_with_their_reason():
    """`--tp` refuses the enc-dec and vision-LM families with the engine's
    reason (`engine_refusal`: the engine feeds token ids only), though
    tensor parallelism admits both (`tp_refusal` is None: they serve
    through `ModelBundle.forward_step(mesh=)`,
    tests/test_torch_tp_encdec_vlm.py); it refuses LUT_TRAIN bundles, and
    builds a tensor-parallel engine for the MoE, SSM and hybrid families."""
    for name, why in (("whisper_tiny", "could not run the encoder"),
                      ("qwen2_vl_7b", "could not give this model the embeddings")):
        r = _launch("--tp", "2", "--arch", name, "--layers", "2", "--d-model", "64",
                    "--vocab", "128", timeout=60)
        assert r.returncode == 2 and "not served by ServingEngine" in r.stderr, name
        assert why in r.stderr, name
        bundle = build_model(reduce_arch(get_arch(name), n_layers=2), Mode.LUT_INFER)
        assert tp_refusal(bundle) is None
    train = build_model(reduce_arch(get_arch("mamba2_370m"), n_layers=2), Mode.LUT_TRAIN)
    assert "not LUT_TRAIN" in tp_refusal(train)
    mesh = HostMesh(data=1, model=2, rank=0, device=torch.device("cpu"), backend="gloo")
    for name, kept in (("arctic_480b", "experts_over_model"), ("mamba2_370m", "ssm_heads"),
                       ("zamba2_1p2b", "ssm_heads")):
        bundle = build_model(reduce_arch(get_arch(name), n_layers=2), Mode.LUT_INFER)
        assert tp_refusal(bundle) is None
        eng = ServingEngine(bundle, bundle.init(device="cpu"), mesh=mesh, device="cpu",
                            autotune_lut=False)
        assert eng.layout.kept == (kept,)
    bundle = build_model(reduce_arch(get_arch("qwen3_1p7b"), n_layers=2), Mode.LUT_INFER)
    with pytest.raises(ValueError, match="spec_decode does not compose with mesh"):
        ServingEngine(bundle, bundle.init(device="cpu"), mesh=mesh, device="cpu",
                      autotune_lut=False, spec_decode=True)


def test_backend_follows_the_devices():
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"      # two ranks share one card
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    mesh = HostMesh(data=1, model=2, rank=1, device=torch.device("cpu"), backend="gloo")
    assert mesh.shape == {"data": 1, "model": 2} and mesh.model_rank == 1
