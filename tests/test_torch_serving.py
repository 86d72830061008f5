"""The port's serving slice against the JAX reference engine, and the port's
isolation from JAX and from the reference package."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs as tcfg
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.kernels import ref
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.weights import params_from_numpy

# prompts straddle the chunk of 4: inside one chunk, exactly two, and three
PROMPTS = [[5, 9, 2], [11, 3, 8, 13, 21, 34, 1, 7], [40, 41, 42, 43, 44, 45, 46, 47, 48]]
ENGINE = dict(n_slots=2, max_seq=32, prefill_chunk=4)


def _port_model(n_layers=2):
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=n_layers,
                                           lut_use_kernel=True), "lut_infer")
    return tb, tb.init(torch.Generator().manual_seed(0), device="cpu")


def _models(n_layers=3):
    kw = dict(lut_use_kernel=True, n_layers=n_layers)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tb, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def test_engine_matches_reference_engine():
    jb, jparams, tb, tparams = _models()
    jeng = JServingEngine(jb, jparams, **ENGINE)
    teng = ServingEngine(tb, tparams, device="cpu", **ENGINE)
    fused_mod.launches = v2_mod.launches = 0
    for eng in (jeng, teng):
        for p in PROMPTS:
            eng.submit(p, max_tokens=5)
    jdone = sorted(jeng.run_until_done(), key=lambda r: r.rid)
    tdone = sorted(teng.run_until_done(), key=lambda r: r.rid)
    # greedy tokens identical: same params, same codes, logits equal to float
    # rounding, and no near-tie between the top two logits here
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert [r.status for r in tdone] == ["ok"] * 3
    js, ts = jeng.stats(), teng.stats()
    for key in ("prefill_forwards", "decode_forwards", "prefill_tokens", "decode_tokens",
                "completed", "steps"):
        assert ts[key] == js[key], key
    assert fused_mod.launches == 0 and v2_mod.launches == 0     # CPU: plain versions


def test_engine_never_runs_on_the_cpu_silently():
    tb, tparams = _port_model()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tb, tparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.init(torch.Generator().manual_seed(0))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])


def test_engine_refuses_what_is_not_ported():
    """Sampled requests are served (and replay: the draw is keyed on the
    request's seed and token index only); paged KV, speculative decoding and
    fault injection construct (the injector's hook runs once per step),
    mesh sharding is still refused."""
    tb, tparams = _port_model()
    outs = []
    for first in ("sampled", "greedy"):
        eng = ServingEngine(tb, tparams, device="cpu", **ENGINE)
        reqs = {"sampled": SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=3),
                "greedy": SamplingParams(temperature=0.0)}
        order = [first, "greedy" if first == "sampled" else "sampled"]
        rids = {name: eng.submit([1, 2, 7, 9, 4], max_tokens=6, sampling=reqs[name])
                for name in order}
        done = {r.rid: r for r in eng.run_until_done()}
        assert all(r.status == "ok" and len(r.out_tokens) == 6 for r in done.values())
        outs.append({name: done[rid].out_tokens for name, rid in rids.items()})
    assert outs[0] == outs[1]            # same tokens in either slot placement
    for kw in ({"paged": True}, {"spec_decode": True}):
        eng = ServingEngine(tb, tparams, device="cpu", **ENGINE, **kw)
        assert eng.paged == bool(kw.get("paged")) and (eng.spec is not None) == ("spec_decode" in kw)
    from repro_torch.serving.faults import FaultInjector, FaultSpec
    inj = FaultInjector(FaultSpec())
    eng = ServingEngine(tb, tparams, device="cpu", faults=inj, **ENGINE)
    eng.submit([1, 2, 3], max_tokens=2)
    eng.run_until_done()
    assert eng.faults is inj and inj.calls == eng.stats()["steps"] > 0
    with pytest.raises(NotImplementedError):
        ServingEngine(tb, tparams, device="cpu", mesh=object())


def test_engine_lifecycle_cancel_deadline_and_exhaustion():
    tb, tparams = _port_model()
    eng = ServingEngine(tb, tparams, device="cpu", **ENGINE)
    a = eng.submit([1, 2, 3], max_tokens=8)
    b = eng.submit([4, 5], max_tokens=8, deadline_s=0.0)
    eng.submit([6], max_tokens=40)          # capped at max_seq - len(prompt) + 1
    assert eng.cancel(a)
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.run_until_done(max_steps=2)
    status = {r.rid: r.status for r in eng.run_until_done(on_exhausted="strand",
                                                          max_steps=100)}
    assert status[a] == "cancelled" and status[b] == "timeout" and status[2] == "ok"
    assert len(eng.finished[-1].out_tokens) == 32

    # bounded queue: past max_queue the lowest priority is shed, arrivals lose ties
    eng = ServingEngine(tb, tparams, device="cpu", max_queue=1, **ENGINE)
    low = eng.submit([1], priority=0)
    tie = eng.submit([2], priority=0)
    high = eng.submit([3], priority=1)
    assert {r.rid: r.status for r in eng.finished} == {tie: "shed", low: "shed"}
    assert [r.rid for r in eng.queue] == [high]


def test_warmup_and_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "3", "--slots", "2", "--max-tokens", "4",
                "--layers", "2", "--use-kernel"])
    out = capsys.readouterr().out
    assert "3 requests" in out and "decode:" in out
    assert "kernel launches: fused_decode=0 lut_amm_v2=0" in out


def test_serve_launcher_serves_an_artifact(tmp_path, capsys):
    """--artifact takes arch, plan and mode from the manifest; the summary
    names the source, the shapes tuned and the version per site."""
    from repro.serving.artifact import save_artifact
    from repro_torch.launch import serve

    jb, jparams, _, _ = _models(n_layers=2)
    save_artifact(tmp_path / "art", jb, jparams)
    serve.main(["--artifact", str(tmp_path / "art"), "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-tokens", "4", "--temperature", "0.8", "--top-k", "50",
                "--top-p", "0.9", "--seed", "5", "--no-warmup"])
    out = capsys.readouterr().out
    assert f"artifact {tmp_path / 'art'} (qwen3_1p7b)" in out and "3 requests, 12 tokens" in out
    assert "8 LUT shapes autotuned" in out
    assert "kernel version per site (M, C, K, V) at N=[2, 64]: (128, 8, 16, 16): [3, 3]" in out


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "train = ['repro_torch.train.recipe', 'repro_torch.launch.train',\n"
        "         'repro_torch.core.convert', 'repro_torch.core.kmeans']\n"
        "assert all(n in sys.modules for n in train), train\n"
        "print(sum(n.startswith('repro_torch.') for n in sys.modules), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20 and bad.strip() == "[]"
    assert ref.ACTIVATIONS == ("none", "relu", "silu", "gelu", "relu2")
