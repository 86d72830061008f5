"""Two repairs of the port's serving front ends.

* An enc-dec or vision-LM artifact is checked before anything spawns: the
  supervisor's parent-side probe applies `engine_refusal` to the manifest's
  arch and fails closed with the reason, spawning no worker; the launcher
  exits 2 with it, in batch mode and under --supervise.
* `--dtype bfloat16` reaches supervised and routed workers: the compute
  dtype travels by name in the engine kwargs, as kv_dtype does. The
  reference's HTTP modes drop it (its launch/serve.py:318-336); the port
  departs from that.
"""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.core.amm import Mode
from repro_torch.serving.artifact import load_artifact, save_artifact
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.supervisor import EngineSupervisor
from tests._subproc import SRC

SMALL = dict(n_layers=2, d_model=64, vocab=128)
ENGINE_KW = dict(n_slots=2, max_seq=64, prefill_chunk=4, device="cpu")
WAIT_S = 120
SPECS = [{"prompt": [i + 1, i + 5, i + 9, 3], "max_tokens": 8} for i in range(4)]


def _artifact(path, name: str, **arch):
    bundle = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch(name), **dict(SMALL, **arch)),
                              Mode.LUT_INFER)
    save_artifact(path, bundle, bundle.init(torch.Generator().manual_seed(0), device="cpu"))
    return path


def _launch(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                           *args], capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=SRC))


@pytest.mark.parametrize("name", ["whisper_tiny", "qwen2_vl_7b"])
def test_refused_family_artifact_never_spawns(tmp_path, name):
    art = _artifact(tmp_path / "art", name, lut_use_kernel=True)
    sup = EngineSupervisor(art, engine_kwargs=ENGINE_KW, max_restarts=5)
    try:
        assert sup.wait_ready(timeout=WAIT_S) and not sup.healthy
        st = sup.stats()
        assert st["spawns"] == 0 and st["failed"] == 1
        with pytest.raises(RuntimeError, match="is not served by ServingEngine"):
            sup.submit({"prompt": [1], "max_tokens": 1})
    finally:
        sup.close()
    for extra in ([], ["--supervise", "--port", "0"]):
        r = _launch("--artifact", str(art), *extra)
        assert r.returncode == 2, (extra, r.stderr)
        assert "is not served by ServingEngine" in r.stderr


def test_supervised_bf16_worker_matches_the_in_process_bf16_engine(tmp_path):
    art = _artifact(tmp_path / "art", "qwen3_1p7b", lut_use_kernel=True)
    loaded = load_artifact(art, device="cpu")
    tokens = {}
    for dtype in ("bfloat16", "float32"):
        eng = ServingEngine(loaded.bundle, loaded.params, compute_dtype=dtype,
                            autotune_lut=False, **ENGINE_KW)
        assert eng._compute_dtype == getattr(torch, dtype)
        for spec in SPECS:
            eng.submit(spec["prompt"], max_tokens=spec["max_tokens"])
        tokens[dtype] = [r.out_tokens for r in sorted(eng.run_until_done(),
                                                     key=lambda r: r.rid)]
    assert tokens["bfloat16"] != tokens["float32"]     # the dtype shows in the tokens
    sup = EngineSupervisor(art, engine_kwargs=dict(ENGINE_KW, compute_dtype="bfloat16"))
    try:
        grids = [sup.submit(spec) for spec in SPECS]
        got = [sup.wait(g, timeout=WAIT_S) for g in grids]
        assert all(st.status == "ok" for st in got)
        assert [list(st.tokens) for st in got] == tokens["bfloat16"]
    finally:
        sup.close()
    with pytest.raises(ValueError, match="compute_dtype='float16'"):
        ServingEngine(loaded.bundle, loaded.params, compute_dtype="float16", **ENGINE_KW)
