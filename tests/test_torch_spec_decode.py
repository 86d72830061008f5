"""The port's speculative decoding against the JAX reference: port spec ==
port plain == reference spec tokens, and equal spec_* counters, with a
divergent draft, a self-draft, paged rollback, sampled requests, per-request
opt-out and a two-plan artifact's draft plan; the errors; the counters in
stats(); and the launcher's paged and spec summary lines.

Same seeded inputs through both packages; the reference's LUT sites run
Pallas in interpret mode, the port's the plain versions of its kernels."""

import functools
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import convert
from repro.core.amm import Mode as JMode
from repro.serving import artifact as jart
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import configs as tcfg
from repro_torch.kernels import counters
from repro_torch.serving import artifact
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.weights import params_from_numpy

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [11, 12], [20, 21, 22, 23]]
MAX_TOK = 6
ENGINE = dict(n_slots=2, max_seq=32, prefill_chunk=4, autotune_lut=False)
SPEC_KEYS = ("spec_rounds", "spec_slot_rounds", "spec_draft_forwards", "spec_prefill_forwards",
             "spec_verify_forwards", "spec_catchup_forwards", "spec_tokens_proposed",
             "spec_tokens_accepted", "spec_bonus_tokens", "spec_tokens_emitted",
             "spec_pages_rewound", "spec_gamma", "spec_acceptance_rate",
             "target_forwards_per_token")
FORWARD_KEYS = ("steps", "prefill_forwards", "prefill_tokens", "decode_forwards",
                "decode_tokens", "completed", "shape_cache_hits")


@functools.lru_cache(maxsize=None)
def _models():
    """Reduced qwen3_1p7b in LUT_INFER in both packages, the target from
    PRNGKey(0) and a divergent draft (same arch, PRNGKey(9)), carried over
    as numpy. Callers never write params."""
    kw = dict(n_layers=2, d_model=64, vocab=128, d_ff=128, lut_use_kernel=True)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    out = [jb, tb]
    for key in (0, 9):
        jp = jb.init(jax.random.PRNGKey(key))
        out += [jp, params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")]
    return tuple(out)             # jb, tb, jparams, tparams, jdraft, tdraft


def _serve(eng, sampling=None, spec_flags=None):
    for i, p in enumerate(PROMPTS):
        flag = None if spec_flags is None else spec_flags[i]
        eng.submit(p, max_tokens=MAX_TOK, sampling=sampling, spec_decode=flag)
    done = sorted(eng.run_until_done(max_steps=2000), key=lambda r: r.rid)
    assert all(r.status == "ok" for r in done), done
    return [r.out_tokens for r in done], eng.stats()


def _three(spec_kw, *, sampled=False, spec_flags=None, draft=False, **kw):
    """(port spec, port plain, reference spec) tokens and the two spec
    engines' stats. `draft`: the divergent draft; else a self-draft."""
    jb, tb, jparams, tparams, jdraft, tdraft = _models()
    tsamp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=42) if sampled else None
    jsamp = JSamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=42) if sampled else None
    tdkw = dict(draft_bundle=tb, draft_params=tdraft) if draft else {}
    jdkw = dict(draft_bundle=jb, draft_params=jdraft) if draft else {}
    counters.reset()
    tspec, ts = _serve(ServingEngine(tb, tparams, device="cpu", **ENGINE, **spec_kw, **tdkw,
                                     **kw), tsamp, spec_flags)
    tplain, _ = _serve(ServingEngine(tb, tparams, device="cpu", **ENGINE, **kw), tsamp)
    jspec, js = _serve(JServingEngine(jb, jparams, **ENGINE, **spec_kw, **jdkw, **kw), jsamp,
                       spec_flags)
    assert sum(counters.launches().values()) == 0        # the CPU: plain versions only
    return (tspec, tplain, jspec), ts, js


def _assert_counters_equal(ts, js, keys=SPEC_KEYS + FORWARD_KEYS):
    for key in keys:
        assert ts[key] == js[key], (key, ts[key], js[key])


CASES = {
    "divergent": dict(draft=True),
    "self_draft": dict(),
    "paged_rewind": dict(draft=True, paged=True, page_size=4),
    "sampled": dict(draft=True, sampled=True),
    "sampled_paged": dict(sampled=True, paged=True, page_size=4),
    "opt_out": dict(spec_flags=[False, None, False, None]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_matches_plain_and_reference(case):
    kw = dict(CASES[case])
    (tspec, tplain, jspec), ts, js = _three(dict(spec_decode=True, spec_gamma=3), **kw)
    assert tspec == tplain == jspec
    _assert_counters_equal(ts, js)
    assert ts["spec_tokens_proposed"] > 0
    if kw.get("draft") and not kw.get("sampled"):
        # the divergent draft is rejected, so the rollback really runs
        assert ts["spec_tokens_accepted"] < ts["spec_tokens_proposed"]
    if case == "self_draft":
        assert ts["target_forwards_per_token"] < 1.0 and ts["spec_bonus_tokens"] > 0
        assert ts["spec_catchup_forwards"] > 0
    if case == "paged_rewind":
        assert ts["spec_pages_rewound"] > 0
        _assert_counters_equal(ts, js, ("cow_copies", "kv_pages_peak", "prefix_hits", "shed"))


def test_spec_errors_match_reference():
    jb, tb, jparams, tparams, _, tdraft = _models()
    plain = ServingEngine(tb, tparams, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="spec_decode"):
        plain.submit([1, 2], max_tokens=2, spec_decode=True)
    plain.submit([1, 2], max_tokens=2, spec_decode=False)      # opting out is always legal
    assert all(r.status == "ok" for r in plain.run_until_done())
    small = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                              d_model=64, vocab=64, d_ff=128,
                                              lut_use_kernel=True), "lut_infer")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tb, tparams, device="cpu", **ENGINE, spec_decode=True, draft_bundle=small,
                      draft_params=small.init(torch.Generator().manual_seed(1), device="cpu"))
    with pytest.raises(ValueError, match="draft"):
        ServingEngine(tb, tparams, device="cpu", **ENGINE, spec_decode=True, draft_bundle=tb)
    with pytest.raises(ValueError, match="spec_gamma"):
        ServingEngine(tb, tparams, device="cpu", **ENGINE, spec_decode=True, spec_gamma=0)
    with pytest.raises(ValueError, match="spec_gamma"):
        JServingEngine(jb, jparams, **ENGINE, spec_decode=True, spec_gamma=0)
    # speculation turns prefix sharing off, as in the reference
    eng = ServingEngine(tb, tparams, device="cpu", **ENGINE, spec_decode=True, paged=True,
                        page_size=4, draft_bundle=tb, draft_params=tdraft)
    jeng = JServingEngine(jb, jparams, **ENGINE, spec_decode=True, paged=True, page_size=4)
    assert not eng.pool.prefix_sharing and not jeng.pool.prefix_sharing


def test_stats_counters_flow_and_reset():
    _, tb, _, tparams, _, _ = _models()
    eng = ServingEngine(tb, tparams, device="cpu", **ENGINE, spec_decode=True, spec_gamma=2)
    eng.submit([1, 2, 3], max_tokens=4)
    eng.run_until_done(max_steps=2000)
    st = eng.stats()
    assert set(SPEC_KEYS) <= set(st)
    # prefill samples token 1 of 4; the spec rounds emit the other three
    assert st["spec_tokens_emitted"] == st["decode_tokens"] == 3
    eng.reset_stats()
    st2 = eng.stats()
    assert st2["spec_rounds"] == 0 and st2["spec_tokens_emitted"] == 0


def _two_plan_setup(key):
    """The reference's two-plan deployment (tests/test_torch_artifact.py):
    one LUT_TRAIN state deployed as the full plan ('draft') and its
    attn-kept-dense sub-plan ('target')."""
    arch = jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), n_layers=2, d_model=64, vocab=128,
                            d_ff=128)
    blut = jcfg.build_model(arch, JMode.LUT_TRAIN)
    lparams = blut.init(jax.random.PRNGKey(key))
    trained = jcfg.effective_plan(arch)
    tb, tp = convert.deploy_lut_train_params(blut, lparams, plan=trained.keeping_dense("attn/*"))
    db, dp = convert.deploy_lut_train_params(blut, lparams, plan=trained)
    return (tb, tp), (db, dp)


def test_two_plan_artifact_draft_served_alike(tmp_path):
    """A two-plan artifact the reference wrote, served with draft_plan="draft"
    by both engines (the port loads the draft plan itself): equal tokens and
    spec counters, and equal to the port's plain decode."""
    (jtb, jtp), (jdb, jdp) = _two_plan_setup(0)
    jart.save_artifact(tmp_path / "art", jtb, jtp, extra_plans={"draft": (jdb, jdp)})
    target = artifact.load_artifact(tmp_path / "art", device="cpu")
    draft = artifact.load_artifact(tmp_path / "art", plan="draft", restore_autotune=False,
                                   device="cpu")
    assert draft.bundle.lut_sites() and len(draft.bundle.lut_sites()) > \
        len(target.bundle.lut_sites())
    jt = jart.load_artifact(tmp_path / "art")
    jd = jart.load_artifact(tmp_path / "art", plan="draft", restore_autotune=False)
    spec = dict(spec_decode=True, spec_gamma=3)
    tspec, ts = _serve(ServingEngine(target.bundle, target.params, device="cpu", **ENGINE, **spec,
                                     draft_bundle=draft.bundle, draft_params=draft.params))
    tplain, _ = _serve(ServingEngine(target.bundle, target.params, device="cpu", **ENGINE))
    jspec, js = _serve(JServingEngine(jt.bundle, jt.params, **ENGINE, **spec,
                                      draft_bundle=jd.bundle, draft_params=jd.params))
    assert tspec == tplain == jspec
    _assert_counters_equal(ts, js)


def test_launcher_paged_spec_lines_match_reference(capsys):
    """`--paged --spec-decode --kv-dtype float8_e4m3fn` on the CPU: the pool
    and spec summary lines name the same counters as the reference's."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    args = ["--requests", "3", "--slots", "2", "--max-tokens", "6", "--layers", "2",
            "--d-model", "64", "--vocab", "128", "--max-seq", "64", "--prefill-chunk", "8",
            "--use-kernel", "--paged", "--page-size", "8", "--spec-decode", "--spec-gamma", "3",
            "--kv-dtype", "float8_e4m3fn"]
    serve.main(["--device", "cpu", *args])
    port = capsys.readouterr().out
    jserve.main(args)
    ref = capsys.readouterr().out

    def line(out, tag):
        found = [ln for ln in out.splitlines() if ln.strip().startswith(tag)]
        assert len(found) == 1, out
        return re.sub(r"\d+(\.\d+)?", "#", found[0])          # the names, not the numbers

    for tag in ("pool:", "spec:"):
        assert line(port, tag) == line(ref, tag)
    assert "kernel launches: fused_decode=0" in port and "3 requests, 18 tokens" in port
