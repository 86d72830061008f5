"""The port's training pipeline against the JAX reference: k-means, the
dense -> LUT conversion (tape rows, graft, centroids), the int8 deploy
(trained plan and a sub-plan, and its errors), checkpoints, recipes and run
manifests read across the two packages, the launcher's --dump-recipe, the
trainer's failure policy, the Eval gate, kill-and-resume mid soft-PQ, and an
artifact the port trains served alike by both engines.

Small size: d_model 64, 2 layers, vocab 128, seq 16, batch 4, V = 16 (the
recipe runs use the reference test's d_model 48)."""

import dataclasses
import functools
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.core import convert as jconvert
from repro.core import kmeans as jkm
from repro.data import MarkovLM as JMarkovLM
from repro.models import common as jcommon
from repro.optim import AdamW as JAdamW
from repro.optim import SOFT_PQ_RULES as JRULES
from repro.optim import lut_frozen_mask as jfrozen
from repro.train import recipe as jrecipe
from repro_torch import configs as tcfg
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import convert, kmeans
from repro_torch.data import MarkovLM
from repro_torch.distributed.fault_tolerance import HeartbeatFile, StragglerMonitor
from repro_torch.models import common
from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
from repro_torch.train import recipe as trecipe
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.weights import params_from_numpy, reference_arrays, tree_map_ref

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
ROWS_TOL = 1e-5       # tape rows: fp32 forwards, summed in another order than XLA's
CENTROID_TOL = 1e-4   # Lloyd's means of those rows, 25 iterations


def small_arch(pkg, **kw):
    return pkg.reduce_arch(pkg.get_arch("qwen3_1p7b"), d_model=64, n_layers=2, vocab=128,
                           d_ff=128, **kw)


@functools.lru_cache(maxsize=None)
def _dense():
    """The reference's dense init in both packages' layouts."""
    jb = jcfg.build_model(small_arch(jcfg), "dense")
    tb = tcfg.build_model(small_arch(tcfg), "dense")
    jp = jax.tree.map(np.array, jax.jit(jb.init)(jax.random.PRNGKey(0)))
    return jb, jp, tb


@functools.lru_cache(maxsize=None)
def _lut_train():
    """LUT_TRAIN params of the reference (init, centroids at the activations'
    scale), for the deploy tests."""
    jb = jcfg.build_model(small_arch(jcfg), "lut_train")
    tb = tcfg.build_model(small_arch(tcfg), "lut_train")
    jp = jax.tree.map(np.array, jax.jit(jb.init)(jax.random.PRNGKey(3)))
    for site in (*jp["segments"][1]["attn"].values(), *jp["segments"][1]["mlp"].values()):
        if "centroids" in site:
            site["centroids"] = site["centroids"] * 40.0
    return jb, jp, tb


def _clusters(seed, b=3, n=240, v=8, k=8):
    """b problems of n points around k well-separated centers."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((b, k, v), dtype=np.float32) * 6
    ids = rng.integers(0, k, (b, n))
    x = centers[np.arange(b)[:, None], ids] + rng.standard_normal((b, n, v), dtype=np.float32)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def test_lloyd_matches_reference_from_the_same_init(monkeypatch):
    """Lloyd, batched over the problems, against the reference's Lloyd on
    each problem from the same starting centers (the reference takes its
    start from kmeans_plusplus, replaced here by those centers); empty
    clusters reseed at the worst-represented point in both."""
    x = _clusters(0)
    k = 8
    init = x[:, :k].copy()                # the first k points: some clusters start empty
    got, inertia = kmeans.kmeans(None, torch.from_numpy(x), k=k, iters=25,
                                 init=torch.from_numpy(init))
    for i in range(x.shape[0]):
        monkeypatch.setattr(jkm, "kmeans_plusplus", lambda key, xx, kk, i=i: jnp.asarray(init[i]))
        want, winertia = jkm.kmeans.__wrapped__(jax.random.PRNGKey(0), jnp.asarray(x[i]), k=k,
                                                iters=25)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=CENTROID_TOL,
                                   atol=CENTROID_TOL, err_msg=f"problem {i}")
        np.testing.assert_allclose(float(inertia[i]), float(winertia), rtol=1e-4)


def test_kmeans_plusplus_seeds_as_well_as_the_reference():
    """The port's seeding draws from a torch generator, not the reference's
    keys: its centers differ, its quality may not. Over 10 seeds on 4
    codebooks of clustered points, the mean inertia of the seeds and of the
    final centroids is within 10% of the reference's (or below)."""
    x = _clusters(1, b=4)
    acts = np.concatenate(list(x), axis=1)                 # (N, C*V): C = 4 codebooks
    sub = torch.from_numpy(x)

    def inertia(c):
        return float(kmeans._sq_dists(sub, torch.as_tensor(np.asarray(c))).min(-1).values.sum())

    jseed = jax.jit(jax.vmap(lambda key, xx: jkm.kmeans_plusplus(key, xx, 8)))
    seeds, finals = [], []
    for s in range(10):
        seeds.append((inertia(kmeans.kmeans_plusplus(torch.Generator().manual_seed(s), sub, 8)),
                      inertia(jseed(jax.random.split(jax.random.PRNGKey(s), 4),
                                    jnp.asarray(x)))))
        got = kmeans.kmeans_per_codebook(torch.Generator().manual_seed(s),
                                         torch.from_numpy(acts), k=8, v=8)
        want = jkm.kmeans_per_codebook(jax.random.PRNGKey(s), jnp.asarray(acts), k=8, v=8)
        assert got.shape == want.shape == (4, 8, 8)
        finals.append((inertia(got), inertia(want)))
    for what, pairs in (("seeds", seeds), ("k-means", finals)):
        mine, theirs = np.mean(pairs, axis=0)
        assert mine <= 1.1 * theirs, (what, mine, theirs)
    again = kmeans.kmeans_per_codebook(torch.Generator().manual_seed(9), torch.from_numpy(acts),
                                       k=8, v=8)
    assert torch.equal(got, again)                          # deterministic per seed


# ---------------------------------------------------------------------------
# conversion and deploy
# ---------------------------------------------------------------------------

def test_convert_tape_rows_graft_and_centroids():
    """The tape records the same rows per site key as the reference's
    (unrolled) tape; the graft copies every dense leaf; each LUT site's
    centroids are the port's k-means of those rows."""
    jb, jp, tb = _dense()
    batch = JMarkovLM(vocab=128, seq_len=16, batch=4).batch_at(10_000)
    with jcommon.tape_capture(max_rows=48) as jt:
        jconvert._unrolled(jb).loss(jp, batch, compute_dtype=jnp.float32)
    tp = params_from_numpy(tb, jp, device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with common.tape_capture(max_rows=48) as tt, torch.no_grad():
        tb.loss(tp, tbatch, compute_dtype=torch.float32)
    assert list(tt.records) == list(jt.records)
    for key, rows in tt.records.items():
        assert rows[0].shape == (48, rows[0].shape[1])
        np.testing.assert_allclose(rows[0].numpy(), np.asarray(jt.records[key][0]),
                                   rtol=ROWS_TOL, atol=ROWS_TOL, err_msg=key)

    blut, lp = convert.convert_dense_to_lut_train(tb, tp, [tbatch],
                                                  torch.Generator().manual_seed(1),
                                                  kmeans_iters=10, max_rows=48)
    assert blut.mode.value == "lut_train"
    flat = reference_arrays(lp)
    dense = jflatten(jp)
    np.testing.assert_array_equal(flat["embed/table"], dense["embed/table"])
    np.testing.assert_array_equal(flat["segments/1/attn/q/w"],
                                  dense["segments/0/attn/q/w"][1:])      # layer 1, frozen
    np.testing.assert_array_equal(flat["segments/0/mlp/down/w"], dense["segments/0/mlp/down/w"][:1])
    gen = torch.Generator().manual_seed(1)
    dense_sites = {s.tape_key: s for s in tb.sites()}
    by_site = {(s.layer, s.kind): s for s in blut.lut_sites()}
    n = 0
    for key in jt.records:                # joined on (layer, kind), in the tape's order
        ds = dense_sites[key]
        if (ds.layer, ds.kind) not in by_site:
            continue                      # layer 0 stays dense
        rows = torch.from_numpy(np.array(jt.records[key][0]))
        want = kmeans.kmeans_per_codebook(gen, rows, k=16, v=16, iters=10)
        path = by_site[(ds.layer, ds.kind)].path + "/centroids"
        np.testing.assert_allclose(flat[path][0], want.numpy(), rtol=CENTROID_TOL,
                                   atol=CENTROID_TOL, err_msg=key)
        n += 1
    assert n == 7 and flat["segments/1/attn/q/log_t"].tolist() == [0.0]


def _table_q_close(got, want, t_over_s, what):
    """Equal, or off by one where |T/scale| lies within 1e-4 of a
    half-integer (round-half-to-even on a quotient an ulp apart)."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    off = diff != 0
    frac = np.abs(np.abs(t_over_s) - np.floor(np.abs(t_over_s)) - 0.5)
    assert (np.abs(diff[off]) == 1).all() and (frac[off] <= 1e-4).all(), what
    return int(off.sum())


@pytest.mark.parametrize("plan", ["trained", "keeping_dense_attn"])
def test_deploy_matches_reference(plan):
    """LUT_TRAIN params carried across, deployed by both packages under the
    trained plan and under keeping_dense("attn/*"): the same tree; dense and
    centroid leaves bit for bit; table_scale within 1e-6 relative; table_q
    equal, except |delta| = 1 where |T/scale| is within 1e-4 of a
    half-integer. At this seed every leaf comes out bytewise equal (the
    count of off-by-one entries is asserted 0)."""
    jb, jp, tb = _lut_train()
    tp = params_from_numpy(tb, jp, device="cpu")
    jplan = None if plan == "trained" else jcfg.effective_plan(jb.arch).keeping_dense("attn/*")
    tplan = None if plan == "trained" else tcfg.effective_plan(tb.arch).keeping_dense("attn/*")
    jbi, jip = jconvert.deploy_lut_train_params(jb, jax.tree.map(jnp.asarray, jp), plan=jplan)
    tbi, tip = convert.deploy_lut_train_params(tb, tp, plan=tplan)
    assert [s.mode.value for s in tbi.sites()] == [s.mode.value for s in jbi.sites()]
    want = jflatten(jip)
    got = reference_arrays(tip)
    assert list(got) == list(want)
    off = 0
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        if path.endswith("table_scale"):
            np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=0, err_msg=path)
        elif path.endswith("table_q"):
            base = path[: -len("/table_q")]
            p, wt = jflatten(jp)[base + "/centroids"], jflatten(jp)[base + "/w"]
            c, k, v = p.shape[1:]
            t = np.einsum("lckv,lcvm->lckm", p.astype(np.float64),
                          wt.reshape(wt.shape[0], c, v, -1).astype(np.float64))
            off += _table_q_close(got[path], w, t / want[base + "/table_scale"], path)
        else:
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    assert off == 0
    if plan != "trained":
        assert "segments/1/attn/q/w" in got and "segments/1/attn/q/table_q" not in got


def test_deploy_errors_match_reference():
    """A plan that replaces a site the trained plan kept dense, or asks for
    another K, has no centroids to build from: ValueError in both."""
    jb, jp, tb = _lut_train()
    sub = dataclasses.replace(tb.arch, lut_plan=tcfg.effective_plan(tb.arch).keeping_dense(
        "attn/*"))
    tsub = tcfg.build_model(sub, "lut_train")
    tparams = tsub.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="keeping_dense"):
        convert.deploy_lut_train_params(tsub, tparams, plan=tcfg.effective_plan(tb.arch))
    tp = params_from_numpy(tb, jp, device="cpu")
    k8 = tcfg.LUTPlan.all_but_first(k=8, v=16, bits=8, per_column=False, int8_dot=False,
                                    use_kernel=False)
    jk8 = jcfg.LUTPlan.all_but_first(k=8, v=16, bits=8, per_column=False, int8_dot=False,
                                     use_kernel=False)
    with pytest.raises(ValueError, match="centroids"):
        convert.deploy_lut_train_params(tb, tp, plan=k8)
    with pytest.raises(ValueError, match="centroids"):
        jconvert.deploy_lut_train_params(jb, jax.tree.map(jnp.asarray, jp), plan=jk8)


# ---------------------------------------------------------------------------
# checkpoints, recipes and run manifests across the packages
# ---------------------------------------------------------------------------

def _states():
    """One AdamW step's train state in both packages (same values)."""
    jb, jp, tb = _lut_train()
    tp = params_from_numpy(tb, jp, device="cpu")
    jmask, tmask = jfrozen(jp), lut_frozen_mask(tp)
    jopt, topt = JAdamW(lr=1e-2, rules=JRULES), AdamW(lr=1e-2, rules=SOFT_PQ_RULES)
    jparams = jax.tree.map(jnp.asarray, jp)
    jgrads = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype), jparams)
    _, jstate, _ = jopt.update(jgrads, jopt.init(jparams, jmask), jparams, jmask)
    tgrads = tree_map_ref(lambda _p, t, fz: None if fz else torch.full_like(t, 0.5), tp, tmask)
    _, tstate, _ = topt.update(tgrads, topt.init(tp, tmask), tp, tmask)
    return {"params": jparams, "opt": jstate}, {"params": tp, "opt": tstate}


def test_checkpoints_restore_across_the_packages(tmp_path):
    """Params and AdamW state (empty moments of the frozen weights
    included) written by either package restore in the other, bit for bit,
    under the reference's paths."""
    jtree, ttree = _states()
    want = jflatten(jtree)
    assert {p: (a.shape, a.dtype) for p, a in reference_arrays(ttree).items()} == \
        {p: (a.shape, a.dtype) for p, a in want.items()}

    Checkpointer(tmp_path / "port", keep_last=1).save(7, ttree, blocking=True)
    step, back = JCheckpointer(tmp_path / "port").restore(jtree)
    assert step == 7
    for p, a in jflatten(back).items():
        np.testing.assert_array_equal(np.asarray(a), reference_arrays(ttree)[p], err_msg=p)
    manifest = json.loads((tmp_path / "port" / "step_00000007" / "manifest.json").read_text())
    assert list(manifest["leaves"]) == list(want)

    JCheckpointer(tmp_path / "ref").save(3, jtree, blocking=True)
    ck = Checkpointer(tmp_path / "ref")
    step, back = ck.restore(ttree)
    assert step == 3 == ck.latest_step()
    got = reference_arrays(back)
    for p, a in want.items():
        np.testing.assert_array_equal(got[p], a, err_msg=p)
    assert back["opt"].m["segments"][1][0]["attn"]["q"]["w"].shape == (0,)


def test_checkpointer_commits_atomically_and_keeps_last(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=2)
    tree = {"params": {"embed": {"table": torch.arange(6.0).reshape(2, 3)}}}
    commits = []
    for s in (1, 2, 3):
        ck.save(s, tree, on_commit=commits.append)
    ck.wait()
    assert ck.all_steps() == [2, 3] and commits == [1, 2, 3]
    (tmp_path / "step_00000009.tmp").mkdir()          # a crash mid-write is never read
    assert ck.latest_step() == 3
    _, back = ck.restore(tree)
    assert torch.equal(back["params"]["embed"]["table"], tree["params"]["embed"]["table"])
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(tree)


def test_recipe_json_loads_across_the_packages(tmp_path):
    for kw in ({}, {"spec_draft": "attn/*", "distill_weight": 0.3, "eval_max_regression": 0.5,
                    "steps": 12, "artifact_dir": "/x/art"}, {"lut": False}):
        jr = jrecipe.default_recipe(**kw)
        tr = trecipe.default_recipe(**kw)
        assert tr.to_dict() == jr.to_dict() and tr.describe() == jr.describe()
        assert trecipe.Recipe.from_json(jr.to_json()).to_dict() == jr.to_dict()
        assert jrecipe.Recipe.from_json(tr.to_json()).to_dict() == jr.to_dict()
    tr.save(tmp_path / "r.json")
    assert jrecipe.Recipe.load(tmp_path / "r.json").to_dict() == tr.to_dict()
    with pytest.raises(trecipe.RecipeError, match="requires an earlier"):
        trecipe.Recipe(stages=(trecipe.SoftPQ(),)).validate()
    with pytest.raises(trecipe.RecipeError, match="unknown rule set"):
        trecipe.OptimSpec(rules="nope")
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        trecipe.DensePretrain(grad_compression=True)
    with pytest.raises(trecipe.RecipeError, match="grad_accum"):
        trecipe.DensePretrain(grad_accum=2, grad_compression=True)


def _dense_only(pkg):
    return pkg.Recipe(stages=(pkg.DensePretrain(steps=2, ckpt_every=1, log_every=0),))


def test_run_manifest_and_stage_checkpoints_resume_across_the_packages(tmp_path, capsys):
    """A run one package finished is "already done" for the other, whose
    restore gives the same params: the recipe_run.json (arch, seed, data
    fingerprint, stage status) and the stage checkpoints are the same
    format. A different seed is refused by both."""
    jarch, tarch = small_arch(jcfg), small_arch(tcfg)
    jdata, tdata = JMarkovLM(vocab=128, seq_len=16, batch=4), MarkovLM(vocab=128, seq_len=16,
                                                                        batch=4)
    jres = _dense_only(jrecipe).run(jarch, jdata, ckpt_dir=tmp_path / "ref", verbose=False)
    tres = _dense_only(trecipe).run(tarch, tdata, ckpt_dir=tmp_path / "ref", device="cpu")
    assert "[dense] already done — restored" in capsys.readouterr().out
    assert tres.histories == {}
    want = jflatten(jax.tree.map(np.asarray, jres.dense_params))
    for p, a in reference_arrays(tres.dense_params).items():
        np.testing.assert_array_equal(a, want[p], err_msg=p)
    with pytest.raises(trecipe.RecipeError, match="DIFFERENT seed"):
        _dense_only(trecipe).run(tarch, tdata, ckpt_dir=tmp_path / "ref", seed=1, device="cpu")

    tres = _dense_only(trecipe).run(tarch, tdata, ckpt_dir=tmp_path / "port", device="cpu",
                                    verbose=False)
    manifest = json.loads((tmp_path / "port" / "recipe_run.json").read_text())
    assert manifest["data"] == repr(jdata) and manifest["stages"][0]["step"] == 2
    jres = _dense_only(jrecipe).run(jarch, jdata, ckpt_dir=tmp_path / "port", verbose=False)
    got = reference_arrays(tres.dense_params)
    for p, a in jflatten(jax.tree.map(np.asarray, jres.dense_params)).items():
        np.testing.assert_array_equal(a, got[p], err_msg=p)
    with pytest.raises(jrecipe.RecipeError, match="DIFFERENT data"):
        _dense_only(jrecipe).run(jarch, JMarkovLM(vocab=128, seq_len=8, batch=4),
                                 ckpt_dir=tmp_path / "port", verbose=False)


def test_dump_recipe_of_both_launchers_is_equal(tmp_path, capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    args = ["--lut", "--steps", "30", "--spec-draft", "attn/*", "--distill-weight", "0.2",
            "--ckpt-dir", str(tmp_path / "ck")]
    jtrain.main(args + ["--dump-recipe", str(tmp_path / "j.json")])
    ttrain.main(args + ["--dump-recipe", str(tmp_path / "t.json")])
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[1] == out[0].replace("j.json", "t.json")


def test_launcher_runs_on_the_cpu_only_when_asked(tmp_path, capsys):
    """`--device cpu` runs the pipeline with the reference's summary lines;
    without it, on a machine with no card, it raises (no silent fallback)."""
    from repro_torch.launch import train as ttrain

    args = ["--lut", "--d-model", "32", "--layers", "2", "--vocab", "64", "--seq", "8",
            "--batch", "4", "--steps", "2", "--ckpt-dir", str(tmp_path / "ck")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(args)
    ttrain.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "replacement plan: [lut@all_but_first] default K=16 V=16 b8" in out
    assert "recipe: dense[2] -> centroid_init -> soft_pq[2] -> deploy -> eval" in out
    assert "[eval] deployed INT8 LUT eval loss:" in out
    assert f"wrote LUTArtifact to {tmp_path / 'ck'}_artifact" in out


# ---------------------------------------------------------------------------
# the trainer's failure policy
# ---------------------------------------------------------------------------

def _toy_trainer(tmp_path, **kw):
    def step_fn(params, opt, batch):
        w = params["embed"]["table"] + batch
        return {"embed": {"table": w}}, opt, {"loss": w.sum(), "grad_norm": torch.tensor(0.0)}

    cfg = TrainerConfig(total_steps=6, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=0)
    return Trainer(step_fn=step_fn, batch_at=lambda s: torch.tensor(float(s)), cfg=cfg, **kw)


def test_trainer_retries_restores_and_gives_up_like_the_reference(tmp_path):
    start = ({"embed": {"table": torch.zeros(())}}, {"x": torch.zeros(())})
    clean, _ = _toy_trainer(tmp_path / "a").fit(*start)
    assert float(clean["embed"]["table"]) == 15.0          # 0 + 1 + ... + 5
    # a transient fault within the StepGuard's retries
    p, _ = _toy_trainer(tmp_path / "b", fail_at=3, fail_times=2).fit(*start)
    assert float(p["embed"]["table"]) == 15.0
    # retries exhausted at step 3: restore the step-2 commit and replay
    t = _toy_trainer(tmp_path / "c", fail_at=3, fail_times=3)
    p, _ = t.fit(*start)
    assert float(p["embed"]["table"]) == 15.0
    assert [h["step"] for h in t.history] == [0, 1, 2, 2, 3, 4, 5]
    # nothing committed yet: re-raise
    with pytest.raises(RuntimeError):
        _toy_trainer(tmp_path / "d", fail_at=1, fail_times=10).fit(*start)
    # a deterministic fault: re-raise after max_restores
    with pytest.raises(RuntimeError):
        _toy_trainer(tmp_path / "e", fail_at=3, fail_times=100).fit(*start)
    # a programming error is not retried
    with pytest.raises(ValueError):
        _toy_trainer(tmp_path / "f", fail_at=0, fail_exc=ValueError("shape")).fit(*start)
    # a new trainer on the same directory resumes from the last commit
    t = _toy_trainer(tmp_path / "a")
    assert t.resume(*start)[0] == 6


def test_straggler_monitor_and_heartbeat_match_reference(tmp_path):
    from repro.distributed.fault_tolerance import StragglerMonitor as JStraggler

    times = [1.0, 1.1, 0.9, 1.0, 1.0, 3.5, 1.0, 1.2, 2.5, 0.8]
    j, t = JStraggler(), StragglerMonitor()
    assert [t.record(i, s) for i, s in enumerate(times)] == \
        [j.record(i, s) for i, s in enumerate(times)]
    assert t.events == j.events and t.ema == j.ema
    hb = HeartbeatFile(tmp_path / "hb" / "beat.json")
    hb.beat(4, loss=1.5)
    rec = json.loads((tmp_path / "hb" / "beat.json").read_text())
    assert rec["step"] == 4 and rec["loss"] == 1.5


# ---------------------------------------------------------------------------
# whole runs of the port's recipe
# ---------------------------------------------------------------------------

def tiny_arch():
    return tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2, vocab=64, d_model=48,
                            d_ff=96)


def tiny_recipe(art_dir, *, eval_max_loss=None):
    R = trecipe
    return R.Recipe(stages=(
        R.DensePretrain(steps=2, ckpt_every=3, log_every=0),
        R.CentroidInit(sample_batches=1, sample_start=500, max_rows=512),
        R.SoftPQ(steps=2, ckpt_every=3, log_every=0,
                 optim=R.OptimSpec(lr=1e-3, schedule="cosine", warmup_steps=2, rules="soft_pq")),
        R.Deploy(artifact_dir=str(art_dir)),
        R.Eval(batch_step=999, max_loss=eval_max_loss),
    )).validate()


def test_eval_gate_retracts_the_artifact_and_resumes_in_place(tmp_path):
    arch = tiny_arch()
    data = MarkovLM(vocab=arch.vocab, seq_len=16, batch=8, branching=4)
    with pytest.raises(trecipe.RecipeError, match="eval gate"):
        tiny_recipe(tmp_path / "art", eval_max_loss=0.01).run(
            arch, data, ckpt_dir=tmp_path / "run", verbose=False, device="cpu")
    manifest = json.loads((tmp_path / "run" / "recipe_run.json").read_text())
    by_name = {e["name"]: e for e in manifest["stages"]}
    assert by_name["eval"]["status"] == "failed" and "eval gate" in by_name["eval"]["result"][
        "error"]
    assert by_name["soft_pq"]["status"] == "done"
    assert not (tmp_path / "art" / "manifest.json").exists()       # retracted
    relaxed = tiny_recipe(tmp_path / "art", eval_max_loss=100.0)
    res = relaxed.run(arch, data, ckpt_dir=tmp_path / "run", verbose=False, device="cpu")
    assert res.stage_result("eval")["deployed_loss"] <= 100.0 and res.histories == {}
    assert (tmp_path / "art" / "manifest.json").exists()           # deployed again


def test_artifact_trained_by_the_port_serves_alike_in_both_engines(tmp_path):
    """The port's recipe writes the artifact; the reference's loader and
    engine and the port's serve it with the same greedy tokens."""
    from repro.serving import artifact as jart
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro_torch.serving import artifact as tart
    from repro_torch.serving.engine import ServingEngine

    arch = tiny_arch()
    data = MarkovLM(vocab=arch.vocab, seq_len=16, batch=8, branching=4)
    tiny_recipe(tmp_path / "art").run(arch, data, ckpt_dir=tmp_path / "run", verbose=False,
                                      device="cpu")
    manifest = json.loads((tmp_path / "art" / "manifest.json").read_text())
    assert manifest["recipe"] == tiny_recipe(tmp_path / "art").to_dict()
    jl, tl = jart.load_artifact(tmp_path / "art"), tart.load_artifact(tmp_path / "art",
                                                                       device="cpu")
    engine = dict(n_slots=2, max_seq=32, prefill_chunk=4)
    prompts = [[5, 9, 2], [11, 3, 8, 13, 21, 34, 1, 7], [40, 41, 42, 43, 44], [2, 4, 6]]
    outs = []
    for eng in (JServingEngine(jl.bundle, jl.params, **engine),
                ServingEngine(tl.bundle, tl.params, device="cpu", **engine)):
        for p in prompts:
            eng.submit(p, max_tokens=6)
        outs.append([r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)])
    assert outs[0] == outs[1] and all(len(t) == 6 for t in outs[0])


_CHILD = r"""
import json, os, signal, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch, reduce_arch
from repro_torch.data import MarkovLM
from repro_torch.train.recipe import (CentroidInit, Deploy, DensePretrain, Eval, Recipe,
                                      SoftPQ)

kill_at_call, ckpt_dir, out_json = int(sys.argv[1]), sys.argv[2], sys.argv[3]
arch = reduce_arch(get_arch("qwen3_1p7b"), n_layers=2, vocab=64, d_model=48, d_ff=96)
base = MarkovLM(vocab=arch.vocab, seq_len=16, batch=8, branching=4)

calls = {"n": 0}
class KillingData:
    def batch_at(self, step):
        calls["n"] += 1
        if kill_at_call >= 0 and calls["n"] >= kill_at_call:
            os.kill(os.getpid(), signal.SIGKILL)   # hard kill, no cleanup
        return base.batch_at(step)

recipe = Recipe(stages=(
    DensePretrain(steps=8, ckpt_every=4, log_every=0),
    CentroidInit(sample_batches=1, sample_start=500, max_rows=512),
    SoftPQ(steps=10, ckpt_every=3, log_every=0),
    Deploy(artifact_dir=ckpt_dir + "/art"),
    Eval(batch_step=999),
)).validate()
res = recipe.run(arch, KillingData(), ckpt_dir=ckpt_dir, verbose=False, device="cpu")
out = {
    "dense_steps": [h["step"] for h in res.histories.get("dense", [])],
    "softpq_steps": [h["step"] for h in res.histories.get("soft_pq", [])],
    "softpq_final_loss": res.stage_result("soft_pq")["final_loss"],
    "eval_loss": res.stage_result("eval")["deployed_loss"],
    "stages": [[e["name"], e["status"], e["step"]] for e in res.manifest["stages"]],
}
with open(out_json, "w") as f:
    json.dump(out, f)
"""


def _run_child(tmp_path, name, kill_at_call, ckpt_dir, *, expect_kill):
    out_json = tmp_path / f"{name}.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(kill_at_call), str(ckpt_dir),
                           str(out_json)], env=env, capture_output=True, text=True, timeout=300)
    if expect_kill:
        assert proc.returncode == -signal.SIGKILL, f"not killed:\n{proc.stdout}\n{proc.stderr}"
        assert not out_json.exists()
        return None
    assert proc.returncode == 0, f"child failed:\n{proc.stdout}\n{proc.stderr}"
    return json.loads(out_json.read_text())


def test_kill_mid_softpq_resumes_at_stage_and_step(tmp_path):
    """SIGKILL the port's pipeline mid soft-PQ (as tests/test_recipe.py does
    the reference's); the same invocation resumes at the recorded stage and
    committed step, never from 0, to a loss bit-equal to an uninterrupted
    run's. Calls of batch_at: dense steps 1-8, the centroid sample 9,
    soft-PQ from 10, so call 16 is soft-PQ step 6 (after the step-3 commit,
    the step-6 commit racing the kill)."""
    ref = _run_child(tmp_path, "ref", -1, tmp_path / "ref_run", expect_kill=False)
    _run_child(tmp_path, "killed", 16, tmp_path / "kill_run", expect_kill=True)
    manifest = json.loads((tmp_path / "kill_run" / "recipe_run.json").read_text())
    by_name = {e["name"]: e for e in manifest["stages"]}
    assert by_name["dense"]["status"] == "done"
    assert by_name["soft_pq"]["status"] == "running" and by_name["soft_pq"]["step"] in (3, 6)
    resumed = _run_child(tmp_path, "resumed", -1, tmp_path / "kill_run", expect_kill=False)
    assert resumed["dense_steps"] == []
    assert resumed["softpq_steps"][0] > 0 and resumed["softpq_steps"][0] == \
        min(resumed["softpq_steps"])
    assert dict((n, s) for n, s, _ in resumed["stages"])["eval"] == "done"
    assert float(resumed["softpq_final_loss"]).hex() == float(ref["softpq_final_loss"]).hex()
    assert float(resumed["eval_loss"]).hex() == float(ref["eval_loss"]).hex()
