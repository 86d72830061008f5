"""Per family (moe, ssm, hybrid, audio enc-dec, vision-LM), the port's
training pipeline against the JAX reference: one AdamW train step, the
k-means activation tape (the expert sites' centroids keep their init in
both packages), Lloyd from the same start, the int8 deploy (bytewise, the
expert axis sharing its codebooks), a trained artifact the port writes,
loaded by the reference, and the step-parity harness on the CPU.

Sizes, inputs and tolerances: tests/test_torch_train_families.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _grad_close
from test_torch_train_families import (  # noqa: F401  (_few_threads: an autouse fixture)
    B,
    EXPERT_KINDS,
    FAMILIES,
    LOGIT_TOL,
    LR_STEP1,
    S,
    TIE_EPS,
    _batch,
    _few_threads,
    _j,
    _models,
    _t,
)

from repro import configs as jcfg
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.core import convert as jconvert
from repro.core import kmeans as jkm
from repro.models import common as jcommon
from repro.optim import AdamW as JAdamW
from repro.optim import SOFT_PQ_RULES as JRULES
from repro.optim import lut_frozen_mask as jfrozen
from repro.optim.schedule import cosine_with_warmup as jcosine
from repro.train import train_step as jts
from repro_torch import configs as tcfg
from repro_torch.core import convert, kmeans
from repro_torch.models import common
from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train import train_step as tts
from repro_torch.weights import params_from_numpy, reference_arrays, tree_map_ref

ROWS_TOL = 1e-5       # tape rows: fp32 forwards (the SSD scan too), summed in another order
CENTROID_TOL = 1e-4   # Lloyd's means of those rows


# ---------------------------------------------------------------------------
# per family: a train step, the tape, Lloyd, deploy, a trained artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_step_matches_reference(name):
    """One soft-PQ AdamW step (clip, bias correction, the temperature's 100x
    lr group, weight decay, the frozen weights with empty moments) against
    the reference's `make_train_step`: metrics, new params, both moments;
    for the vision-LM also grad_accum 2 (M-RoPE's pos splits on its batch
    axis)."""
    jb, jp, tb = _models(name, "lut_train")
    batch = _batch(jb.arch, seed=1)
    for accum in (1, 2) if jb.arch.mrope_sections else (1,):
        jopt = JAdamW(lr=jcosine(1e-2, total_steps=10, warmup_steps=2), rules=JRULES,
                      weight_decay=0.01)
        topt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2),
                     rules=SOFT_PQ_RULES, weight_decay=0.01)
        jmask = jfrozen(jp)
        jstep = jax.jit(jts.make_train_step(jb, jopt, frozen_mask=jmask,
                                            compute_dtype=jnp.float32, grad_accum=accum))
        jparams = jax.tree.map(jnp.asarray, jp)
        jp2, js2, jm = jstep(jparams, jopt.init(jparams, jmask), _j(batch))
        tp = params_from_numpy(tb, jp, device="cpu")
        tmask = lut_frozen_mask(tp)
        tstep = tts.make_train_step(tb, topt, frozen_mask=tmask, compute_dtype=torch.float32,
                                    grad_accum=accum)
        tp2, ts2, tm = tstep(tp, topt.init(tp, tmask), _t(batch))
        for key in ("loss", "grad_norm", "t_mean", "t_min"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        want = jflatten({"params": jp2, "opt": js2})
        got = reference_arrays({"params": tp2, "opt": ts2})
        assert sorted(got) == sorted(want)
        old = jflatten(jp)
        for path in want:
            assert got[path].dtype == want[path].dtype and got[path].shape == want[path].shape
            if not path.startswith("params/"):
                _grad_close(got[path], want[path], path)
                continue
            g = want["opt/.m/" + path[len("params/"):]]
            o = np.asarray(old[path[len("params/"):]])
            if g.shape == (0,):                   # frozen: unchanged, bit for bit
                np.testing.assert_array_equal(got[path], o, err_msg=path)
                continue
            # as test_torch_train's step: an element whose gradient is below
            # 1e-3 of the leaf's largest may move the other way, by one step;
            # p - lr * delta rounds once more (2 ulps of the value)
            # (and so may one whose first moment (1 - b1) g is within 100x of
            # AdamW's eps: m / (sqrt(v) + eps) then turns on g's last digits)
            step = 2 * LR_STEP1 * (100.0 if path.endswith("log_t") else 1.0)
            well = (np.abs(g) >= 1e-3 * np.abs(g).max()) & (np.abs(g) >= 100 * 1e-8)
            err = np.abs(got[path] - want[path])
            ulps = 2 * np.finfo(np.float32).eps * np.abs(want[path])
            # a temperature's gradient is held to LOG_T_RTOL of itself; where
            # it is near AdamW's eps, its move is as sensitive as the gradient
            rel = 1e-3 if path.endswith("log_t") else 1e-4
            assert (err[well] <= rel * np.abs(want[path] - o)[well] + ulps[well] + 1e-7).all(), \
                path
            assert (err[~well] <= step).all(), path


def _dense_pair(name):
    jb, jp, tb = _models(name, "dense")
    return jb, jp, tb, params_from_numpy(tb, jp, device="cpu")


def _sample_batch(arch):
    batch = _batch(arch, seed=2)
    if arch.takes_embeds:
        del batch["pos"]          # kmeans_init builds M-RoPE's streams itself, as the reference
    return batch


@pytest.mark.parametrize("name", FAMILIES)
def test_family_kmeans_tape_and_init_match_reference(name):
    """The tape (dense model, the sample batch of stub frames or embeddings)
    records the same keys, in the same order, and the same rows as the
    reference's unrolled tape; the hybrid's shared block pools its
    invocations under one key. The full k-means init then gives every taped
    LUT site new centroids, and leaves the expert sites' shared centroids at
    their init in both packages (their contraction never records)."""
    jb, jp, tb, tp = _dense_pair(name)
    batch = _sample_batch(jb.arch)
    jbatch = dict(_j(batch))
    if jb.arch.mrope_sections:
        jbatch["pos"] = jnp.broadcast_to(jnp.arange(S)[None, None], (3, B, S))
    with jcommon.tape_capture(max_rows=48) as jt:
        jconvert._unrolled(jb).loss(jax.tree.map(jnp.asarray, jp), jbatch,
                                    compute_dtype=jnp.float32)
    with common.tape_capture(max_rows=48) as tt, torch.no_grad():
        tb.loss(tp, {**_t(batch), **({"pos": torch.from_numpy(np.array(jbatch["pos"]))}
                                     if "pos" in jbatch else {})},
                compute_dtype=torch.float32)
    assert list(tt.records) == list(jt.records)
    for key, rows in tt.records.items():
        assert len(rows) == len(jt.records[key]), key
        for got, want in zip(rows, jt.records[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROWS_TOL,
                                       atol=ROWS_TOL, err_msg=key)
    if jb.kind == "hybrid":
        assert len(tt.records["shared/attn/q"]) == len(tb.cfg.invocation_points) == 2

    jbl = jcfg.build_model(jb.arch, "lut_train")
    tbl = tcfg.build_model(tb.arch, "lut_train")
    jlut = jconvert.graft_dense_to_lut(jax.tree.map(jnp.asarray, jp),
                                       jbl.init(jax.random.PRNGKey(5)))
    tlut = params_from_numpy(tbl, jax.tree.map(np.array, jlut), device="cpu")
    assert sorted(reference_arrays(convert.graft_dense_to_lut(tp, tlut))) == sorted(
        jflatten(jlut))
    tout = convert.kmeans_init_lut(tb, tp, tbl, tlut, [_t(batch)],
                                   torch.Generator().manual_seed(1), kmeans_iters=2,
                                   max_rows=48)
    before, tafter = jflatten(jlut), reference_arrays(tout)
    if tbl.arch.n_experts:
        jafter = jflatten(jconvert.kmeans_init_lut(
            jb, jax.tree.map(jnp.asarray, jp), jbl, jlut, [_j(batch)], jax.random.PRNGKey(1),
            kmeans_iters=2, max_rows=48))
    taped = {s.path for s in tbl.lut_sites() if s.tape_key is not None}
    n = 0
    for s in tbl.lut_sites():
        path = s.path + "/centroids"
        if s.kind in EXPERT_KINDS:
            np.testing.assert_array_equal(np.asarray(jafter[path]), np.asarray(before[path]))
            np.testing.assert_array_equal(tafter[path], np.asarray(before[path]))
            n += 1
        else:
            assert s.path in taped
            assert not np.array_equal(tafter[path], np.asarray(before[path])), path
    assert n == (3 * (tbl.arch.n_layers - 1) if tbl.arch.n_experts else 0)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_lloyd_matches_reference_from_the_same_start(name, monkeypatch):
    """Lloyd on a taped site's per-codebook problems (the first LUT site's
    inputs under the dense model) from the same start, the first K rows:
    the port's batched Lloyd against the reference's, problem by problem."""
    jb, jp, tb, tp = _dense_pair(name)
    tbl = tcfg.build_model(tb.arch, "lut_train")
    with common.tape_capture() as tt, torch.no_grad():
        tb.loss(tp, _t(_sample_batch(jb.arch)), compute_dtype=torch.float32)
    by_site = {(s.layer, s.kind): s for s in tbl.lut_sites()}
    site = next(s for s in tb.sites() if s.tape_key in tt.records
                and (s.layer, s.kind) in by_site)
    lut = by_site[(site.layer, site.kind)].lut
    acts = torch.cat(tt.records[site.tape_key])
    x = acts.reshape(acts.shape[0], -1, lut.v).transpose(0, 1)[:2].contiguous()   # 2 problems
    init = x[:, : lut.k].clone()
    got, inertia = kmeans.kmeans(None, x, k=lut.k, iters=10, init=init)
    for i in range(x.shape[0]):
        monkeypatch.setattr(jkm, "kmeans_plusplus",
                            lambda key, xx, kk, i=i: jnp.asarray(init[i].numpy()))
        want, winertia = jkm.kmeans.__wrapped__(jax.random.PRNGKey(0), jnp.asarray(x[i].numpy()),
                                                k=lut.k, iters=10)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=CENTROID_TOL,
                                   atol=CENTROID_TOL, err_msg=f"{site.tape_key} problem {i}")
        # a problem of fewer rows than K ends at an inertia of rounding size
        floor = 1e-4 * float((x[i] ** 2).sum(-1).mean())
        np.testing.assert_allclose(float(inertia[i]), float(winertia), rtol=1e-4, atol=floor)


def _half_integer_flips(got, want, t_over_s):
    """Entries of two int8 tables that differ, each of which must be one step
    off at a quotient within 1e-4 of a half-integer."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    off = diff != 0
    frac = np.abs(np.abs(t_over_s) - np.floor(np.abs(t_over_s)) - 0.5)
    assert (np.abs(diff[off]) == 1).all() and (frac[off] <= 1e-4).all()
    return int(off.sum())


@pytest.mark.parametrize("name", FAMILIES)
def test_family_deploy_matches_reference_bytewise(name):
    """LUT_TRAIN params carried across, deployed by both packages: the same
    tree, every leaf bytewise equal, table_q and table_scale included (an
    expert site's (E, C, K, F) tables from the codebooks its experts share,
    each expert on its own scale). Entries rounded otherwise at a
    half-integer are counted: 0 at this seed."""
    jb, jp, tb = _models(name, "lut_train")
    jbi, jip = jconvert.deploy_lut_train_params(jb, jax.tree.map(jnp.asarray, jp))
    tbi, tip = convert.deploy_lut_train_params(tb, params_from_numpy(tb, jp, device="cpu"))
    assert [(s.path, s.mode.value) for s in tbi.sites()] == \
        [(s.path, s.mode.value) for s in jbi.sites()]
    want, got, src = jflatten(jip), reference_arrays(tip), jflatten(jp)
    assert list(got) == list(want)
    flips = 0
    for path, w in want.items():
        w = np.asarray(w)
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        if path.endswith("table_q"):
            base = path[: -len("/table_q")]
            p, wt = src[base + "/centroids"].astype(np.float64), src[base + "/w"]
            c, k, v = p.shape[-3:]
            lead = wt.shape[:-2]
            t = np.einsum("...ckv,...cvm->...ckm", p[:, None] if wt.ndim == 4 else p,
                          wt.reshape(*lead, c, v, -1).astype(np.float64))
            flips += _half_integer_flips(got[path], w, t / np.asarray(want[base + "/table_scale"]))
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    assert flips == 0
    if tb.arch.n_experts:
        assert got["segments/1/moe/down/table_q"].shape[1:3] == (4, tb.arch.d_ff // 16)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_trained_artifact_loads_in_the_reference(tmp_path, name):
    """A soft-PQ step by the port, deployed and written as a LUTArtifact by
    the port; the reference's loader reads it and its forward gives the
    port's logits (1e-5) on the family's batch: the same int8 tables and
    centroids, so the same lookups."""
    from repro.serving import artifact as jart
    from repro_torch.serving import artifact as tart

    _, jp, tb = _models(name, "lut_train")
    tp = params_from_numpy(tb, jp, device="cpu")
    mask = lut_frozen_mask(tp)
    opt = AdamW(lr=1e-3, rules=SOFT_PQ_RULES)
    tp, _, _ = tts.make_train_step(tb, opt, frozen_mask=mask, compute_dtype=torch.float32)(
        tp, opt.init(tp, mask), _t(_batch(tb.arch, seed=3)))
    tbi, tip = convert.deploy_to_artifact(tb, tp, tmp_path / "art")
    jl = jart.load_artifact(tmp_path / "art")
    assert jl.bundle.arch.name == name and jl.bundle.mode.value == "lut_infer"
    batch = _batch(tb.arch, seed=4)
    with torch.no_grad():
        got, _ = tbi.train_logits(tip, _t(batch), compute_dtype=torch.float32)
    want, _ = jax.jit(lambda p, b: jl.bundle.train_logits(p, b, compute_dtype=jnp.float32))(
        jl.params, _j(batch))
    # logits within 1e-5: no code differs between the packages (a flipped code
    # would move them by a table entry)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    back = tart.load_artifact(tmp_path / "art", device="cpu")
    np.testing.assert_array_equal(reference_arrays(back.params)["embed/table"],
                                  reference_arrays(tip)["embed/table"])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_step_parity_harness_on_the_cpu(name):
    """`testing.lut_train_step_parity` (chip_smoke phase 10(a) and the
    `cuda` test run it card against CPU) on each family with the CPU on both
    sides: no failure, no code or fake-quant entry the "card" side takes
    from the CPU's; the expert tables' entries are among the rounded ones;
    the MoE aux value is checked."""
    from repro_torch import testing

    _, jp, tb = _models(name, "lut_train")
    tp = params_from_numpy(tb, jp, device="cpu")
    opt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2), rules=SOFT_PQ_RULES)
    batch = _t(_batch(tb.arch, seed=5))
    res = testing.lut_train_step_parity(tb, tp, batch, "cpu", opt, tie_eps=TIE_EPS)
    assert res["failures"] == [] and res["grad_leaves"] > 0 and res["updated"] > 0
    assert res["rounding_flips"]["card"] == 0 and res["rounded_entries"] > 0
    assert res["pinned_codes"]["card"] == 0 and res["codes"] > 0
    if tb.arch.n_experts:
        assert res["aux_cpu"] > 0 and res["aux_dev"] == pytest.approx(res["aux_cpu"], rel=1e-6)
    else:
        assert res["aux_cpu"] == res["aux_dev"] == 0.0




@pytest.mark.parametrize("name", FAMILIES)
def test_family_lut_train_trees_carry_across_bytewise(name):
    """A LUT_TRAIN tree in bfloat16 params (the expert sites' frozen `w`,
    fp32 centroids and log_t beside it) carried from the reference's layout
    to the port's and back: every leaf's bytes, dtype and path unchanged,
    and the port's specs and lut_frozen_mask agree with the reference's."""
    from repro_torch.checkpoint.paths import flatten_tree
    from repro_torch.weights import params_to_numpy

    ja = jcfg.reduce_arch(jcfg.get_arch(name), param_dtype="bfloat16")
    ta = tcfg.reduce_arch(tcfg.get_arch(name), param_dtype="bfloat16")
    jb, tb = jcfg.build_model(ja, "lut_train"), tcfg.build_model(ta, "lut_train")
    jp = jax.tree.map(np.asarray, jax.jit(jb.init)(jax.random.PRNGKey(2)))
    tp = params_from_numpy(tb, jp, device="cpu")
    want = {p: (a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
            for p, a in jflatten(jp).items()}
    got = flatten_tree(params_to_numpy(tb, tp))
    assert list(got) == list(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype and got[path].tobytes() == a.tobytes(), path
    specs = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
             for p, s in flatten_tree(tb.param_specs()).items()}
    assert specs == {p: (a.shape, str(a.dtype)) for p, a in jflatten(jp).items()}
    mask = reference_arrays(tree_map_ref(lambda _p, f: torch.tensor(f), lut_frozen_mask(tp)))
    assert {p: bool(np.all(a)) for p, a in mask.items()} == \
        {p: bool(np.all(np.asarray(a))) for p, a in jflatten(jfrozen(jp)).items()}
