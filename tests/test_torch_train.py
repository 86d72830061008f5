"""The port's training math against the JAX reference, on the same numpy
inputs or the same params carried across: the soft-PQ pieces (Eqs. 5-6,
the table build, fake-quant), the LUT_TRAIN layer, the model's loss and the
gradient of every leaf, one AdamW train step (grad_accum 1 and 2), a short
loss trajectory, and the synthetic data bit for bit.

Small size: d_model 64, 2 layers, vocab 128, seq 16, batch 4, V = 16. All
fp32. Where a hard code differs between the packages (the fp32 distance
expansion sums in another order), it must sit on a near-tie: a relative
distance gap <= TIE_EPS."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.core import amm as jamm
from repro.core import pq as jpq
from repro.core import quant as jquant
from repro.data import MarkovLM as JMarkovLM
from repro.optim import AdamW as JAdamW
from repro.optim import SOFT_PQ_RULES as JRULES
from repro.optim import lut_frozen_mask as jfrozen
from repro.optim.schedule import cosine_with_warmup as jcosine
from repro.train import train_step as jts
from repro_torch import configs as tcfg
from repro_torch.core import amm, pq, quant
from repro_torch.core.temperature import temperature
from repro_torch.data import MarkovLM
from repro_torch.models import common
from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.testing import tie_gaps
from repro_torch.train import train_step as tts
from repro_torch.weights import params_from_numpy, reference_arrays, tree_map_ref

TIE_EPS = 1e-6        # relative distance gap that explains a differing code
FWD_TOL = 1e-5        # fp32 forward values, summed in another order than XLA's
GRAD_RTOL = 1e-4      # a gradient leaf, relative to its largest entry
# log_t's gradient is one sum over every (row, codebook, centroid) of terms
# that cancel: its fp32 rounding error scales with the terms' magnitudes
# (see the LUT_TRAIN layer test). In the model its stacked leaf is held to
# LOG_T_RTOL of itself, in the layer test to LOG_T_TERM_RTOL of its terms.
LOG_T_RTOL = 1e-3
LOG_T_TERM_RTOL = 1e-7
B, S = 4, 16


def _np(t):
    return np.asarray(t)


def _grad_close(got, want, what):
    """|got - want| <= rtol * max|want| (+ a 1e-7 floor for all-zero leaves),
    rtol GRAD_RTOL, or LOG_T_RTOL for a temperature."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-3)
    err = float(np.abs(got - want).max(initial=0.0))
    rtol = LOG_T_RTOL if "log_t" in what else GRAD_RTOL
    assert err <= rtol * scale + 1e-7, f"{what}: max err {err:.3g} vs scale {scale:.3g}"


# ---------------------------------------------------------------------------
# soft-PQ pieces
# ---------------------------------------------------------------------------

def test_temperature_matches_reference():
    from repro.core.temperature import temperature as jtemp

    for lt in (-12.0, -1.5, 0.0, 0.7):
        got = temperature(torch.tensor(lt))
        assert np.float32(got) == np.float32(jtemp(jnp.float32(lt)))


def test_ste_encode_forward_and_gradient_match_reference():
    """Forward: the hard one-hot; gradient w.r.t. the distances and t: the
    softmax's, exactly as the reference's straight-through estimator."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal((12, 5, 16), dtype=np.float32) * 3
    r = rng.standard_normal((12, 5, 16), dtype=np.float32)
    t0 = np.float32(0.7)

    def jloss(dd, tt):
        return jnp.sum(jpq.ste_encode(dd, tt) * r)

    jl, (jgd, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(d), jnp.asarray(t0))
    dt = torch.from_numpy(d).requires_grad_(True)
    tt = torch.tensor(t0).requires_grad_(True)
    enc = pq.ste_encode(dt, tt)
    np.testing.assert_array_equal(enc.detach().numpy(), _np(jpq.hard_encode(jnp.asarray(d))))
    (enc * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(float((enc * torch.from_numpy(r)).sum()), float(jl), rtol=1e-6)
    _grad_close(dt.grad.numpy(), jgd, "d/dists")
    _grad_close(tt.grad.numpy(), jgt, "d/dt")
    soft = pq.soft_encode(torch.from_numpy(d), torch.tensor(t0))
    np.testing.assert_allclose(soft.numpy(), _np(jpq.soft_encode(jnp.asarray(d), t0)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stop", [True, False])
def test_build_table_forward_and_gradient_match_reference(stop):
    """T[c] = P[c] @ W_c; the weight's gradient is stopped by default."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((4, 16, 16), dtype=np.float32)
    w = rng.standard_normal((64, 24), dtype=np.float32)
    r = rng.standard_normal((4, 16, 24), dtype=np.float32)
    jf = lambda pp, ww: jnp.sum(jpq.build_table(pp, ww, stop_weight_grad=stop) * r)  # noqa: E731
    jt = jpq.build_table(jnp.asarray(p), jnp.asarray(w), stop_weight_grad=stop)
    jgp, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(w))
    pt = torch.from_numpy(p).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    t = pq.build_table(pt, wt, stop_weight_grad=stop)
    np.testing.assert_allclose(t.detach().numpy(), _np(jt), rtol=FWD_TOL, atol=FWD_TOL)
    (t * torch.from_numpy(r)).sum().backward()
    _grad_close(pt.grad.numpy(), jgp, "d/P")
    if stop:
        assert wt.grad is None and not np.asarray(jgw).any()
    else:
        _grad_close(wt.grad.numpy(), jgw, "d/W")
    # a stack of layers builds in one call, each layer its own table
    stacked = pq.build_table(torch.stack([pt, 2 * pt]).detach(), torch.stack([wt, wt]).detach())
    np.testing.assert_allclose(stacked[1].numpy(), 2 * t.detach().numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("layout", ["per_codebook", "per_column", "m_shared"])
def test_fake_quant_forward_and_gradient_match_reference(layout):
    """Forward: quantize-dequantize (the same scales and int levels as the
    reference); backward: the identity."""
    kw = {"per_column": layout == "per_column", "m_shared": layout == "m_shared"}
    rng = np.random.default_rng(2)
    t = rng.standard_normal((4, 16, 24), dtype=np.float32)
    r = rng.standard_normal(t.shape, dtype=np.float32)
    jout = jquant.fake_quant(jnp.asarray(t), **kw)
    jg = jax.grad(lambda x: jnp.sum(jquant.fake_quant(x, **kw) * r))(jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_(True)
    out = quant.fake_quant(tt, **kw)
    np.testing.assert_array_equal(out.detach().numpy(), _np(jout))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), _np(jg))
    np.testing.assert_array_equal(tt.grad.numpy(), r)
    # the stacked form quantizes table by table
    two = quant.fake_quant(torch.stack([tt, 3 * tt]).detach(), **kw)
    np.testing.assert_array_equal(two[0].numpy(), out.detach().numpy())


def _site_inputs(seed, n=40, d=64, m=48, k=16, v=16, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    p = rng.standard_normal((d // v, k, v), dtype=np.float32)
    w = rng.standard_normal((d, m), dtype=np.float32) / 8
    b = rng.standard_normal((m,), dtype=np.float32) if bias else None
    return x, p, w, b


@pytest.mark.parametrize("int8_dot", [False, True], ids=["per_codebook", "m_shared"])
def test_lut_linear_train_forward_and_gradients_match_reference(int8_dot, monkeypatch):
    """LUT_TRAIN forward (hard codes through the fake-quantized table) and its
    gradients on x, centroids and log_t. A row whose code differs must be a
    near-tie; such rows are left out of the comparison (their forward and
    every gradient through them differ by design).

    d loss / d log_t = -sum over (n, c, k) of (d loss / d dists) * dists: a
    sum of terms far larger than itself, so fp32 rounding moves it by a
    fraction of its terms' magnitude, not of its value (at seed 3, per
    codebook: float64 -0.124784, the port -0.124754, the reference
    -0.124810, the terms' sum of magnitudes 2271). Its bound is
    LOG_T_TERM_RTOL of that magnitude."""
    cfg_j = jamm.LUTConfig(k=16, v=16, int8_dot=int8_dot)
    cfg_t = amm.LUTConfig(k=16, v=16, int8_dot=int8_dot)
    x, p, w, b = _site_inputs(3)
    log_t = np.float32(-0.4)
    codes_j = np.asarray(jpq.encode_indices(jnp.asarray(x), jnp.asarray(p)))
    codes_t = pq.encode_indices(torch.from_numpy(x), torch.from_numpy(p))
    gaps = tie_gaps(torch.from_numpy(x), torch.from_numpy(p), codes_t, torch.from_numpy(codes_j))
    assert (gaps <= TIE_EPS).all(), f"codes differ off a near-tie: {gaps}"
    keep = (codes_t.numpy() == codes_j).all(axis=1)
    x = x[keep]
    r = np.random.default_rng(4).standard_normal((x.shape[0], 48), dtype=np.float32)

    def jloss(xx, pp, lt):
        y = jamm.lut_linear(cfg_j, jamm.Mode.LUT_TRAIN, {"centroids": pp, "log_t": lt}, xx,
                            frozen={"w": jnp.asarray(w), "b": jnp.asarray(b)})
        return jnp.sum(y * r), y

    (jl, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(log_t))
    terms = []
    real_ste = pq.ste_encode

    def ste(dists, t):                   # records sum |d loss/d dists * dists|
        dists.register_hook(lambda g: terms.append(float((g * dists).abs().sum())))
        return real_ste(dists, t)

    monkeypatch.setattr(pq, "ste_encode", ste)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(p).requires_grad_(True)
    lt = torch.tensor(log_t).requires_grad_(True)
    y = amm.lut_linear(cfg_t, amm.Mode.LUT_TRAIN, {"centroids": pt, "log_t": lt}, xt,
                       frozen={"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=FWD_TOL, atol=FWD_TOL)
    (y * torch.from_numpy(r)).sum().backward()
    _grad_close(xt.grad.numpy(), jg[0], "d/x")
    _grad_close(pt.grad.numpy(), jg[1], "d/centroids")
    assert len(terms) == 1
    err = abs(float(lt.grad) - float(jg[2]))
    assert err <= LOG_T_TERM_RTOL * terms[0], (err, terms[0])


def test_lut_linear_train_needs_the_frozen_weight():
    x, p, _, _ = _site_inputs(5, bias=False)
    with pytest.raises(ValueError, match="frozen"):
        amm.lut_linear(amm.LUTConfig(v=16), amm.Mode.LUT_TRAIN,
                       {"centroids": torch.from_numpy(p), "log_t": torch.tensor(0.0)},
                       torch.from_numpy(x))


def test_pq_reconstruct_matches_reference():
    x, p, _, _ = _site_inputs(6, bias=False)
    np.testing.assert_allclose(
        pq.pq_reconstruct(torch.from_numpy(x), torch.from_numpy(p)).numpy(),
        _np(jpq.pq_reconstruct(jnp.asarray(x), jnp.asarray(p))), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def small_arch(pkg):
    return pkg.reduce_arch(pkg.get_arch("qwen3_1p7b"), d_model=64, n_layers=2, vocab=128,
                           d_ff=128)


@functools.lru_cache(maxsize=None)
def _lut_train_models():
    """LUT_TRAIN bundles of both packages and the reference's init, its
    centroids moved to the activations' scale (where k-means puts them, so
    that the codes spread over the codebook), carried to the port."""
    jb = jcfg.build_model(small_arch(jcfg), "lut_train")
    tb = tcfg.build_model(small_arch(tcfg), "lut_train")
    jp = jax.tree.map(np.array, jax.jit(jb.init)(jax.random.PRNGKey(0)))
    for site in (*jp["segments"][1]["attn"].values(), *jp["segments"][1]["mlp"].values()):
        if "centroids" in site:
            site["centroids"] = site["centroids"] * 40.0
    return jb, jp, tb


def _carry(tb, jp):
    return params_from_numpy(tb, jp, device="cpu")


def _batch(seed=0):
    return JMarkovLM(vocab=128, seq_len=S, batch=B, seed=seed).batch_at(3)


def _min_tie_gap(tb, tp, batch):
    """The smallest relative gap between the best and second-best fp32
    distance of any row at any LUT site of the port's forward. Far above the
    fp32 differences of the two packages' site inputs (about 1e-6 of their
    values), no hard code can differ between them."""
    with common.tape_capture() as tape, torch.no_grad():
        tb.loss(tp, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                compute_dtype=torch.float32)
    gaps = []
    for s in tb.lut_sites():
        site = tp["segments"][int(s.path.split("/")[1])][s.stack_index]
        for part in s.kind.split("/"):
            site = site[part]
        x = tape.records[s.tape_key][0]
        d = pq.pairwise_sq_dists(pq.split_subvectors(x, site["centroids"].shape[-1]),
                                 site["centroids"])
        two = torch.topk(d, 2, dim=-1, largest=False).values
        gaps.append(float(((two[..., 1] - two[..., 0]) / (1.0 + two[..., 0].abs())).min()))
    return min(gaps)


def test_model_loss_and_every_gradient_match_reference():
    """The LUT_TRAIN model's loss and the gradient of every leaf (frozen dense
    weights: zero in both), from the same params and batch; and the same
    values with and without the per-block recomputation (remat)."""
    jb, jp, tb = _lut_train_models()
    tp = _carry(tb, jp)
    batch = _batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jb.loss(p, batch, compute_dtype=jnp.float32)))(
        jax.tree.map(jnp.asarray, jp))
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    def port_grads(bundle):
        frozen = tree_map_ref(lambda _p, _t: False, tp)
        live, leaves = tts.trainable_view(tp, frozen)
        loss = bundle.loss(live, tbatch, compute_dtype=torch.float32)
        return loss, tts.grads_tree(loss, leaves, tp, frozen)

    loss, grads = port_grads(tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = jflatten(jg)
    got = reference_arrays(grads)
    assert sorted(got) == sorted(want)
    for path in want:
        _grad_close(got[path], want[path], path)
    # recomputing each block in backward changes nothing
    import dataclasses
    no_remat = dataclasses.replace(tb, cfg=dataclasses.replace(tb.cfg, remat=False))
    loss2, grads2 = port_grads(no_remat)
    assert float(loss2) == float(loss)
    for path, g in reference_arrays(grads2).items():
        np.testing.assert_array_equal(g, got[path], err_msg=path)
    # no code is near enough to a tie to differ between the packages (a
    # differing code would move the loss and every gradient downstream of it)
    assert _min_tie_gap(tb, tp, batch) > 1e-4


LR_STEP1 = 5e-3              # the cosine schedule below at step 1 (warmup 2)


def _step_pair(grad_accum):
    jb, jp, tb = _lut_train_models()
    jopt = JAdamW(lr=jcosine(1e-2, total_steps=10, warmup_steps=2), rules=JRULES,
                  weight_decay=0.01)
    topt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2),
                 rules=SOFT_PQ_RULES, weight_decay=0.01)
    jmask = jfrozen(jp)
    jstep = jax.jit(jts.make_train_step(jb, jopt, frozen_mask=jmask, compute_dtype=jnp.float32,
                                        grad_accum=grad_accum))
    tp = _carry(tb, jp)
    tmask = lut_frozen_mask(tp)
    tstep = tts.make_train_step(tb, topt, frozen_mask=tmask, compute_dtype=torch.float32,
                                grad_accum=grad_accum)
    jstate = jopt.init(jax.tree.map(jnp.asarray, jp), jmask)
    tstate = topt.init(tp, tmask)
    return (jstep, jax.tree.map(jnp.asarray, jp), jstate), (tstep, tp, tstate)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    """One soft-PQ AdamW step (global-norm clip, bias correction, the
    temperature's 100x lr group, decoupled weight decay, frozen weights
    untouched with empty moments): new params, both moments, the step
    counter and the metrics."""
    (jstep, jp, jstate), (tstep, tp, tstate) = _step_pair(grad_accum)
    batch = _batch(1)
    jp2, jstate2, jm = jstep(jp, jstate, batch)
    tp2, tstate2, tm = tstep(tp, tstate, {k: torch.from_numpy(np.asarray(v))
                                          for k, v in batch.items()})
    for key in ("loss", "grad_norm", "t_mean", "t_min"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    want = jflatten({"params": jp2, "opt": jstate2})
    got = reference_arrays({"params": tp2, "opt": tstate2})
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype and got[path].shape == want[path].shape, path
        if not path.startswith("params/"):
            # the moments carry the (clipped) gradient: its tolerance
            _grad_close(got[path], want[path], path)
            continue
        # Adam moves an element by lr * m/(sqrt(v) + eps), about +-lr at the
        # first step whatever |g| is; where |g| is below 1e-3 of the leaf's
        # largest (the gradients' own tolerance, GRAD_RTOL, is then a large
        # part of it) the direction may differ: hold such an element to one
        # step, 2 * lr * lr_scale, and the others to 1e-4 of the move
        g = want["opt/.m/" + path[len("params/"):]]
        old = np.asarray(jflatten(jp)[path[len("params/"):]])
        if g.shape == (0,):                   # frozen: unchanged, bit for bit
            np.testing.assert_array_equal(got[path], old, err_msg=path)
            continue
        lr_scale = 100.0 if path.endswith("log_t") else 1.0
        step = 2 * LR_STEP1 * lr_scale
        well = np.abs(g) >= 1e-3 * np.abs(g).max()
        err = np.abs(got[path] - want[path])
        assert (err[well] <= 1e-4 * np.abs(want[path] - old)[well] + 1e-7).all(), path
        assert (err[~well] <= step).all(), path
    assert want["opt/.m/segments/1/attn/q/w"].shape == (0,)
    # frozen weights are the very same values, and the caller's tree is unchanged
    np.testing.assert_array_equal(got["params/segments/1/mlp/up/w"],
                                  np.asarray(jp["segments"][1]["mlp"]["up"]["w"]))
    np.testing.assert_array_equal(tp["segments"][1][0]["attn"]["q"]["log_t"].numpy(), 0.0)


def test_five_step_loss_trajectory_matches_reference():
    (jstep, jp, jstate), (tstep, tp, tstate) = _step_pair(1)
    data = JMarkovLM(vocab=128, seq_len=S, batch=B)
    tdata = MarkovLM(vocab=128, seq_len=S, batch=B)
    for i in range(5):
        jp, jstate, jm = jstep(jp, jstate, data.batch_at(i))
        tp, tstate, tm = tstep(tp, tstate, tdata.batch_at(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert int(tstate.step) == int(jstate.step) == 5


def test_distill_loss_matches_reference():
    """(1-w)·CE + w·τ²·KL against the frozen dense teacher, and its parts."""
    jb, jp, tb = _lut_train_models()
    jdb = jcfg.build_model(small_arch(jcfg), "dense")
    tdb = tcfg.build_model(small_arch(tcfg), "dense")
    jdp = jax.tree.map(np.array, jax.jit(jdb.init)(jax.random.PRNGKey(1)))
    spec_j, spec_t = jts.DistillSpec(weight=0.4, temperature=2.0), tts.DistillSpec(0.4, 2.0)
    batch = _batch(2)
    jl, jaux = jts.make_distill_loss_fn(jb, spec_j, jdb, jax.tree.map(jnp.asarray, jdp),
                                        compute_dtype=jnp.float32)(
        jax.tree.map(jnp.asarray, jp), batch)
    tl, taux = tts.make_distill_loss_fn(tb, spec_t, tdb, _carry(tdb, jdp),
                                        compute_dtype=torch.float32)(
        _carry(tb, jp), {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("ce", "distill_kl"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError):
        tts.DistillSpec(weight=1.5)


@pytest.mark.parametrize("cfg", [(128, 16, 4, 0, 8), (151936, 32, 2, 3, 8), (64, 16, 8, 0, 4)],
                         ids=["small", "qwen3_vocab", "branching4"])
def test_markov_batches_bit_equal(cfg):
    """Every batch the reference's MarkovLM gives, bit for bit (the port's
    threefry split/bits/randint), and the same repr (the run fingerprint)."""
    vocab, seq, batch, seed, branching = cfg
    j = JMarkovLM(vocab=vocab, seq_len=seq, batch=batch, seed=seed, branching=branching)
    t = MarkovLM(vocab=vocab, seq_len=seq, batch=batch, seed=seed, branching=branching)
    assert repr(t) == repr(j)
    for step in (0, 1, 10_000, 99_999):
        jb, tb = j.batch_at(step), t.batch_at(step)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=f"{k}@{step}")


def test_lut_train_specs_and_init_follow_the_reference():
    """LUT_TRAIN sites hold w, centroids, log_t (+ b): the same param tree,
    shapes and dtypes as the reference's, and the sites' modes."""
    jb, jp, tb = _lut_train_models()
    want = {p: (a.shape, str(a.dtype)) for p, a in jflatten(jp).items()}
    from repro_torch.checkpoint.paths import flatten_tree
    specs = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
             for p, s in flatten_tree(tb.param_specs()).items()}
    assert specs == want
    init = reference_arrays(tb.init(torch.Generator().manual_seed(0), device="cpu"))
    assert {p: (a.shape, str(a.dtype)) for p, a in init.items()} == want
    assert [s.mode.value for s in tb.sites()] == [s.mode.value for s in jb.sites()]


def test_step_parity_harness_on_the_cpu_with_its_float64_witness():
    """`testing.lut_train_step_parity` (chip_smoke phase 7(a) and the `cuda`
    test run it card against CPU) with the CPU on both sides: no failure, and
    every card-vs-CPU gap within 1e-6 of the leaf's largest entry (the CPU's
    threaded reductions, e.g. the embedding's backward, may add in another
    order from one run to the next). Its float64 witness runs with the CPU's
    fake-quant integers pinned (an entry rounded otherwise must sit at a
    half-integer, counted): the fp32 gradients then lie within 1e-4 of each
    leaf's largest entry from float64's, 1e-3 at the LUT centroids (their
    fp32 distance expansion cancels)."""
    from repro_torch import testing

    arch = tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), d_model=256, n_layers=2, vocab=512,
                            d_ff=512)
    bundle = tcfg.build_model(arch, "lut_train")
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    for site in (*params["segments"][1][0]["attn"].values(),
                 *params["segments"][1][0]["mlp"].values()):
        if "centroids" in site:
            site["centroids"].mul_(40.0)          # at the activations' scale
    opt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2), rules=SOFT_PQ_RULES)
    res = testing.lut_train_step_parity(bundle, params,
                                        MarkovLM(vocab=512, seq_len=64, batch=4).batch_at(0),
                                        "cpu", opt, tie_eps=TIE_EPS)
    assert res["failures"] == [] and res["grad_leaves"] > 0 and res["updated"] > 0
    assert res["rounding_flips"]["card"] == 0 and res["rounded_entries"] > 0
    assert res["log_t_errs"]["card_cpu"] <= 1e-9 and res["log_t_errs"]["cpu_f64"] <= 1e-6
    for leaf, e in res["grad_errs"].items():
        assert e["card_cpu"][1] <= 1e-6, (leaf, e)
        assert e["cpu_f64"][1] <= (1e-3 if "centroids" in leaf else 1e-4), (leaf, e)
