"""The port's Mamba-2 (SSD) block and the ssm family (mamba2_370m) against
the JAX reference, from the same numpy inputs and params; and the chunked
prefill where the reference is wrong (ROADMAP, known reference faults): the
port carries each row's state across prefill chunks and stops it at the
row's last valid token, and is held there against the reference's one-call
forward over the whole prompt."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import mamba2 as jmamba
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs as tcfg
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.transformer import zeros_like_specs
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_numpy

ATOL = RTOL = 1e-4          # the port's model tolerance (tests/test_torch_model.py)
TOKEN_TIE = 1e-3            # top-2 logit gap of the reference under which a token may differ
ENGINE = dict(n_slots=2, max_seq=32, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _bundles(mode, use_kernel=True, n_layers=2):
    """Reduced mamba2_370m (ssd_chunk 8) in both packages, the reference's
    params in both layouts. Cached: callers never write to params."""
    kw = dict(n_layers=n_layers, lut_use_kernel=use_kernel)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("mamba2_370m"), **kw), mode)
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("mamba2_370m"), **kw), mode)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL, **kw)


@pytest.mark.parametrize("s,chunk", [(16, 8), (12, 8), (5, 8)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    """y and the final state, with and without an initial state; the chunk
    length is the largest Q <= chunk dividing S (12 -> 6, 5 -> 5)."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a = -rng.uniform(1.0, 8.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, h, n), dtype=np.float32)
    h0 = rng.standard_normal((b, h, p, n), dtype=np.float32) if with_h0 else None
    jy, jh = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=chunk,
                                h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tmamba.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk=chunk,
                                h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and th.shape == (b, h, p, n)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("mode", ["dense", "lut_infer"])
def test_mamba2_prefill_and_decode_match_reference(mode):
    """One mamba2 block: a prefill with a cache, then two O(1) decode steps;
    outputs and both cache leaves (conv window in the cache dtype, fp32 SSM
    state) as the reference leaves them."""
    jb, jp, tb, tp = _bundles(mode)
    jcfg_m, tcfg_m = jb.cfg.segments[-1][1].mamba, tb.cfg.segments[-1][1].mamba
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][-1]["mamba"])
    tlayer = tp["segments"][-1][0]["mamba"]
    rng = np.random.default_rng(3)
    b, d = 2, jcfg_m.d_model
    jcache = jmamba.mamba2_init_cache(b, jcfg_m, jnp.float32)
    tcache = zeros_like_specs(tmamba.mamba2_cache_specs(b, tcfg_m, torch.float32))
    cache_len = torch.zeros(b, dtype=torch.long)
    for s in (8, 1, 1):
        x = rng.standard_normal((b, s, d), dtype=np.float32)
        jy, jcache = jmamba.mamba2(jcfg_m, jlayer, jnp.asarray(x), cache=jcache)
        ty = tmamba.mamba2(tcfg_m, tlayer, torch.from_numpy(x), cache=tcache, cache_len=cache_len)
        _close(ty, jy, err_msg=f"s={s}")
        for name in ("conv", "ssm"):
            assert tcache[name].dtype == torch.float32
            _close(tcache[name], jcache[name], err_msg=f"{name} after s={s}")
        cache_len = cache_len + s


def _ref_one_call(jb, jp, prompt, n_new):
    """The reference's one-call forward over the whole unpadded prompt (the
    path its test_decode_matches_full trusts), then greedy decode steps:
    (tokens, top-2 logit gap at each)."""
    cache = jb.init_caches(1, ENGINE["max_seq"], dtype=jnp.float32)
    toks, cache_len = np.asarray([prompt], np.int32), np.zeros((1,), np.int32)
    out, gaps = [], []
    for _ in range(n_new):
        logits, cache = jb.forward_step(jp, {"tokens": jnp.asarray(toks),
                                             "cache_len": jnp.asarray(cache_len)},
                                        cache, compute_dtype=jnp.float32)
        last = np.asarray(logits)[0, -1]
        top2 = np.sort(last)[-2:]
        out.append(int(last.argmax()))
        gaps.append(float(top2[1] - top2[0]))
        cache_len = cache_len + toks.shape[1]
        toks = np.asarray([[out[-1]]], np.int32)
    return out, gaps


def _match_to_first_tie(got, want, gaps):
    """Equal, or equal up to a first difference where the reference's top-2
    gap is a near-tie."""
    j = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert j is None or gaps[j] <= TOKEN_TIE, (got, want, gaps)


def test_engine_one_chunk_prompts_equal_the_reference_engine():
    """Prompts of exactly one prefill chunk (where the reference's chunked
    prefill is right), three requests on two slots (a slot reused after a
    request retires): the same greedy tokens through both engines."""
    jb, jp, tb, tp = _bundles("lut_infer")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, tb.arch.vocab, 8).tolist() for _ in range(3)]
    outs = []
    for eng in (JServingEngine(jb, jp, **ENGINE), ServingEngine(tb, tp, device="cpu", **ENGINE)):
        for p in prompts:
            eng.submit(p, max_tokens=5)
        outs.append([r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)])
    assert outs[0] == outs[1]


def test_multichunk_and_ragged_prompts_equal_the_one_call_forward():
    """Prompts of two full chunks, ragged over two chunks, ragged inside one
    and as short as the conv window's tail (the reference's one-call forward
    takes no shorter one), four requests on two slots: the port's engine
    gives the reference's one-call forward's tokens."""
    jb, jp, tb, tp = _bundles("lut_infer", use_kernel=False)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, tb.arch.vocab, n).tolist() for n in (16, 11, 5, 3)]
    eng = ServingEngine(tb, tp, device="cpu", **ENGINE)
    for p in prompts:
        eng.submit(p, max_tokens=4)
    got = [r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)]
    for p, g in zip(prompts, got):
        _match_to_first_tie(g, *_ref_one_call(jb, jp, p, 4))


def test_reference_engine_chunked_prefill_fault_and_the_port():
    """The known reference fault (src/repro/models/mamba2.py:181-195): a
    2-chunk prompt through the reference engine restarts the SSM state and
    conv window at the second chunk, and its tokens differ from the
    reference's own one-call forward; the port's engine gives the one-call
    forward's tokens."""
    jb, jp, tb, tp = _bundles("lut_infer", use_kernel=False)
    prompt = np.random.default_rng(5).integers(1, tb.arch.vocab, 16).tolist()
    want, gaps = _ref_one_call(jb, jp, prompt, 4)
    outs = []
    for eng in (JServingEngine(jb, jp, **ENGINE), ServingEngine(tb, tp, device="cpu", **ENGINE)):
        eng.submit(prompt, max_tokens=4)
        outs.append(eng.run_until_done()[0].out_tokens)
    assert outs[0] != want
    _match_to_first_tie(outs[1], want, gaps)


def test_state_rows_outside_the_forward_stay_untouched():
    """A forward that may write only row 1 (write_rows, write_len) changes no
    conv or ssm entry of row 0, at prefill and at decode; a row whose
    cache_len is 0 starts from zeros whatever its state held."""
    _, _, tb, tp = _bundles("dense")
    caches = tb.init_caches(2, 16, dtype=torch.float32, device="cpu")
    for seg in caches:
        seg["conv"][:, 0] = 3.0
        seg["ssm"][:, 0] = 5.0
    toks = torch.full((2, 8), 7, dtype=torch.int32)
    batch = {"cache_len": torch.tensor([0, 0]), "write_rows": torch.tensor([1]),
             "write_len": torch.tensor([0, 6])}
    tb.forward_step(tp, dict(batch, tokens=toks), caches)
    for s, cl in ((1, [0, 6]), (1, [0, 7])):
        tb.forward_step(tp, dict(batch, tokens=toks[:, :s], cache_len=torch.tensor(cl),
                                 write_len=torch.tensor([0, 1])), caches)
    for seg in caches:
        assert (seg["conv"][:, 0] == 3.0).all() and (seg["ssm"][:, 0] == 5.0).all()
        assert seg["ssm"][:, 1].abs().sum() > 0
    # row 0 restarting at cache_len 0 gives row 1's fresh result
    fresh = tb.init_caches(2, 16, dtype=torch.float32, device="cpu")
    for seg in caches:
        seg["conv"][:, 1] = 9.0
    a, _ = tb.forward_step(tp, {"tokens": toks, "cache_len": torch.tensor([0, 0])}, caches)
    b, _ = tb.forward_step(tp, {"tokens": toks, "cache_len": torch.tensor([0, 0])}, fresh)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssm_engine_auto_disables_spec_decode_and_prefix_sharing():
    """Per-slot recurrent state cannot roll back or skip a chunk: both turn
    off with their warnings, and the engine serves on."""
    _, _, tb, tp = _bundles("dense")
    with pytest.warns(UserWarning, match="spec_decode disabled"):
        eng = ServingEngine(tb, tp, device="cpu", spec_decode=True, **ENGINE)
    assert eng.spec is None
    with pytest.warns(UserWarning, match="prefix sharing disabled"):
        eng = ServingEngine(tb, tp, device="cpu", paged=True, page_size=8, **ENGINE)
    assert not eng.pool.prefix_sharing
    eng.submit([1, 2, 3], max_tokens=3)
    assert eng.run_until_done()[0].status == "ok"


def test_training_the_ssm_family_raises():
    """The ssm family trains (its loss and gradients against the
    reference: tests/test_torch_train_families.py); a batch without labels
    raises."""
    _, _, tb, tp = _bundles("dense")
    batch = {"tokens": torch.ones((1, 4), dtype=torch.int32),
             "labels": torch.ones((1, 4), dtype=torch.int32)}
    assert torch.isfinite(tb.loss(tp, batch))
    with pytest.raises(KeyError, match="labels"):
        tb.loss(tp, {"tokens": batch["tokens"]})
