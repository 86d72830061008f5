"""The port's hybrid family (zamba2_1p2b: a Mamba2 backbone and one shared
attention block) against the JAX reference, from the same params: the whole
forward without caches, the serving forward with dense and paged caches,
the params' stacked layout, and greedy engine tokens."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import hybrid as jhybrid
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs as tcfg
from repro_torch.models import hybrid as thybrid
from repro_torch.models.attention import PagedSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_numpy, params_to_numpy

ATOL = RTOL = 1e-4          # the port's model tolerance (tests/test_torch_model.py)
ENGINE = dict(n_slots=2, max_seq=32, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _bundles(mode, n_layers=5):
    """Reduced zamba2_1p2b (attn_every 2: the shared block after layers 2 and
    4, then one more mamba layer) in both packages, the reference's params
    in both layouts."""
    kw = dict(n_layers=n_layers, lut_use_kernel=True)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("zamba2_1p2b"), **kw), mode)
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("zamba2_1p2b"), **kw), mode)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL, **kw)


def test_hybrid_layout_and_sites():
    """Invocation points and segment bounds as the reference's; the mamba
    layers unstacked in the port and restacked byte-equal; sites at full
    size (the shared block's at layer None, `fuse` dense)."""
    jb, jp, tb, tp = _bundles("lut_infer")
    assert tb.kind == "hybrid" and tb.cfg.invocation_points == jb.cfg.invocation_points == (2, 4)
    assert tb.cfg.segment_bounds == jb.cfg.segment_bounds == ((0, 2), (2, 4), (4, 5))
    assert len(tp["mamba_stack"]) == 5 and "fuse" in tp["shared"]
    back = params_to_numpy(tb, tp)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                 jax.tree_util.tree_leaves(back)):
        assert np.asarray(want).tobytes() == np.asarray(got).tobytes(), path
    sites = {s.path: s for s in tcfg.build_model("zamba2_1p2b", "lut_infer").sites()}
    assert sites["shared/fuse"].mode.value == "dense" and sites["shared/fuse"].layer is None
    assert sites["shared/out"].mode.value == "lut_infer"
    assert sites["mamba_stack/mamba/in_proj"].d_out == 8384


@pytest.mark.parametrize("mode", ["dense", "lut_infer"])
def test_hybrid_apply_without_caches_matches_reference(mode):
    """The whole-sequence forward (no caches): logits."""
    jb, jp, tb, tp = _bundles(mode)
    toks = np.random.default_rng(0).integers(1, tb.arch.vocab, (2, 12), dtype=np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jl, _, _ = jhybrid.hybrid_apply(jb.cfg, jp, tokens=jnp.asarray(toks), pos=jnp.asarray(pos),
                                    compute_dtype=jnp.float32)
    tl, _ = thybrid.hybrid_apply(tb.cfg, tp, tokens=torch.from_numpy(toks),
                                 pos=torch.from_numpy(pos.copy()))
    _close(tl, jl)


@pytest.mark.parametrize("paged", [False, True])
def test_forward_step_with_caches_matches_reference(paged):
    """A full prefill chunk, then two decode steps, with dense or paged
    attention caches (the mamba state per row either way): logits, and the
    mamba state and K/V as the reference leaves them."""
    jb, jp, tb, tp = _bundles("lut_infer")
    b, s_max, chunk = 2, 16, 8
    spec = PagedSpec(n_pages=2 * s_max // 4 + 1, page_size=4) if paged else None
    jc = jb.init_caches(b, s_max, dtype=jnp.float32)
    tc = tb.init_caches(b, s_max, dtype=torch.float32, device="cpu", paged=spec)
    if paged:
        assert set(tc["attn"]) == {"k_pool", "v_pool"} and set(tc["mamba"]) == {"conv", "ssm"}
    tables = torch.arange(1, 1 + b * s_max // 4).reshape(b, -1)
    toks = np.random.default_rng(1).integers(1, tb.arch.vocab, (b, chunk), dtype=np.int32)
    cl = np.zeros((b,), np.int32)
    for step in range(3):
        jl, jc = jb.forward_step(jp, {"tokens": jnp.asarray(toks), "cache_len": jnp.asarray(cl)},
                                 jc, compute_dtype=jnp.float32)
        batch = {"tokens": torch.from_numpy(toks), "cache_len": torch.from_numpy(cl)}
        if paged:
            batch["block_tables"] = tables
        tl, tc = tb.forward_step(tp, batch, tc)
        _close(tl, jl, err_msg=f"step {step}")
        cl = cl + toks.shape[1]
        toks = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for name in ("conv", "ssm"):
        _close(tc["mamba"][name], jc["mamba"][name], err_msg=name)
    if not paged:
        _close(tc["attn"]["k"], jc["attn"]["k"])


def test_engine_greedy_tokens_equal_the_reference_engine():
    """Prompts of exactly one chunk, three requests on two slots: the same
    greedy tokens through both engines."""
    jb, jp, tb, tp = _bundles("lut_infer")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, tb.arch.vocab, 8).tolist() for _ in range(3)]
    outs = []
    for eng in (JServingEngine(jb, jp, **ENGINE), ServingEngine(tb, tp, device="cpu", **ENGINE)):
        for p in prompts:
            eng.submit(p, max_tokens=5)
        outs.append([r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)])
    assert outs[0] == outs[1]


def test_paged_engine_equals_dense_and_auto_disables():
    """Paged attention caches beside per-slot mamba state: ragged and
    2-chunk prompts give the dense engine's tokens; prefix sharing and
    speculative decoding turn off with their warnings."""
    _, _, tb, tp = _bundles("lut_infer")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tb.arch.vocab, n).tolist() for n in (16, 11, 5, 8)]

    def serve(**kw):
        eng = ServingEngine(tb, tp, device="cpu", **ENGINE, **kw)
        for p in prompts:
            eng.submit(p, max_tokens=4)
        return [r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)], eng

    dense, _ = serve()
    with pytest.warns(UserWarning, match="prefix sharing disabled"):
        paged, eng = serve(paged=True, page_size=4)
    assert paged == dense and not eng.pool.prefix_sharing
    with pytest.warns(UserWarning, match="spec_decode disabled"):
        spec, eng = serve(spec_decode=True)
    assert spec == dense and eng.spec is None
