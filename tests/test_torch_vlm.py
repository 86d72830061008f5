"""The port's vision-LM backbone (qwen2_vl_7b: M-RoPE over embedding inputs;
the ViT frontend a stub) against the JAX reference, from the same params
(the reference's init, carried over by `weights.params_from_numpy`) and the
same numpy inputs: M-RoPE with distinct (t, h, w) streams, the no-cache
forward over embeddings with a patch grid's positions, each LUT site on its
recorded inputs, the serving forward with dense and paged caches and 8
greedy tokens fed back as embedding rows; the engine's and the launcher's
refusal, and the reference engine's fault that refusal avoids. The
reference's kernels run in interpret mode, as its own tests run them on the
CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import ops as jops
from repro.kernels.ref import encode_ref as jencode_ref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import common
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import PagedSpec
from repro_torch.models.common import tape_capture
from repro_torch.serving.engine import ServingEngine, lut_kernel_signatures
from repro_torch.testing import grid_positions, hold_lut_sites
from repro_torch.weights import params_from_numpy

# DENSE: the same fp32 ops in another summation order; LUT_INFER: a site's
# output is byte-equal where the codes agree, so logits move only by the
# dense ops' order, over more layers of LUT error
ATOL = {"dense": 1e-5, "lut_infer": 1e-4}
TIE_EPS = 1e-5          # relative distance gap that explains a differing code
B, S_MAX, PROMPT, STEPS = 2, 32, 8, 8


@functools.lru_cache(maxsize=None)
def _bundles(mode):
    """Reduced qwen2_vl_7b (4 layers, d_model 128, M-RoPE sections (4, 6,
    6); lut_use_kernel: m-shared scales) in both packages, the reference's
    params in both layouts. Cached: callers never write params."""
    kw = dict(lut_use_kernel=True)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen2_vl_7b"), **kw), mode)
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen2_vl_7b"), **kw), mode)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, mode, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL[mode],
                               rtol=ATOL[mode], **kw)


def _reference_site(jb, jp):
    """(spec, x) -> (output, codes) of the reference's LUT site at the same
    registry entry as the port's spec: its fused kernel in interpret mode,
    whose int32 lookup is exact (the reference's own CPU dispatch picks v1
    at M <= 512, which sums fp32-dequantized entries), and its encode."""
    jspecs = {s.tape_key: s for s in jb.lut_sites()}

    def run(spec, x):
        js = jspecs[spec.tape_key]
        node = jp
        for part in js.path.split("/"):
            node = node[int(part)] if part.isdigit() else node[part]
        node = jax.tree.map(lambda a: a[js.stack_index], node)
        x = jnp.asarray(x)
        out = jops.lut_amm(x, node["centroids"], node["table_q"], node["table_scale"],
                           version=3)
        return np.asarray(out), np.asarray(jencode_ref(x, node["centroids"]))

    return run


def test_mrope_matches_reference():
    """M-RoPE with distinct (t, h, w) streams against the reference's; with
    three equal streams it is RoPE, bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos3 = rng.integers(0, 50, (3, 2, 7), dtype=np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (4, 6, 6))
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6, (4, 6, 6))
    _close(got, want, "dense")
    flat = torch.from_numpy(np.ascontiguousarray(pos3[0]))
    assert torch.equal(common.apply_mrope(torch.from_numpy(x), flat[None].expand(3, -1, -1),
                                          1e6, (4, 6, 6)),
                       common.apply_rope(torch.from_numpy(x), flat, 1e6))
    with pytest.raises(ValueError, match="sum"):
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6, (4, 6, 4))


def test_vlm_layout_and_sites():
    """Embedding inputs on an lm bundle that keeps its embedding table (as
    the reference's lm_init does) and an untied dense lm_head; M-RoPE in
    every attention config; at full size layer 0 dense, layers 1..27 LUT,
    four kernel signatures (M, C, K, V), down at C = 592."""
    _, jp, tb, tp = _bundles("lut_infer")
    assert tb.kind == "lm" and tb.cfg.takes_embeds and "embed" in tp and "lm_head" in tp
    assert tp["embed"]["table"].shape == tuple(jp["embed"]["table"].shape)
    assert all(b.attn.mrope_sections == (4, 6, 6) for _, b in tb.cfg.segments)
    full = tcfg.build_model(tcfg.get_arch("qwen2_vl_7b"), "lut_infer")
    lut = full.lut_sites()
    assert {s.layer for s in lut} == set(range(1, 28)) and len(lut) == 27 * 7
    assert [s.mode.value for s in full.sites() if s.kind == "lm_head"] == ["dense"]
    kernel = tcfg.build_model(dataclasses.replace(full.arch, lut_use_kernel=True), "lut_infer")
    assert lut_kernel_signatures(kernel) == [(3584, 112, 16, 32), (512, 112, 16, 32),
                                             (18944, 112, 16, 32), (3584, 592, 16, 32)]
    # the embedding-input training forward (held against the reference in
    # tests/test_torch_train_families.py); token ids alone are refused
    assert torch.isfinite(tb.loss(tp, {"embeds": torch.zeros((B, 4, tb.arch.d_model)),
                                       "labels": torch.zeros((B, 4), dtype=torch.long)}))
    with pytest.raises(ValueError, match="embeddings"):
        tb.loss(tp, {"tokens": torch.zeros((B, 4), dtype=torch.int32),
                     "labels": torch.zeros((B, 4), dtype=torch.long)})


@pytest.mark.parametrize("mode", ["dense", "lut_infer"])
def test_lm_apply_with_embeds_and_grid_positions_matches_reference(mode):
    """The no-cache forward over 12 patch embeddings of a 3 x 4 grid and 4
    text embeddings, positions in distinct (t, h, w) streams: logits; in
    LUT_INFER each LUT site against the reference's on the inputs the
    forward recorded."""
    jb, jp, tb, tp = _bundles(mode)
    emb = np.random.default_rng(1).standard_normal((B, 16, tb.arch.d_model), dtype=np.float32)
    pos3 = grid_positions(B, 4, 3, 4)
    assert (pos3[1] != pos3[2]).any() and (pos3[0] != pos3[1]).any()
    want, _, _ = jtf.lm_apply(jb.cfg, jp, embeds=jnp.asarray(emb), pos=jnp.asarray(pos3),
                              compute_dtype=jnp.float32)
    with tape_capture() as tape, torch.no_grad():
        got, _, _ = ttf.lm_apply(tb.cfg, tp, embeds=torch.from_numpy(emb),
                                 pos=torch.from_numpy(pos3))
    _close(got, want, mode)
    if mode == "lut_infer":
        held = hold_lut_sites(tb, tp, tape.records, _reference_site(jb, jp), tie_eps=TIE_EPS)
        assert held["sites"] == len(tb.lut_sites()) == 3 * 7
    with pytest.raises(ValueError, match="embeddings"):
        ttf.lm_apply(tb.cfg, tp, tokens=torch.zeros((B, 4), dtype=torch.int32),
                     pos=torch.zeros((3, B, 4), dtype=torch.int32))


@pytest.mark.parametrize("paged", [False, True])
def test_forward_step_with_embeds_matches_reference(paged):
    """A prefill of 8 embedding rows, then 8 greedy decode steps, each
    decoded token fed back as its embedding row, with dense or paged
    caches: logits within the LUT tolerance, the same greedy tokens, and
    the K/V the reference leaves."""
    jb, jp, tb, tp = _bundles("lut_infer")
    spec = bt = jspec = None
    if paged:
        n_tables = S_MAX // 8
        bt = np.asarray([[1 + b * n_tables + p for p in range(n_tables)] for b in range(B)],
                        np.int32)
        spec = PagedSpec(n_pages=B * n_tables + 1, page_size=8)
        jspec = jattn.PagedSpec(n_pages=spec.n_pages, page_size=8)
    jc = jb.init_caches(B, S_MAX, dtype=jnp.float32, paged=jspec)
    tc = tb.init_caches(B, S_MAX, dtype=torch.float32, device="cpu", paged=spec)
    table = np.asarray(jp["embed"]["table"])
    emb = np.random.default_rng(2).standard_normal((B, PROMPT, tb.arch.d_model),
                                                   dtype=np.float32)
    cl = np.zeros((B,), np.int32)
    for step in range(STEPS + 1):
        jbatch = {"embeds": jnp.asarray(emb), "cache_len": jnp.asarray(cl)}
        tbatch = {"embeds": torch.from_numpy(emb), "cache_len": torch.from_numpy(cl)}
        if paged:
            jbatch["block_tables"], tbatch["block_tables"] = jnp.asarray(bt), torch.from_numpy(bt)
        jl, jc = jb.forward_step(jp, jbatch, jc, compute_dtype=jnp.float32)
        tl, tc = tb.forward_step(tp, tbatch, tc)
        _close(tl, jl, "lut_infer", err_msg=f"step {step}")
        nxt = np.asarray(jl)[:, -1].argmax(-1)
        assert (tl[:, -1].argmax(-1).numpy() == nxt).all(), f"step {step}"
        cl = cl + emb.shape[1]
        emb = np.ascontiguousarray(table[nxt][:, None])
    for jseg, tseg in zip(jc, tc):
        for name, t in tseg.items():
            _close(t, jseg[name], "lut_infer", err_msg=name)


def test_engine_and_launcher_refuse_embedding_models():
    """The engine feeds token ids only: it refuses a model that takes
    embeddings at construction with the reason, and the launcher exits
    with it."""
    _, _, tb, tp = _bundles("lut_infer")
    with pytest.raises(ValueError, match="could not give this model the embeddings"):
        ServingEngine(tb, tp, device="cpu", n_slots=2, max_seq=S_MAX, prefill_chunk=PROMPT)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--arch", "qwen2_vl_7b"])
    assert exc.value.code == 2


def test_reference_engine_fails_at_its_first_forward():
    """The known reference fault the port's refusal avoids: the reference
    engine feeds token ids to a model that takes embeddings, and its first
    forward fails (lm_apply reads `embeds` of None)."""
    jb, jp, _, _ = _bundles("dense")
    eng = JServingEngine(jb, jp, n_slots=2, max_seq=S_MAX, prefill_chunk=PROMPT)
    eng.submit(list(range(1, 1 + PROMPT)), max_tokens=2)
    with pytest.raises(AttributeError, match="astype"):
        eng.run_until_done()
