"""The port's enc-dec family (whisper_tiny: stub frames, a bidirectional
encoder, a decoder with cross-attention and per-row cross K/V) against the
JAX reference, from the same params (the reference's init, carried over by
`weights.params_from_numpy`) and the same numpy inputs: cross-attention,
`encode`, `cross_kv` and `decode`, each LUT site on its recorded inputs, the
serving forward with dense and paged caches and 8 greedy tokens; the
engine's and the launcher's refusal, and the reference engine's fault that
refusal avoids. The reference's kernels run in interpret mode, as its own
tests run them on the CPU."""

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
from repro.models import encdec as jencdec
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.attention import PagedSpec
from repro_torch.models.common import tape_capture
from repro_torch.serving.engine import ServingEngine, lut_kernel_signatures
from repro_torch.testing import hold_lut_sites
from repro_torch.weights import params_from_numpy, params_to_numpy

# DENSE: the same fp32 ops in another summation order; LUT_INFER: a site's
# output is byte-equal where the codes agree, so logits move only by the
# dense ops' order, over more layers of LUT error
ATOL = {"dense": 1e-5, "lut_infer": 1e-4}
TIE_EPS = 1e-5          # relative distance gap that explains a differing code
B, S_MAX, PROMPT, STEPS = 2, 32, 8, 8


@functools.lru_cache(maxsize=None)
def _bundles(mode):
    """Reduced whisper_tiny (2 encoder layers over 8 frames, 4 decoder
    layers; lut_use_kernel: m-shared scales) in both packages, the
    reference's params in both layouts. Cached: callers never write params."""
    kw = dict(lut_use_kernel=True)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("whisper_tiny"), **kw), mode)
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("whisper_tiny"), **kw), mode)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, mode, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL[mode],
                               rtol=ATOL[mode], **kw)


def _frames(tb, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, tb.arch.enc_frames, tb.arch.d_model), dtype=np.float32)


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


def test_encdec_layout_and_sites():
    """The encoder and decoder layers unstacked in the port and restacked
    byte-equal; the cache trees; sites at full size: encoder layers 0..3,
    decoder 4..7, every site LUT (the reference resolves the stacked
    layers' sites at layer None, so all_but_first keeps none dense), three
    kernel signatures (M, C, K, V)."""
    jb, jp, tb, tp = _bundles("lut_infer")
    assert tb.kind == "encdec" and len(tp["encoder"]) == 2 and len(tp["decoder"]) == 4
    assert set(tp["decoder"][0]) == {"norm1", "self", "norm2", "cross", "norm3", "mlp"}
    back = params_to_numpy(tb, tp)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                 jax.tree_util.tree_leaves(back)):
        assert np.asarray(want).tobytes() == np.asarray(got).tobytes(), path
    for paged in (None, PagedSpec(n_pages=9, page_size=8)):
        tc = tb.init_caches(B, S_MAX, dtype=torch.float32, device="cpu", paged=paged)
        jc = jb.init_caches(B, S_MAX, dtype=jnp.float32, paged=paged and jattn.PagedSpec(
            n_pages=9, page_size=8))
        assert jax.tree.map(lambda a: a.shape, jc) == \
            {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tc.items()}
    full = tcfg.build_model("whisper_tiny", "lut_infer")
    sites = full.sites()
    assert len(sites) == len(full.lut_sites()) == 4 * 6 + 4 * 10
    assert [s.layer for s in sites if s.kind == "mlp/down"] == list(range(8))
    assert sites[0].tape_key == "encoder/0/attn/q" and sites[-1].tape_key == "decoder/3/mlp/down"
    kernel = tcfg.build_model(dataclasses.replace(full.arch, lut_use_kernel=True), "lut_infer")
    assert lut_kernel_signatures(kernel) == \
        [(384, 12, 16, 32), (1536, 12, 16, 32), (384, 48, 16, 32)]
    # the training forward reads the encoder's frames (held against the
    # reference in tests/test_torch_train_families.py)
    with pytest.raises(KeyError, match="frames"):
        tb.train_logits(tp, {"tokens": torch.zeros((B, 4), dtype=torch.int32),
                             "labels": torch.zeros((B, 4), dtype=torch.int32)})


def test_cross_attention_matches_reference():
    """Cross-attention over a memory (B, T, D): the reference's attention
    with x_kv and its decoder's cross block, against `memory_kv` +
    `cross_attention`: no RoPE on the memory, non-causal, every memory
    position visible."""
    jb, jp, tb, tp = _bundles("dense")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 5, tb.arch.d_model), dtype=np.float32)
    mem = rng.standard_normal((B, tb.arch.enc_frames, tb.arch.d_model), dtype=np.float32)
    jcross = jax.tree.map(lambda a: a[1], jp["decoder"])["cross"]
    pos = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32)[None], (B, 5))
    want, _ = jattn.attention(jb.cfg.dec_cross, jcross, jnp.asarray(x), pos=pos,
                              x_kv=jnp.asarray(mem))
    kv = tattn.memory_kv(tb.cfg.dec_cross, tp["decoder"][1]["cross"], torch.from_numpy(mem))
    got = tattn.cross_attention(tb.cfg.dec_cross, tp["decoder"][1]["cross"], torch.from_numpy(x),
                                kv)
    _close(got, want, "dense")
    assert not tb.cfg.dec_cross.use_rope and not tb.cfg.dec_cross.causal


@pytest.mark.parametrize("mode", ["dense", "lut_infer"])
def test_encode_cross_kv_decode_match_reference(mode):
    """The encoder over stub frames, every decoder layer's cross K/V, and the
    decoder over whole sequences (no caches); in LUT_INFER each LUT site
    against the reference's on the inputs the forward recorded."""
    jb, jp, tb, tp = _bundles(mode)
    frames = _frames(tb)
    toks = np.random.default_rng(2).integers(1, tb.arch.vocab, (B, 10), dtype=np.int32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (B, 10)).copy()
    jenc = jencdec.encode(jb.cfg, jp, jnp.asarray(frames), compute_dtype=jnp.float32)
    jkv = jencdec.cross_kv(jb.cfg, jp, jenc)
    jlog, _ = jencdec.decode(jb.cfg, jp, tokens=jnp.asarray(toks), pos=jnp.asarray(pos),
                             enc_out=jenc, compute_dtype=jnp.float32)
    with tape_capture() as tape:
        tenc = tencdec.encode(tb.cfg, tp, torch.from_numpy(frames))
        tkv = tencdec.cross_kv(tb.cfg, tp, tenc)
        tlog, _ = tencdec.decode(tb.cfg, tp, tokens=torch.from_numpy(toks),
                                 pos=torch.from_numpy(pos), enc_out=tenc)
    _close(tenc, jenc, mode, err_msg="encode")
    for name in ("k", "v"):
        assert tkv[name].shape == (4, B, 8, 4, 32)
        _close(tkv[name], jkv[name], mode, err_msg=name)
    _close(tlog, jlog, mode, err_msg="logits")
    if mode == "lut_infer":
        held = hold_lut_sites(tb, tp, tape.records, _reference_site(jb, jp), tie_eps=TIE_EPS)
        assert held["sites"] == len(tb.lut_sites()) == 2 * 6 + 4 * 10


def _tables(paged: bool):
    if not paged:
        return None, None
    n_tables = S_MAX // 8
    bt = np.asarray([[1 + b * n_tables + p for p in range(n_tables)] for b in range(B)],
                    np.int32)
    return PagedSpec(n_pages=B * n_tables + 1, page_size=8), bt


@pytest.mark.parametrize("paged", [False, True])
def test_forward_step_with_frames_matches_reference(paged):
    """A prefill of 8 tokens with frames (the encoder runs, the cross K/V
    rows are written), then 8 greedy decode steps, with dense or paged
    self caches (the cross K/V per row either way): logits within the
    LUT tolerance, the same greedy tokens, and the caches the reference
    leaves."""
    jb, jp, tb, tp = _bundles("lut_infer")
    spec, bt = _tables(paged)
    jspec = spec and jattn.PagedSpec(n_pages=spec.n_pages, page_size=spec.page_size)
    jc = jb.init_caches(B, S_MAX, dtype=jnp.float32, paged=jspec)
    tc = tb.init_caches(B, S_MAX, dtype=torch.float32, device="cpu", paged=spec)
    frames = _frames(tb, seed=3)
    toks = np.random.default_rng(4).integers(1, tb.arch.vocab, (B, PROMPT), dtype=np.int32)
    cl = np.zeros((B,), np.int32)
    greedy = []
    for step in range(STEPS + 1):
        jbatch = {"tokens": jnp.asarray(toks), "cache_len": jnp.asarray(cl)}
        tbatch = {"tokens": torch.from_numpy(toks), "cache_len": torch.from_numpy(cl)}
        if step == 0:
            jbatch["frames"], tbatch["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
        if paged:
            jbatch["block_tables"], tbatch["block_tables"] = jnp.asarray(bt), torch.from_numpy(bt)
        jl, jc = jb.forward_step(jp, jbatch, jc, compute_dtype=jnp.float32)
        tl, tc = tb.forward_step(tp, tbatch, tc)
        _close(tl, jl, "lut_infer", err_msg=f"step {step}")
        nxt = np.asarray(jl)[:, -1].argmax(-1)
        assert (tl[:, -1].argmax(-1).numpy() == nxt).all(), f"step {step}"
        greedy.append(nxt)
        cl = cl + toks.shape[1]
        toks = nxt[:, None].astype(np.int32)
    assert len(greedy) == STEPS + 1
    for part in ("self", "cross"):
        for name, t in tc[part].items():
            _close(t, jc[part][name], "lut_infer", err_msg=f"{part}/{name}")


def test_frames_write_only_the_forward_rows():
    """A prefill with frames that may write row 1 only replaces row 1's cross
    K/V: another request's row keeps its own (the reference replaces every
    row's)."""
    _, _, tb, tp = _bundles("lut_infer")
    tc = tb.init_caches(B, S_MAX, dtype=torch.float32, device="cpu")
    for t in tc["cross"].values():
        t.fill_(-1e9)          # no K/V entry the model computes
    toks = torch.full((B, PROMPT), 5, dtype=torch.int32)
    tb.forward_step(tp, {"tokens": toks, "cache_len": torch.zeros(B, dtype=torch.int32),
                         "write_rows": torch.tensor([1]),
                         "frames": torch.from_numpy(_frames(tb))}, tc)
    for t in tc["cross"].values():
        assert (t[:, 0] == -1e9).all() and not (t[:, 1] == -1e9).any()
    assert not tc["self"]["k"][:, 0].any() and tc["self"]["k"][:, 1].any()


def test_engine_and_launcher_refuse_encdec():
    """The engine feeds token ids only: it refuses the enc-dec family at
    construction with the reason, and the launcher exits with it."""
    _, _, tb, tp = _bundles("lut_infer")
    with pytest.raises(ValueError, match="could not run the encoder"):
        ServingEngine(tb, tp, device="cpu", n_slots=2, max_seq=S_MAX, prefill_chunk=PROMPT)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--arch", "whisper_tiny"])
    assert exc.value.code == 2


def _greedy_forward_steps(jb, jp, prompt, n, frames=None):
    """The reference's forward_step on one row: the prompt (with frames, or
    against the zero cross K/V of fresh caches), then n - 1 greedy steps."""
    jc = jb.init_caches(1, S_MAX, dtype=jnp.float32)
    batch = {"tokens": jnp.asarray([prompt], jnp.int32), "cache_len": jnp.zeros((1,), jnp.int32)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames[None])
    out, cl = [], len(prompt)
    for _ in range(n):
        logits, jc = jb.forward_step(jp, batch, jc, compute_dtype=jnp.float32)
        out.append(int(np.asarray(logits)[0, -1].argmax()))
        batch = {"tokens": jnp.asarray([[out[-1]]], jnp.int32),
                 "cache_len": jnp.asarray([cl], jnp.int32)}
        cl += 1
    return out


def test_reference_engine_decodes_against_zero_cross_kv():
    """The known reference fault the port's refusal avoids: the reference
    engine builds its batches from token ids only, so its whisper tokens
    are those of a forward_step run against the zero cross K/V its caches
    start with, and not those of a run whose encoder saw the frames."""
    jb, jp, _, _ = _bundles("lut_infer")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jb.arch.vocab, PROMPT).tolist() for _ in range(2)]
    eng = JServingEngine(jb, jp, n_slots=2, max_seq=S_MAX, prefill_chunk=PROMPT)
    for p in prompts:
        eng.submit(p, max_tokens=4)
    got = [r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)]
    frames = np.random.default_rng(6).standard_normal(
        (jb.arch.enc_frames, jb.arch.d_model), dtype=np.float32) * 4
    zero = [_greedy_forward_steps(jb, jp, p, 4) for p in prompts]
    heard = [_greedy_forward_steps(jb, jp, p, 4, frames) for p in prompts]
    assert got == zero and heard != zero
