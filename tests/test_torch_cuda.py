"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA Hopper GPU and skips without one. This file
imports neither JAX nor the reference package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import autotune, counters, measure, ops, ref
from repro_torch.kernels import dist_argmin as enc_mod
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.serving import sampling
from repro_torch.testing import (
    CLUSTER_SHAPES,
    LAYOUTS,
    RAGGED,
    WIDE_SITES,
    make_amm_inputs,
    quantize_np,
    rows_near_tie,
    tie_gaps,
)

pytestmark = pytest.mark.cuda
TIE_EPS = 1e-6        # relative fp32 distance gap where another sum order may flip a code
TIE_ULPS = 8          # gumbel + logit gap, in fp32 ulps of its size, that explains a flip
EPS32 = torch.finfo(torch.float32).eps
KERNELS = {"fused": (fused_mod.fused_decode, ref.fused_decode_plain),
           "v2": (v2_mod.lut_amm_v2, ref.lut_amm_v2_plain)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, layout, seed, dev):
    n, d, m, k, v = shape
    x, P, T, b = make_amm_inputs(n, d, m, k, v, seed=seed)
    q, s = quantize_np(T, layout)
    return [torch.from_numpy(a).to(dev) for a in (x, P, q, s, b)]


def _assert_agree(got, want, x, P, exact):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    if exact:
        bad = (g != w).any(dim=1)
    else:       # fp32 per-codebook sums in another order; exp/tanh ulps
        bad = ((g - w).abs() > 1e-4 * max(1.0, w.abs().max().item())).any(dim=1)
    # a row may differ only where the fp32 distances sit on a near-tie
    assert not (bad & ~rows_near_tie(x, P, TIE_EPS)).any()


@pytest.mark.parametrize("kernel", ["fused", "v2"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_matches_plain(dev, kernel, layout):
    fn, plain = KERNELS[kernel]
    for i, shape in enumerate(RAGGED):
        x, P, q, s, b = _inputs(shape, layout, i, dev)
        for act, bias in (("none", None), ("relu2", b), ("silu", b)):
            before = fused_mod.launches + v2_mod.launches
            got = fn(x, P, q, s, bias=bias, act=act)
            assert fused_mod.launches + v2_mod.launches == before + 1
            exact = s.shape[0] == 1 and act != "silu"   # exact int32 sums, one rounding
            _assert_agree(got, plain(x, P, q, s, bias=bias, act=act), x, P, exact)


def test_fused_and_v2_bytewise_equal_on_m_shared(dev):
    x, P, q, s, b = _inputs((100, 2048, 1024, 16, 32), "m_shared", 7, dev)
    a = fused_mod.fused_decode(x, P, q, s, bias=b)
    c = v2_mod.lut_amm_v2(x, P, q, s, bias=b)
    torch.cuda.synchronize()
    assert torch.equal(a, c)          # one device encode, exact int32 sums


def test_ops_dispatch_by_fit_rule_and_bf16(dev):
    counters.reset()
    for c, counter in ((64, fused_mod), (192, v2_mod)):
        x, P, q, s, _ = _inputs((4, c * 32, 256, 16, 32), "m_shared", c, dev)
        before = counter.launches
        out = ops.lut_amm(x.bfloat16(), P, q, s)
        torch.cuda.synchronize()
        assert counter.launches == before + 1 and out.dtype == torch.bfloat16
        want = ref.fused_decode_plain(x.bfloat16(), P, q, s)
        _assert_agree(out, want, x.bfloat16().float(), P, exact=True)
    assert sum(ref.calls.values()) == 2          # only the comparisons above


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, P, q, s, _ = _inputs(RAGGED[0], "m_shared", 0, dev)
    for fn in (fused_mod.fused_decode, v2_mod.lut_amm_v2):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t().contiguous().t(), P, q, s)
        with pytest.raises(ValueError, match="on"):
            fn(x, P.cpu(), q, s)
        with pytest.raises(TypeError):
            fn(x.half(), P, q, s)
        assert fn(x[:0], P, q, s).shape == (0, q.shape[-1])
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(192, 16, 32, device=dev)
        fused_mod.fused_decode(torch.zeros(1, 192 * 32, device=dev), big,
                               torch.zeros(192, 16, 8, dtype=torch.int8, device=dev),
                               torch.ones(1, 1, 8, device=dev))


@pytest.mark.parametrize("site", WIDE_SITES, ids=[str(s) for s in WIDE_SITES])
def test_wide_sites_match_plain(dev, site):
    """Sites past the old V = 32 / K = 256 envelope (V = 64; K = 512, 384
    and 300, codes held in two bytes and the table ring in two equal TMA
    boxes per codebook or gathered where they would not start aligned; and
    C = 128 at V = 8), at decode, the verify shape and a prefill chunk (v2
    there under every staged M tile too): fused (where it fits) == v2 ==
    plain bytewise and v1 == plain bytewise
    on m-shared scales, codes equal off near-ties; and past the envelope the
    wrappers raise, naming it."""
    c, k, v, m = site
    for n in (4, 20, 128):
        x, P, q, s, _ = _inputs((n, c * v, m, k, v), "m_shared", n + c, dev)
        want = ref.fused_decode_plain(x, P, q, s)
        got = [v2_mod.lut_amm_v2(x, P, q, s)]
        if fused_mod.fits(c, k, v):
            got.append(fused_mod.fused_decode(x, P, q, s))
        if n == 128:              # every staged M tile: rings of 2 to 8 stages, or the gather
            got += [v2_mod.lut_amm_v2(x, P, q, s, quads=qq) for qq in v2_mod.STAGED_QUADS]
        for out in got:
            _assert_agree(out, want, x, P, exact=True)
            assert torch.equal(out, got[0])
        _assert_agree(v2_mod.lut_amm_v1(x, P, q, s), ref.lut_amm_v1_plain(x, P, q, s), x, P,
                      exact=True)
        codes = enc_mod.encode(x, P)
        torch.cuda.synchronize()
        assert (tie_gaps(x, P, codes, ref.encode_ref(x, P)) <= TIE_EPS).all()
    assert autotune.fit_version(c, k, v) == (3 if fused_mod.fits(c, k, v) else 2)
    for kk, vv in ((2 * v2_mod.MAX_K, v), (k, 2 * v2_mod.MAX_V)):
        x = torch.zeros(2, c * vv, device=dev)
        P = torch.zeros(c, kk, vv, device=dev)
        q = torch.zeros(c, kk, m, dtype=torch.int8, device=dev)
        with pytest.raises(ValueError, match="envelope"):
            v2_mod.lut_amm_v2(x, P, q, torch.ones(1, 1, m, device=dev))
        with pytest.raises(ValueError, match="envelope"):
            enc_mod.encode(x, P)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_v1_matches_plain_bytewise(dev, layout):
    """Same fp32 order of the sums in kernel and plain version: equal bytes
    on every row whose codes agree, at the default chunk, one-codebook
    chunks and a single chunk, under every N tile (the ordered lookup at 8
    rows, the row-split lookup over the TMA ring where the table is staged
    at more), f32 and bf16."""
    for i, shape in enumerate(RAGGED):
        x, P, q, s, _ = _inputs(shape, layout, i + 10, dev)
        for xx in (x, x.bfloat16()):
            for bc in (None, 1, P.shape[0]):
                want = ref.lut_amm_v1_plain(xx, P, q, s, block_c=bc)
                for rows in (None, *v2_mod.ROW_TILES):
                    before = v2_mod.launches_v1
                    got = v2_mod.lut_amm_v1(xx, P, q, s, block_c=bc, rows=rows)
                    assert v2_mod.launches_v1 == before + 1
                    _assert_agree(got, want, xx.float(), P, exact=True)


@pytest.mark.parametrize("shape", [(4, 2048, 2048, 16, 32), (128, 6144, 2048, 16, 32)])
def test_v1_and_encode_at_path_shapes(dev, shape):
    x, P, q, s, b = _inputs(shape, "m_shared", 3, dev)
    got = ops.lut_amm(x, P, q, s, bias=b, act="silu", version=1)
    want = ref.apply_act(ref.lut_amm_v1_plain(x, P, q, s) + b, "silu")
    _assert_agree(got, want, x, P, exact=True)
    codes = ops.encode(x, P)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int32 and codes.shape == (x.shape[0], P.shape[0])
    assert (tie_gaps(x, P, codes, ref.encode_ref(x, P)) <= TIE_EPS).all()


def test_encode_launches_and_geometry(dev):
    for i, shape in enumerate(RAGGED):
        x, P, *_ = _inputs(shape, "m_shared", i, dev)
        n, c, k, v = x.shape[0], *P.shape
        cands = [{"block_n": cfg.block_n, "block_c": cfg.block_c}
                 for cfg in autotune.candidates("encode", n, 0, c, k, v)]
        for blocks in ({}, {"block_c": 1, "block_n": 5}, *cands):
            before = enc_mod.launches
            codes = enc_mod.encode(x, P, **blocks)
            assert enc_mod.launches == before + 1
            assert (tie_gaps(x, P, codes, ref.encode_ref(x, P)) <= TIE_EPS).all()
    with pytest.raises(ValueError, match="K="):
        enc_mod.encode(torch.zeros(2, 64, device=dev), torch.zeros(2, 1024, 32, device=dev))
    assert enc_mod.encode(x[:0], P).shape == (0, P.shape[0])


def test_sampler_on_the_card_equals_the_cpu():
    """The threefry bits are integer arithmetic: identical on both devices;
    the tokens agree unless gumbel + logit ties within an ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(8, 151936, generator=gen) * 3
    args = (torch.tensor([0.0, 0.8, 0.8, 1.0, 0.5, 1.3, 0.8, 0.9]),
            torch.tensor([0, 50, 0, 5, 0, 0, 50, 1], dtype=torch.int32),
            torch.tensor([1.0, 0.9, 0.9, 1.0, 0.5, 0.95, 1.0, 1.0]),
            torch.arange(8, dtype=torch.int32) * 977 - 3000,
            torch.arange(8, dtype=torch.int32) * 3)
    keys = sampling.fold_in(sampling.prng_keys(args[3]), args[4])
    assert torch.equal(sampling.random_bits(keys.cuda(), 4096).cpu(),
                       sampling.random_bits(keys, 4096))
    cpu = sampling.sample_tokens(logits, *args)
    card = sampling.sample_tokens(logits.cuda(), *(a.cuda() for a in args)).cpu()
    # each differing token ties with the CPU's on gumbel + scaled logit,
    # the noise recomputed from the port's own bits
    noise = sampling.gumbel(keys, logits.shape[1])
    scaled = logits / torch.clamp_min(args[0], 1e-6)[:, None]
    for row in (cpu != card).nonzero().flatten().tolist():
        assert args[0][row] > 0, f"greedy row {row} differs"
        a, b = (float(noise[row, t] + scaled[row, t]) for t in (cpu[row], card[row]))
        assert abs(a - b) <= TIE_ULPS * EPS32 * max(abs(a), abs(b), 1.0), (row, a, b)


def test_measured_tuning_on_the_card(dev):
    """The measured path times every version and launch on the card and
    records a measured winner that dispatch then runs."""
    cache = autotune.AutotuneCache("/dev/null/unwritable")
    fn = measure.measure_lut_amm(4, 256, 64, 16, 32, reps=2)
    _, rec = autotune.tune("lut_amm", 4, 256, 64, 16, 32, cache=cache, measure=fn, save=False)
    assert rec["measured"] and rec["version"] in (1, 2, 3) and rec["predicted_us"] > 0
    counters.reset()
    fn(autotune.DEFAULT, 1)
    assert counters.launches()["lut_amm_v1"] >= 2 and counters.plain_calls() == 0


@pytest.mark.parametrize("shape", CLUSTER_SHAPES, ids=[str(s[:5]) for s in CLUSTER_SHAPES])
def test_every_cluster_and_n_tile_matches_plain(dev, shape):
    """One ragged shape under every N tile (the table staged where its rows
    are 16-byte aligned, M = 48, 144 and 384, else gathered). The shapes'
    C (1 to 20) take every cluster size from 1 to 16, and C = 5, 6 and 20
    do not divide by theirs; N is no multiple of the tile. m-shared:
    fused == v2 == plain bytewise, in float32 and bfloat16; per-codebook
    scales within the fp32 bound."""
    i = CLUSTER_SHAPES.index(shape)
    for layout in ("m_shared", "per_codebook"):
        x, P, q, s, b = _inputs(shape, layout, 20 + i, dev)
        for xx in (x, x.bfloat16()):
            want = ref.fused_decode_plain(xx, P, q, s, bias=b, act="relu2")
            exact = layout == "m_shared"
            for rows in v2_mod.ROW_TILES:
                kw = {"rows": rows}
                got = [fn(xx, P, q, s, bias=b, act="relu2", **kw) for fn, _ in KERNELS.values()]
                for out in got:
                    if xx.dtype == torch.bfloat16 and not exact:
                        torch.cuda.synchronize()
                        tol = 8e-3 * max(1.0, want.float().abs().max().item())
                        bad = ((out.float() - want.float()).abs() > tol).any(dim=1)
                        assert not (bad & ~rows_near_tie(xx.float(), P, TIE_EPS)).any()
                    else:
                        _assert_agree(out, want, xx.float(), P, exact)
                if exact:
                    assert torch.equal(got[0], got[1])


def test_path_shape_launches_agree(dev):
    """qwen3_1p7b's q/o site at decode and at a prefill chunk under every
    launch the tuner sweeps: fused == v2 == plain bytewise (m-shared)."""
    for n in (4, 128):
        x, P, q, s, _ = _inputs((n, 2048, 2048, 16, 32), "m_shared", n, dev)
        want = ref.fused_decode_plain(x, P, q, s)
        for cfg in autotune.candidates("lut_amm", n, 2048, 64, 16, 32, 3):
            kw = autotune.cluster_launch(cfg)
            a = fused_mod.fused_decode(x, P, q, s, **kw)
            c = v2_mod.lut_amm_v2(x, P, q, s, **kw)
            _assert_agree(a, want, x, P, exact=True)
            assert torch.equal(a, c), kw


@pytest.mark.parametrize("n", [4, 128])
def test_v1_and_encode_under_every_candidate_at_path_shapes(dev, n):
    """qwen3_1p7b's q/o and down sites under every v1 and encode launch the
    tuner sweeps: v1 == plain bytewise (m-shared), codes equal off near-ties."""
    for c, seed in ((64, 1), (192, 2)):
        x, P, q, s, _ = _inputs((n, c * 32, 2048, 16, 32), "m_shared", n + seed, dev)
        want = {}
        for cfg in autotune.candidates("lut_amm", n, 2048, c, 16, 32, 1):
            launch = autotune.v1_launch(cfg)
            bc = launch["block_c"]
            want.setdefault(bc, ref.lut_amm_v1_plain(x, P, q, s, block_c=bc))
            _assert_agree(v2_mod.lut_amm_v1(x, P, q, s, **launch), want[bc], x, P, exact=True)
        codes = ref.encode_ref(x, P)
        for cfg in autotune.candidates("encode", n, 0, c, 16, 32):
            got = enc_mod.encode(x, P, block_n=cfg.block_n, block_c=cfg.block_c)
            torch.cuda.synchronize()
            assert (tie_gaps(x, P, got, codes) <= TIE_EPS).all()


def _engine_model(dev):
    """Reduced qwen3_1p7b in LUT_INFER (kernel sites), target and a divergent
    draft from seeded generators on the card."""
    from repro_torch import configs as tcfg

    bundle = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                               d_model=64, vocab=128, d_ff=128,
                                               lut_use_kernel=True), "lut_infer")
    return (bundle, bundle.init(torch.Generator().manual_seed(0), device=dev),
            bundle.init(torch.Generator().manual_seed(9), device=dev))


@pytest.mark.parametrize("version", [2, 3])
def test_paged_and_spec_engines_match_dense_on_the_card(dev, version, tmp_path, monkeypatch):
    """With every LUT site pinned to one kernel version at every token count
    (decode, prefill chunk, verify): the paged engine (prefix hits, a COW,
    fp8 storage) gives the dense engine's tokens, and speculative decoding
    (self-draft and a divergent draft, dense and paged) plain decode's; every
    forward launched the pinned kernel and never a plain version."""
    from repro_torch.serving.engine import ServingEngine, lut_kernel_signatures

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)
    bundle, params, draft = _engine_model(dev)
    kw = dict(n_slots=2, max_seq=32, prefill_chunk=4, device=dev)
    cache = autotune.get_cache()
    for m, c, k, v in lut_kernel_signatures(bundle):
        for n in (2, 8, 10):                       # decode, prefill chunk, verify (gamma 4)
            cache.put(autotune.shape_key("lut_amm", n, m, c, k, v, "float32",
                                         autotune.BACKEND_CUDA),
                      {"block_n": 0, "block_m": 0, "block_c": 0, "version": version,
                       "measured": False, "source": "pinned"})
    prompts = [[3, 5, 7, 9], [1, 2, 3, 4, 5, 6, 7, 8], [11, 13, 17], [1, 2, 3, 4, 5, 6, 7, 8]]

    def serve(**engine_kw):
        eng = ServingEngine(bundle, params, **kw, **engine_kw)
        for p in prompts:
            eng.submit(p, max_tokens=6)
        done = sorted(eng.run_until_done(max_steps=500), key=lambda r: r.rid)
        assert all(r.status == "ok" for r in done)
        return [r.out_tokens for r in done], eng.stats()

    counters.reset()
    dense, _ = serve()
    paged, st = serve(paged=True, page_size=4)
    assert paged == dense and st["prefix_hits"] > 0 and st["cow_copies"] > 0
    assert serve(paged=True, page_size=4, kv_dtype="float8_e4m3fn")[0] == \
        serve(kv_dtype="float8_e4m3fn")[0]
    spec, st = serve(spec_decode=True)
    assert spec == dense and st["spec_bonus_tokens"] > 0
    for paged_kw in ({}, {"paged": True, "page_size": 4}):
        spec, st = serve(spec_decode=True, draft_bundle=bundle, draft_params=draft, **paged_kw)
        assert spec == dense and st["spec_tokens_accepted"] < st["spec_tokens_proposed"]
    launched = counters.launches()
    name = "fused_decode" if version == 3 else "lut_amm_v2"
    assert launched[name] > 0 and sum(launched.values()) == launched[name]
    assert counters.plain_calls() == 0


def test_fp8_pool_writes_and_gathers_bits_on_the_card(dev):
    """The paged write and gather index float8_e4m3fn pools directly: the
    card's pool and gather equal the CPU's byte for byte."""
    from repro_torch.models import attention as attn

    gen = torch.Generator().manual_seed(0)
    pool = torch.zeros(6, 4, 2, 8).to(torch.float8_e4m3fn)
    vals = torch.randn(3, 2, 2, 8, generator=gen)
    bt = torch.tensor([[1, 4], [5, 2], [3, 0]])
    flat = attn.paged_write_flat(bt, torch.tensor([0, 3, 6]), 2, 4, torch.tensor([2, 2, 1]))
    card = pool.to(dev)
    attn.paged_write(pool, vals, flat)
    attn.paged_write(card, vals.to(dev), flat.to(dev))
    assert torch.equal(card.cpu().view(torch.uint8), pool.view(torch.uint8))
    assert torch.equal(attn.paged_gather(card, bt.to(dev)).cpu().view(torch.uint8),
                       attn.paged_gather(pool, bt).view(torch.uint8))


def test_lut_train_step_on_the_card_matches_the_cpu(dev):
    """One soft-PQ step (LUT_TRAIN forward, autograd backward, AdamW) on the
    card against the same step on the CPU, from the same params and batch:
    codes equal off near-ties, loss, every gradient and the updated params
    within `testing.lut_train_step_parity`'s tolerances."""
    from repro_torch import configs
    from repro_torch.data import MarkovLM
    from repro_torch.optim import SOFT_PQ_RULES, AdamW
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.testing import lut_train_step_parity

    arch = configs.reduce_arch(configs.get_arch("qwen3_1p7b"), d_model=256, n_layers=2,
                               vocab=512, d_ff=512)
    bundle = configs.build_model(arch, "lut_train")
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    for site in (*params["segments"][1][0]["attn"].values(),
                 *params["segments"][1][0]["mlp"].values()):
        if "centroids" in site:
            site["centroids"].mul_(40.0)          # at the activations' scale
    opt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2),
                rules=SOFT_PQ_RULES)
    res = lut_train_step_parity(bundle, params, MarkovLM(vocab=512, seq_len=64,
                                                         batch=4).batch_at(0),
                                dev, opt, tie_eps=TIE_EPS)
    assert res["failures"] == [] and res["grad_leaves"] > 0 and res["updated"] > 0


@pytest.mark.parametrize("arch", ["arctic_480b", "mamba2_370m", "zamba2_1p2b", "whisper_tiny",
                                  "qwen2_vl_7b"])
def test_family_lut_train_step_on_the_card_matches_the_cpu(dev, arch):
    """One soft-PQ step of a reduced model per family (moe with its LUT_TRAIN
    expert tables and aux, ssm, hybrid, enc-dec over stub frames, vision-LM
    over embeddings with grid M-RoPE streams) on the card against the CPU:
    `testing.lut_train_step_parity`'s checks."""
    from repro_torch import configs as tcfg
    from repro_torch.optim import SOFT_PQ_RULES, AdamW
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.testing import family_batch, lut_train_step_parity
    from repro_torch.weights import tree_map_ref

    arch_spec = tcfg.reduce_arch(tcfg.get_arch(arch))
    bundle = tcfg.build_model(arch_spec, "lut_train")
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tree_map_ref(lambda p, t: t.mul_(40.0) if p.endswith("centroids") else None, params)
    opt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2), rules=SOFT_PQ_RULES)
    batch = {k: torch.from_numpy(v) for k, v in family_batch(arch_spec, 4, 32, seed=0).items()}
    res = lut_train_step_parity(bundle, params, batch, dev, opt, tie_eps=TIE_EPS)
    assert res["failures"] == [] and res["grad_leaves"] > 0 and res["updated"] > 0
    assert (res["aux_dev"] > 0) == bool(arch_spec.n_experts)


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "mamba2_370m", "whisper_tiny", "qwen2_vl_7b"])
def test_step_parity_float64_witness_on_the_card(dev, arch):
    """`lut_train_step_parity(witness=dev)` (the float64 run and the
    comparisons on the card, as chip_smoke runs it) passes where the CPU's
    witness passes, with the same codes and integers pinned in the float64
    run. The witness keeps a few fp32 constants computed on its own device
    (rope's frequencies and angles), so the two witnesses may differ by
    fp32 roundings: the float64 loss by at most 1e-9 relative, and the CPU
    fp32 gradients' gap from the witness by at most 5% of that gap (each
    gap counted as at least the harness's floor; one card run saw 0.7% on
    qwen3_1p7b's reduced embedding table), against the factor WITNESS the
    harness allows between the card's gap and the CPU's."""
    from repro_torch import configs as tcfg
    from repro_torch import testing
    from repro_torch.optim import SOFT_PQ_RULES, AdamW
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.testing import family_batch, lut_train_step_parity
    from repro_torch.weights import tree_map_ref

    arch_spec = tcfg.reduce_arch(tcfg.get_arch(arch))
    bundle = tcfg.build_model(arch_spec, "lut_train")
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tree_map_ref(lambda p, t: t.mul_(40.0) if p.endswith("centroids") else None, params)
    opt = AdamW(lr=cosine_with_warmup(1e-2, total_steps=10, warmup_steps=2), rules=SOFT_PQ_RULES)
    batch = {k: torch.from_numpy(v) for k, v in family_batch(arch_spec, 4, 32, seed=0).items()}
    on_cpu = lut_train_step_parity(bundle, params, batch, dev, opt, tie_eps=TIE_EPS)
    on_card = lut_train_step_parity(bundle, params, batch, dev, opt, tie_eps=TIE_EPS,
                                    witness=dev)
    assert on_cpu["failures"] == [] and on_card["failures"] == []
    assert abs(on_card["loss_f64"] - on_cpu["loss_f64"]) <= 1e-9 * abs(on_cpu["loss_f64"])
    assert on_card["grad_leaves"] == on_cpu["grad_leaves"]
    for key in ("pinned_codes", "rounding_flips"):
        assert on_card[key]["float64"] == on_cpu[key]["float64"], key
    floors = (testing.FLOOR_L2, testing.FLOOR_MAX)
    for leaf, e in on_cpu["grad_errs"].items():
        for a, b, floor in zip(on_card["grad_errs"][leaf]["cpu_f64"], e["cpu_f64"], floors):
            assert abs(a - b) <= 0.05 * max(b, floor), (leaf, a, b)


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_1p2b", "arctic_480b"])
def test_family_engine_through_kernels_matches_plain(dev, arch, tmp_path, monkeypatch):
    """One reduced model per family (ssm, hybrid, moe) served on the card:
    every LUT site through the kernels (launched, no plain version called)
    gives the tokens of the same engine over the plain versions; prompts of
    one chunk, two chunks and a ragged one, three requests on two slots."""
    from repro_torch import configs as tcfg
    from repro_torch.serving.engine import ServingEngine

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)
    arch_spec = tcfg.reduce_arch(tcfg.get_arch(arch), n_layers=5 if arch == "zamba2_1p2b" else 2,
                                 lut_use_kernel=True)
    bundle = tcfg.build_model(arch_spec, "lut_infer")
    params = bundle.init(torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, arch_spec.vocab, (n,), generator=gen).tolist() for n in (8, 16, 5)]

    def serve():
        eng = ServingEngine(bundle, params, n_slots=2, max_seq=32, prefill_chunk=8, device=dev)
        for p in prompts:
            eng.submit(p, max_tokens=6)
        done = sorted(eng.run_until_done(), key=lambda r: r.rid)
        assert all(r.status == "ok" for r in done)
        return [r.out_tokens for r in done]

    counters.reset()
    got = serve()
    launched = counters.launches()
    assert counters.plain_calls() == 0
    assert launched["fused_decode"] + launched["lut_amm_v2"] + launched["lut_amm_v1"] > 0
    monkeypatch.setattr(ops, "lut_amm", lambda x, c, q, s, *, bias=None, act="none", **_:
                        ref.lut_amm_v2_plain(x, c, q, s, bias=bias, act=act))
    assert serve() == got


@pytest.mark.parametrize("arch", ["whisper_tiny", "qwen2_vl_7b"])
def test_encdec_and_vlm_forward_steps_through_kernels_match_plain(dev, arch, tmp_path,
                                                                  monkeypatch):
    """One reduced model of each family the engine refuses, driven by
    `forward_step` on the card: a prefill (with frames, or of embeddings)
    and 6 greedy steps through the kernels (launched, no plain version
    called) give the greedy tokens of the same steps over the plain
    versions."""
    from repro_torch import configs as tcfg

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)
    bundle = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch(arch), lut_use_kernel=True),
                              "lut_infer")
    params = bundle.init(torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator().manual_seed(1)
    a = bundle.arch
    if arch == "whisper_tiny":
        first = {"tokens": torch.randint(1, a.vocab, (2, 8), generator=gen,
                                         dtype=torch.int32).to(dev),
                 "frames": torch.randn(2, a.enc_frames, a.d_model, generator=gen).to(dev)}
        feed = lambda t: {"tokens": t.to(torch.int32)}                        # noqa: E731
    else:
        first = {"embeds": torch.randn(2, 8, a.d_model, generator=gen).to(dev) * 0.02}
        feed = lambda t: {"embeds": params["embed"]["table"][t]}              # noqa: E731

    def greedy():
        caches = bundle.init_caches(2, 32, dtype=torch.float32, device=dev)
        batch, cl, out = dict(first, cache_len=torch.zeros(2, dtype=torch.long)), 0, []
        with torch.inference_mode():
            for _ in range(7):
                logits, caches = bundle.forward_step(params, batch, caches)
                out.append(logits[:, -1].argmax(-1))
                cl += logits.shape[1]
                batch = dict(feed(out[-1][:, None]), cache_len=torch.full((2,), cl))
        return torch.stack(out, 1).cpu()

    counters.reset()
    got = greedy()
    launched = counters.launches()
    assert counters.plain_calls() == 0
    assert launched["fused_decode"] + launched["lut_amm_v2"] + launched["lut_amm_v1"] > 0
    monkeypatch.setattr(ops, "lut_amm", lambda x, c, q, s, *, bias=None, act="none", **_:
                        ref.lut_amm_v2_plain(x, c, q, s, bias=bias, act=act))
    assert torch.equal(greedy(), got)


def test_tp2_on_one_card_matches_the_unsharded_engine(dev, tmp_path, monkeypatch):
    """Tensor parallelism at tp 2 with both ranks on the one card (gloo, two
    processes): the dense, paged and artifact-loaded engines give the
    unsharded engine's tokens, logits within 1e-3, every rank launches the
    kernels and never a plain version."""
    # by its file's directory, which pytest puts on sys.path: a "tests"
    # package installed beside torch may shadow this directory's name
    import numpy as np
    from _tp_ranks import run_ranks, serve_variant

    from repro_torch.serving.artifact import save_artifact

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)
    bundle, params, _ = _engine_model(dev)
    save_artifact(tmp_path / "art", bundle, params)
    ranks = run_ranks(serve_variant, 2, str(tmp_path / "art"), devices=["cuda:0", "cuda:0"])
    for case in ("dense", "paged", "artifact"):
        want = ranks[0]["plain"][case]
        assert ranks[0]["tp"][case]["tokens"] == want["tokens"], case
        for rank in ranks:
            got = rank["tp"][case]
            assert got["plain_calls"] == 0 and sum(got["launches"].values()) > 0, case
            assert len(got["logits"]) == len(want["logits"])
            for (g, lens), (w, _) in zip(got["logits"], want["logits"]):
                # the positions a forward writes; padding reads the pool's
                # garbage page, whose contents the two engines do not share
                valid = np.arange(g.shape[1])[None, :] < lens[:, None]
                assert abs(g - w)[valid].max() <= 1e-3, case


def test_dp2_on_one_card_matches_the_single_rank_step(dev):
    """chip_smoke phase 13 (a) at reduced size: the data-parallel step with
    ZeRO-1 moments at dp 2, both ranks on the one card (gloo, two
    processes), against the single-rank step on the card: the loss within
    1e-5 relative at every step, the params after one step within
    `testing.AdamLeafRule`, after three the params and moments no further
    from the float64 steps than the single-rank run (`testing.WITNESS`),
    both ranks' params bytewise equal, no LUT kernel and no plain version
    (a dense model)."""
    import numpy as np
    from _tp_ranks import dp_model, dp_single, dp_train, run_ranks

    from repro_torch.testing import WITNESS, witness_ratio
    from repro_torch.weights import tree_from_reference, tree_map_ref

    spec = dict(arch="qwen3_1p7b", layers=2, vocab=512, d=256, d_ff=512, mode="dense",
                lr=1e-3, clip=1.0, batch=4, seq=64, device="cuda:0")
    steps = 3
    ranks = run_ranks(dp_train, 2, spec, None, steps, devices=["cuda:0", "cuda:0"], axis="data")
    losses, states, rule, start = dp_single(spec, None, steps)
    _, exact, _, _ = dp_single(spec, None, steps, float64=True)
    _, params, opt, _ = dp_model(spec)
    like = {"params": params, "opt": opt.init(params)}
    single = tree_from_reference(like, states[-1])
    witness = tree_from_reference({"params": tree_map_ref(lambda _p, t: t.double(), params),
                                   "opt": like["opt"]}, exact[-1])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-5)
        worst, where = rule.check(tree_from_reference(params, r["params_1"]),
                                  tree_from_reference(like, states[0])["params"], start)
        assert worst <= 1.0, (worst, where)
        got = tree_from_reference(like, r["arrays"])
        for key, base in (("params", start), ("opt", None)):
            ratio, where = witness_ratio(got[key], single[key], witness[key], base)
            assert ratio <= WITNESS, (key, ratio, where)
        assert r["plain"] == 0 and sum(r["launches"].values()) == 0
    for path, a in ranks[0]["params"].items():
        np.testing.assert_array_equal(a, ranks[1]["params"][path], err_msg=path)


@pytest.mark.parametrize("mode", ["dense", "lut_train"])
def test_tp_checkpointed_backward_finds_its_mesh_on_the_card(dev, mode):
    """A tensor-parallel training rank's backward on the card runs on the
    autograd engine's device thread, where the forward's mesh binding (a
    context variable) is not set: the `copy`/`reduce` functions keep their
    mesh, and each recomputed block re-binds it. On a (1, 2) mesh with both
    ranks on the card (gloo), the gradients of a checkpointed forward (the
    train step's activation recomputation) equal the single-rank gradients
    on the card, and the model axis ran the forward's reduces again in the
    recomputation."""
    import numpy as np
    from _tp_ranks import run_ranks, tp_single_grads, tp_train

    from repro_torch.testing import GRAD_L2, GRAD_MAX, _rel

    spec = dict(arch="qwen3_1p7b", layers=2, vocab=512, d=256, d_ff=512, mode=mode,
                lr=1e-3, clip=1.0, batch=4, seq=64, device="cuda:0")
    ranks = run_ranks(tp_train, 2, spec, None, 1, devices=["cuda:0", "cuda:0"], axis=(1, 2))
    single = tp_single_grads(spec)
    for r in ranks:
        assert abs(r["grad_loss"] - single["loss"]) <= 1e-5 * abs(single["loss"])
        for path, want in single["grads"].items():
            if path.endswith("log_t"):           # a cancelling sum: chip_smoke phase 14 holds it
                continue
            l2, mx = _rel(torch.as_tensor(r["grads"][path]), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (path, l2, mx)
        # 2 layers x (o, down) reduced in the forward and again in the recomputation
        assert r["grad_counters"]["model"]["all_reduce"] >= 2 * 2 * 2
        assert np.isfinite(r["loss"]).all()
