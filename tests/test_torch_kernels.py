"""The port's LUT kernel modules against the JAX Pallas kernels.

Given CPU tensors, the wrappers run their plain versions, which are held
against `fused_decode_pallas`, `lut_amm_pallas`, `lut_amm_pallas_v1` and
`encode_pallas` in interpret mode (how the JAX package's own tests run them). The CUDA kernels themselves are
held against the same plain versions on the card by tests/test_torch_cuda.py
and by chip_smoke.py.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.dist_argmin import encode_pallas
from repro.kernels.fused_decode import fused_decode_pallas
from repro.kernels.lut_amm import lut_amm_pallas, lut_amm_pallas_v1
from repro.kernels.ref import encode_ref as jencode_ref
from repro.kernels.ref import lut_amm_ref as jlut_amm_ref
from repro_torch.kernels import autotune, counters
from repro_torch.kernels import dist_argmin as enc_mod
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.kernels import ops, ref
from repro_torch.testing import (
    CLUSTER_SHAPES,
    LAYOUTS,
    RAGGED,
    WIDE_SITES,
    make_amm_inputs,
    quantize_np,
    tie_gaps,
)

ACTS = ("none", "relu", "silu", "gelu", "relu2")
# acts whose epilogue is exact arithmetic (max, multiply): byte-identical;
# silu/gelu go through exp/tanh, whose XLA and ATen implementations may
# differ in the last ulp
EXACT_ACTS = ("none", "relu", "relu2")
TIE_EPS = 1e-5        # relative distance gap that explains a differing code
# RAGGED x LAYOUTS, with (act, bias) rotating so that every one of the 10
# (act, bias) pairs runs twice across the layouts
CASES = [(shape, layout, ACTS[i % 5], i % 2 == 0)
         for i, (shape, layout) in enumerate((s, l) for s in RAGGED for l in LAYOUTS)]
CASE_IDS = [f"{s[:5]}-{l}-{a}-{'bias' if b else 'nobias'}" for s, l, a, b in CASES]

JAX_KERNELS = {"fused": fused_decode_pallas, "v2": lut_amm_pallas}
PORT_PLAIN = {"fused": ref.fused_decode_plain, "v2": ref.lut_amm_v2_plain}


def _inputs(shape, layout, seed):
    n, d, m, k, v = shape
    x, P, T, b = make_amm_inputs(n, d, m, k, v, seed=seed)
    q, s = quantize_np(T, layout)
    return x, P, q, s, b


def _check_against_jax(kernel, x, P, q, s, b, act):
    bias = b
    want = np.asarray(JAX_KERNELS[kernel](
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(q), jnp.asarray(s),
        bias=None if bias is None else jnp.asarray(bias), act=act, interpret=True))
    got = PORT_PLAIN[kernel](
        torch.from_numpy(x), torch.from_numpy(P), torch.from_numpy(q), torch.from_numpy(s),
        bias=None if bias is None else torch.from_numpy(bias), act=act).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype

    # rows whose codes agree must match; a differing code must be a near-tie
    codes_ref = torch.from_numpy(np.array(jencode_ref(jnp.asarray(x), jnp.asarray(P))))
    codes = ref.encode_ref(torch.from_numpy(x), torch.from_numpy(P))
    gaps = tie_gaps(torch.from_numpy(x), torch.from_numpy(P), codes, codes_ref)
    assert (gaps <= TIE_EPS).all(), f"codes differ off a near-tie: {gaps}"
    rows = (codes == codes_ref).all(dim=1).numpy()
    if s.shape[0] == 1 and act in EXACT_ACTS:
        # m-shared / scalar: exact int32 sums, then one rounding of
        # (float)acc * s (+ bias, which XLA:CPU contracts into one fused
        # multiply-add and the port computes as one) -> byte-identical
        np.testing.assert_array_equal(got[rows], want[rows])
    else:
        # fp32 per-codebook sums in another order; ulp-level exp/tanh
        np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kernel", ["fused", "v2"])
@pytest.mark.parametrize("shape,layout,act,bias", CASES, ids=CASE_IDS)
def test_plain_matches_pallas_ragged_layouts(kernel, shape, layout, act, bias):
    x, P, q, s, b = _inputs(shape, layout, seed=sum(shape))
    _check_against_jax(kernel, x, P, q, s, b if bias else None, act)


def test_lut_amm_ref_matches_reference_oracle():
    x, P, q, s, _ = _inputs(RAGGED[1], "per_column", seed=2)
    want = np.asarray(jlut_amm_ref(jnp.asarray(x), jnp.asarray(P), jnp.asarray(q),
                                   jnp.asarray(s)))
    got = ref.lut_amm_ref(torch.from_numpy(x), torch.from_numpy(P), torch.from_numpy(q),
                          torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)   # the reference's bound


def test_fused_and_v2_plain_agree_bytewise_on_m_shared():
    x, P, q, s, b = [torch.from_numpy(a) for a in _inputs(RAGGED[4], "m_shared", seed=9)]
    a = ref.fused_decode_plain(x, P, q, s, bias=b, act="relu")
    c = ref.lut_amm_v2_plain(x, P, q, s, bias=b, act="relu")
    assert torch.equal(a, c)


def test_bf16_input_writes_bf16():
    x, P, q, s, _ = [torch.from_numpy(a) for a in _inputs(RAGGED[2], "m_shared", seed=4)]
    out = ops.lut_amm(x.bfloat16(), P, q, s)
    assert out.dtype == torch.bfloat16 and out.shape == (x.shape[0], q.shape[-1])
    # the same codes as the fp32 input of the bf16-rounded values
    want = ref.fused_decode_plain(x.bfloat16().float(), P, q, s).bfloat16()
    assert torch.equal(out, want)


def test_ops_cpu_runs_plain_versions_and_launches_nothing():
    counters.reset()
    x, P, q, s, b = [torch.from_numpy(a) for a in _inputs(RAGGED[0], "m_shared", seed=1)]
    for version in (None, 1, 2, 3):
        ops.lut_amm(x, P, q, s, bias=b, version=version)
    ops.encode(x, P)
    assert set(counters.launches().values()) == {0}
    assert ref.calls == {"fused_decode_plain": 2, "lut_amm_v2_plain": 1, "lut_amm_v1_plain": 1,
                         "encode_plain": 1}
    # version=1 dispatches to v1: its fp32 sums plus bias in x's dtype
    want = ref.lut_amm_v1_plain(x, P, q, s) + b
    assert torch.equal(ops.lut_amm(x, P, q, s, bias=b, version=1), want)
    with pytest.raises(ValueError):
        ops.lut_amm(x, P, q, s, version=4)


V1_LAYOUTS = ("per_codebook", "per_column")         # the (C, ...) scales v1 takes


@pytest.mark.parametrize("layout", V1_LAYOUTS)
@pytest.mark.parametrize("shape", RAGGED, ids=[str(s[:5]) for s in RAGGED])
def test_plain_v1_matches_pallas_v1(shape, layout):
    """fp32 sums of t * s in another order than XLA's: the reference's own
    bound (tests/test_kernels.py), on rows whose codes agree; a differing
    code must sit on a near-tie."""
    x, P, q, s, _ = _inputs(shape, layout, seed=sum(shape) + 3)
    want = np.asarray(lut_amm_pallas_v1(jnp.asarray(x), jnp.asarray(P), jnp.asarray(q),
                                        jnp.asarray(s), interpret=True))
    got = ref.lut_amm_v1_plain(*(torch.from_numpy(a) for a in (x, P, q, s))).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    codes_ref = torch.from_numpy(np.array(jencode_ref(jnp.asarray(x), jnp.asarray(P))))
    codes = ref.encode_ref(torch.from_numpy(x), torch.from_numpy(P))
    assert (tie_gaps(torch.from_numpy(x), torch.from_numpy(P), codes, codes_ref) <= TIE_EPS).all()
    rows = (codes == codes_ref).all(dim=1).numpy()
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_ops_v1_matches_reference_ops_v1(act, dtype):
    """ops.lut_amm(version=1) against the reference's: m-shared scale
    broadcast over C, bias and activation added outside the kernel in x's
    dtype. bf16: one bf16 rounding of each of the output, the bias add and
    the activation, in either package."""
    x, P, q, s, b = _inputs(RAGGED[1], "m_shared", seed=11)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jops.lut_amm(jx, jnp.asarray(P), jnp.asarray(q), jnp.asarray(s),
                                   bias=jnp.asarray(b), act=act, version=1).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.lut_amm(tx, torch.from_numpy(P), torch.from_numpy(q), torch.from_numpy(s),
                      bias=torch.from_numpy(b), act=act, version=1)
    assert got.dtype == tx.dtype
    codes = ref.encode_ref(tx, torch.from_numpy(P))
    codes_ref = torch.from_numpy(np.array(jencode_ref(jx, jnp.asarray(P))))
    rows = (codes == codes_ref).all(dim=1).numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy()[rows], want[rows], rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("shape", RAGGED, ids=[str(s[:5]) for s in RAGGED])
def test_plain_encode_matches_encode_pallas(shape):
    """Codes equal except where the fp32 distances of the two choices tie."""
    x, P, _, _, _ = _inputs(shape, "m_shared", seed=sum(shape) + 5)
    want = torch.from_numpy(np.array(encode_pallas(jnp.asarray(x), jnp.asarray(P),
                                                   interpret=True)))
    got = ops.encode(torch.from_numpy(x), torch.from_numpy(P))
    assert got.dtype == torch.int32 and got.shape == want.shape
    gaps = tie_gaps(torch.from_numpy(x), torch.from_numpy(P), got, want)
    assert (gaps <= TIE_EPS).all(), f"codes differ off a near-tie: {gaps}"


def test_plain_encode_differing_codes_sit_on_ties():
    """Rows built to tie: x halfway between two centroids of a codebook. The
    two packages' fp32 sums may pick either, and each differing code shows a
    relative gap within TIE_EPS."""
    x, P, _, _, _ = _inputs(RAGGED[2], "m_shared", seed=21)
    c, k, v = P.shape
    for row in range(0, x.shape[0], 2):          # every other row on an exact midpoint
        for ci in range(c):
            x[row, ci * v:(ci + 1) * v] = 0.5 * (P[ci, 0] + P[ci, 1])
    want = torch.from_numpy(np.array(encode_pallas(jnp.asarray(x), jnp.asarray(P),
                                                   interpret=True)))
    got = ops.encode(torch.from_numpy(x), torch.from_numpy(P))
    gaps = tie_gaps(torch.from_numpy(x), torch.from_numpy(P), got, want)
    assert (gaps <= TIE_EPS).all()
    assert bool((got[1::2] == want[1::2]).all())     # rows off the midpoints agree


@pytest.mark.parametrize("c,k,v,version", [(64, 16, 32, 3), (192, 16, 32, 2),
                                           (8, 16, 8, 3), (128, 16, 32, 2), (192, 16, 16, 3)])
def test_fit_rule(c, k, v, version):
    """qwen3_1p7b at lut_v=32: q/k/v/o/gate/up (C=64) run fused, down (C=192,
    384 KiB of centroids) does not fit in 227 KB and runs v2."""
    assert autotune.fit_version(c, k, v) == version
    assert fused_mod.fits(c, k, v) == (fused_mod.smem_bytes(c, k, v) <= v2_mod.MAX_SMEM)


def _check_cluster_launch(geo, n, c, m, k=16):
    """What every cluster launch must satisfy on an H100."""
    s = geo["cluster"]
    assert s == v2_mod.default_cluster(c) and s <= c and geo["grid_x"] % s == 0
    assert s in v2_mod.CLUSTER_SIZES
    # the ranks' codebook shares partition [0, C), as the kernel cuts them,
    # and every rank owns one at least (it issues the table's copies)
    shares = [range(r * c // s, (r + 1) * c // s) for r in range(s)]
    assert [cb for share in shares for cb in share] == list(range(c))
    assert 1 <= min(map(len, shares)) and max(map(len, shares)) <= v2_mod.cdiv(c, s)
    # every column is covered by exactly one block of each N tile, every row by one tile
    tw = 4 * geo["quads"]
    cover = [0] * m
    for bx in range(geo["grid_x"]):
        for mt in range(bx * geo["tiles_per_block"], (bx + 1) * geo["tiles_per_block"]):
            for col in range(mt * tw, min(m, (mt + 1) * tw)):
                cover[col] += 1
    assert cover == [1] * m
    assert geo["n_tiles"] * geo["rows"] >= n > (geo["n_tiles"] - 1) * geo["rows"]
    # the layout: codes, then the centroid region, ring and barriers, in bounds
    assert geo["cent_off"] >= geo["rows"] * c
    assert geo["cent_off"] <= geo["ring_off"] <= geo["bar_off"] <= geo["smem"] <= v2_mod.MAX_SMEM
    if geo["staged"]:
        assert geo["tiles_per_block"] == 1 and tw % 16 == 0
        if geo["rows"] <= v2_mod.BLOCK_N:     # decode copies the whole tile, no TMA ring
            assert geo["n_stages"] == geo["stage_c"] == 0
            assert geo["bar_off"] - geo["ring_off"] >= c * k * tw
        else:                                 # the row split's registers hold the rows
            assert geo["bar_off"] - geo["ring_off"] >= geo["n_stages"] * geo["stage_c"] * k * tw
            assert geo["n_stages"] >= 1 and geo["stage_c"] >= 1
            assert geo["rows"] <= v2_mod.STAGED_ROWS_PER_THREAD * 8 * (32 // geo["quads"])
            assert v2_mod.ring_boxes(geo["stage_c"] * k, tw) > 0
    else:
        assert geo["ring_off"] - geo["cent_off"] >= v2_mod.RED_BYTES


@pytest.mark.parametrize("n", [4, 128])
@pytest.mark.parametrize("c,m", [(64, 2048), (64, 1024), (64, 6144), (192, 2048)])
def test_launch_geometry_fills_the_card(n, c, m):
    """Decode (N=4) and a prefill chunk (N=128) at qwen3_1p7b's sites: the
    fused kernel (C=64) and v2 launch clusters whose ranks split the
    codebooks and whose blocks cover every column once, within shared
    memory; every launch runs one wave on an H100, and the table tiles are
    staged at every site (at decode the whole tile, down's 96 KiB too)."""
    # an H100 SXM holds 7 clusters of 16 at once with one block per SM
    # (cudaOccupancyMaxActiveClusters, which the wrapper queries)
    wave = 7 * 16
    kernels = [True] + ([False] if c == 64 else [])
    for chunked in kernels:
        geo = v2_mod.cluster_geometry(n, c, 16, 32, m, wave, chunked=chunked)
        _check_cluster_launch(geo, n, c, m)
        blocks = geo["n_tiles"] * geo["grid_x"]
        # one wave: no more clusters than the card holds at once
        assert 64 <= blocks <= wave
        # prefill stages its table tiles by TMA; decode copies its whole tile
        assert geo["cluster"] == 16 and geo["staged"] and (geo["n_stages"] > 0) == (n == 128)
        if chunked:
            assert geo["chunk_c"] == v2_mod.cdiv(c, 16)   # down: 12 codebooks, one chunk


# the enc-dec and vlm families' sites at the token counts chip_smoke phase 9
# gives them, (N, C, M): whisper_tiny at decode (4 rows), its prefill (32)
# and its encoder and cross K/V (4 rows x 1500 frames); qwen2_vl_7b at
# decode and its prefill of 4 x 40 embeddings (down: C = 592)
FAMILY_SITES = [(n, c, m) for n in (4, 32, 6000) for c, m in ((12, 384), (12, 1536), (48, 384))]
FAMILY_SITES += [(n, c, m) for n in (4, 160)
                 for c, m in ((112, 3584), (112, 512), (112, 18944), (592, 3584))]


@pytest.mark.parametrize("n,c,m", FAMILY_SITES, ids=[str(s) for s in FAMILY_SITES])
def test_launch_geometry_at_family_sites(n, c, m):
    """Every kernel's default launch and every launch the tuner may pick at
    the new families' sites fits a block and covers the output once: C = 12
    (clusters of 8, ranks owning 1-2 codebooks), N = 6000 (94-188 N tiles),
    C = 592 (cluster of 16, shares of 37)."""
    wave = 7 * 16
    for version in (2, 3, 1):
        if version == 3 and not fused_mod.fits(c, 16, 32):
            continue
        for cfg in [None] + autotune.candidates("lut_amm", n, m, c, 16, 32, version=version):
            if version == 1:
                geo = v2_mod.v1_geometry(n, c, 16, 32, m, wave,
                                         **({} if cfg is None else autotune.v1_launch(cfg)))
            else:
                geo = v2_mod.cluster_geometry(n, c, 16, 32, m, wave, chunked=version == 2,
                                              **({} if cfg is None else
                                                 autotune.cluster_launch(cfg)))
            _check_cluster_launch(geo, n, c, m)
    assert v2_mod.default_cluster(c) == {12: 8, 48: 16, 112: 16, 592: 16}[c]
    for cfg in [None] + autotune.candidates("encode", n, 0, c, 16, 32):
        kw = {} if cfg is None else autotune.encode_launch(cfg, n, c, 16, 32)
        assert enc_mod.encode_geometry(n, c, 16, 32, 132, **kw)["smem"] <= v2_mod.MAX_SMEM


@pytest.mark.parametrize("site", WIDE_SITES, ids=[str(s) for s in WIDE_SITES])
def test_launch_geometry_at_wide_sites(site):
    """Sites past V = 32 / K = 256 (chip_smoke phase 2 runs them): every
    launch fits a block, the codes region holds two bytes a code above
    K = 256, a codebook of more than 256 rows stages as one ring stage of
    two equal TMA boxes (or not by TMA, where they would not start 128-byte
    aligned), the fit rule sends K > 256 at V = 32 to v2; past the envelope
    the wrappers' check raises, naming it."""
    c, k, v, m = site
    assert v2_mod.code_bytes(k) == (2 if k > 256 else 1)
    fits = fused_mod.fits(c, k, v)
    assert autotune.fit_version(c, k, v) == (3 if fits else 2) and fits == (k <= 256)
    for n in (4, 20, 128):
        for chunked in (True, False) if fits else (True,):
            geo = v2_mod.cluster_geometry(n, c, k, v, m, 112, chunked=chunked)
            _check_cluster_launch(geo, n, c, m, k)
            assert geo["epi_off"] >= geo["rows"] * c * v2_mod.code_bytes(k)
            if geo["n_stages"]:
                assert geo["stage_c"] * k <= max(k, v2_mod.MAX_BOX_ROWS)
                boxes = v2_mod.ring_boxes(geo["stage_c"] * k, 4 * geo["quads"])
                assert boxes == (2 if k > v2_mod.MAX_BOX_ROWS else 1)
                assert geo["stage_c"] * k // boxes * 4 * geo["quads"] % v2_mod.TMA_ALIGN == 0
        geo = enc_mod.encode_geometry(n, c, k, v, 132)
        assert geo["smem"] <= v2_mod.MAX_SMEM
    for kk, vv in ((2 * v2_mod.MAX_K, v), (k, 2 * v2_mod.MAX_V)):
        with pytest.raises(ValueError, match="envelope"):
            v2_mod.check_envelope(kk, vv)


@pytest.mark.parametrize("k,boxes", [(256, 1), (300, 2), (301, 0), (384, 2), (512, 2)])
def test_ring_stage_splits_into_equal_tma_boxes(k, boxes):
    """A codebook of more than 256 rows is one ring stage of two equal TMA
    boxes (the kernel's box_rows), never a 256-row box that would run past
    its slot; a stage of an odd row count, or whose boxes would not start
    128-byte aligned, is not staged by TMA and the lookup gathers from
    global memory at every N tile and M tile."""
    assert v2_mod.ring_boxes(k, 128) == boxes      # 32 column quads: 128-byte rows
    if boxes:
        assert k % boxes == 0 and k // boxes <= v2_mod.MAX_BOX_ROWS
    assert v2_mod.ring_boxes(300, 16) == 0       # 150 rows x 16 columns: 2400 B, unaligned
    for n in (20, 128):
        for quads in v2_mod.STAGED_QUADS:
            geo = v2_mod.cluster_geometry(n, 64, k, 32, 2048, 112, chunked=True, quads=quads)
            _check_cluster_launch(geo, n, 64, 2048, k)
            assert geo["n_stages"] == 0 or boxes
    geo = v2_mod.cluster_geometry(128, 64, k, 32, 2048, 112, chunked=True, quads=32)
    assert (geo["n_stages"] > 0) == (boxes > 0)


@pytest.mark.parametrize("wave", [8, 16, 64, 112, 132])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES, ids=[str(s[:5]) for s in CLUSTER_SHAPES])
def test_launch_geometry_on_ragged_shapes(shape, wave):
    """Every N tile and kernel on the ragged shapes, whose C (1 to 20) take
    clusters of 1 to 16 and need not divide by them, at waves from 8 blocks
    (a card holding few clusters at once) to an H100's 132 SMs."""
    n, d, m, k, v = shape
    c = d // v
    for chunked in (False, True):
        for rows in v2_mod.ROW_TILES:
            for aligned in (True, False):
                geo = v2_mod.cluster_geometry(n, c, k, v, m, wave, chunked=chunked, rows=rows,
                                              aligned=aligned)
                _check_cluster_launch(geo, n, c, m, k)
                assert geo["rows"] == rows
                # TMA needs aligned rows; a prefill-sized tile always stages
                assert geo["staged"] <= aligned
                assert geo["staged"] or not (aligned and rows >= v2_mod.STAGED_ROWS)


def test_cluster_launch_reads_old_records():
    """A record names rows per N tile and the M tile (block_c 0); a record
    written for the one-block kernels (block_c = C fused, v2's chunk) takes
    the default launch, whatever its other fields."""
    assert autotune.cluster_launch(autotune.BlockConfig(32, 64, 0)) == {"rows": 32, "quads": 16}
    assert autotune.cluster_launch(autotune.BlockConfig(0, 0, 0)) == \
        {"rows": None, "quads": None}
    for old in (autotune.BlockConfig(8, 16, 64), autotune.BlockConfig(8, 0, 64),
                autotune.BlockConfig(8, 512, 32)):
        assert autotune.cluster_launch(old) == {"rows": None, "quads": None}
    with pytest.raises(ValueError, match="rows"):
        v2_mod.cluster_geometry(4, 64, 16, 32, 2048, 112, chunked=False, rows=12)
    with pytest.raises(ValueError, match="shared memory"):
        v2_mod.cluster_geometry(128, 1024, 16, 32, 2048, 112, chunked=False, rows=64)


# qwen3_1p7b's LUT sites at lut_v = 32: (C, M) of q/o, k/v, gate/up, down
PATH_SITES = [(64, 2048), (64, 1024), (64, 6144), (192, 2048)]
N_SMS = 132                      # an H100 SXM's SMs


def _check_v1_launch(geo, n, c, m, k, v, wave, launch):
    """A v1 launch is v2's cluster launch with v1's chunk of the sum."""
    _check_cluster_launch(geo, n, c, m, k)
    assert geo["block_c"] == ref.v1_block_c(c, v, launch.get("block_c"))
    assert c % geo["block_c"] == 0
    v2 = v2_mod.cluster_geometry(n, c, k, v, m, wave, chunked=True, rows=launch.get("rows"),
                                 quads=launch.get("quads"))
    assert {**v2, "block_c": geo["block_c"]} == geo
    if launch.get("rows"):
        assert geo["rows"] == launch["rows"]
    if launch.get("quads"):
        assert geo["quads"] == launch["quads"]


def _check_encode_launch(geo, n, c, k, v):
    """Every row and codebook in exactly one block, every block owning at
    least one codebook and one row, within a block's shared memory."""
    rows, cc = geo["rows"], geo["chunk_c"]
    assert (geo["n_tiles"] - 1) * rows < n <= geo["n_tiles"] * rows
    assert (geo["n_chunks"] - 1) * cc < c <= geo["n_chunks"] * cc
    assert geo["blocks"] == geo["n_tiles"] * geo["n_chunks"]
    assert geo["smem"] == enc_mod.smem_bytes(rows, cc, k, v) <= v2_mod.MAX_SMEM


@pytest.mark.parametrize("n", [4, 128])
@pytest.mark.parametrize("c,m", PATH_SITES)
def test_v1_and_encode_geometry_at_path_shapes(n, c, m):
    """v1 launches v2's clusters (16 ranks, every rank owning codebooks,
    every column covered once, within shared memory; the table staged) with
    the reference's chunk of the sum; the encode's default puts at least
    one block on every SM at decode and at a prefill chunk."""
    wave = 7 * 16
    geo = v2_mod.v1_geometry(n, c, 16, 32, m, wave)
    _check_v1_launch(geo, n, c, m, 16, 32, wave, {})
    assert geo["cluster"] == 16 and geo["staged"] and geo["block_c"] == 64
    enc = enc_mod.encode_geometry(n, c, 16, 32, N_SMS)
    _check_encode_launch(enc, n, c, 16, 32)
    assert enc["blocks"] >= N_SMS


@pytest.mark.parametrize("shape", RAGGED, ids=[str(s[:5]) for s in RAGGED])
def test_v1_and_encode_geometry_on_ragged_shapes(shape):
    """Every N tile, chunk of the sum and wave of v1, and the encode's
    default and every block it may be given, on the ragged shapes."""
    n, d, m, k, v = shape
    c = d // v
    for wave in (8, 64, 132):
        for rows in v2_mod.ROW_TILES:
            for bc in (None, 1, c):
                launch = {"rows": rows, "block_c": bc}
                _check_v1_launch(v2_mod.v1_geometry(n, c, k, v, m, wave, **launch), n, c, m, k,
                                 v, wave, launch)
    enc = enc_mod.encode_geometry(n, c, k, v, N_SMS)
    _check_encode_launch(enc, n, c, k, v)
    # a shape with fewer (row, codebook) pairs than SMs takes one block per pair
    assert enc["blocks"] >= min(N_SMS, n * c)
    for rows in (1, 5, 8, 32, 64):
        for cc in (1, 3, c, 2 * c):
            geo = enc_mod.encode_geometry(n, c, k, v, N_SMS, block_n=rows, block_c=cc)
            assert (geo["rows"], geo["chunk_c"]) == (rows, min(cc, c))
            _check_encode_launch(geo, n, c, k, v)
    with pytest.raises(ValueError, match="shared memory"):
        enc_mod.encode_geometry(n, 4096, k, v, N_SMS, block_n=64, block_c=4096)


@pytest.mark.parametrize("n", [4, 128])
@pytest.mark.parametrize("c,m", PATH_SITES)
def test_every_v1_and_encode_candidate_fits_or_is_refused(n, c, m):
    """What the tuner sweeps for v1 and the encode at the path shapes
    launches as named, or the wrapper refuses it with ValueError (which the
    tuner skips); at these shapes every candidate fits."""
    wave, fitted = 7 * 16, 0
    cands = autotune.candidates("lut_amm", n, m, c, 16, 32, 1)
    for cfg in cands:
        launch = autotune.v1_launch(cfg)
        try:
            geo = v2_mod.v1_geometry(n, c, 16, 32, m, wave, **launch)
        except ValueError:
            continue
        _check_v1_launch(geo, n, c, m, 16, 32, wave, launch)
        fitted += 1
    enc = autotune.candidates("encode", n, 0, c, 16, 32)
    for cfg in enc:
        try:
            geo = enc_mod.encode_geometry(n, c, 16, 32, N_SMS, block_n=cfg.block_n,
                                          block_c=cfg.block_c)
        except ValueError:
            continue
        assert (geo["rows"], geo["chunk_c"]) == (cfg.block_n, cfg.block_c)
        _check_encode_launch(geo, n, c, 16, 32)
        fitted += 1
    assert fitted == len(cands) + len(enc)


def test_wrappers_refuse_non_cuda_devices_without_fallback():
    """A tensor that is neither on the CPU nor on a card is refused: the
    plain version is taken only for CPU tensors."""
    x = torch.empty((4, 64), device="meta")
    P = torch.empty((2, 16, 32), device="meta")
    q = torch.empty((2, 16, 8), dtype=torch.int8, device="meta")
    s = torch.empty((1, 1, 8), device="meta")
    for fn in (fused_mod.fused_decode, v2_mod.lut_amm_v2):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, P, q, s)


def test_kernel_modules_import_without_nvcc_or_card():
    code = ("import repro_torch.kernels.build as b, repro_torch.kernels.fused_decode, "
            "repro_torch.kernels.lut_amm, repro_torch.kernels.ops; "
            "assert b.lib_path('fused_decode').name.startswith('libfused_decode-'); "
            "assert not b._LIBS; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("policy", [{"v": 64}, {"k": 512}], ids=["v64", "k512"])
def test_wide_site_plan_matches_reference(policy):
    """A reduced qwen3_1p7b (2 layers) whose every LUT site takes
    SitePolicy(v=64) or SitePolicy(k=512), past the kernels' first envelope,
    served through ops.lut_amm (the plain versions on the CPU) against the
    reference's Pallas kernels in interpret mode, from the same params: a
    prefill chunk and a decode step agree in logits and tokens."""
    import jax

    from repro import configs as jcfg
    from repro.core.plan import LUTPlan as JPlan
    from repro_torch import configs as tcfg
    from repro_torch.core.plan import LUTPlan as TPlan
    from repro_torch.weights import params_from_numpy

    pol = dict(policy, use_kernel=True)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                           lut_plan=JPlan.all(**pol)), "lut_infer")
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                           lut_plan=TPlan.all(**pol)), "lut_infer")
    sites = tb.lut_sites()
    assert sites and all(s.lut.use_kernel for s in sites)
    assert {(s.lut.k, s.lut.v) for s in sites} == {(policy.get("k", 16), policy.get("v", 32))}
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tb, jax.tree.map(np.asarray, jparams), device="cpu")
    b, chunk, s_max = 2, 4, 16
    jcache = jb.init_caches(b, s_max, dtype=jnp.float32)
    tcache = tb.init_caches(b, s_max, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(0).integers(1, tb.arch.vocab, (b, chunk), dtype=np.int32)
    cache_len = np.zeros((b,), np.int32)
    counters.reset()
    for step in range(2):
        jlog, jcache = jb.forward_step(
            jparams, {"tokens": jnp.asarray(toks), "cache_len": jnp.asarray(cache_len)},
            jcache, compute_dtype=jnp.float32)
        tlog, tcache = tb.forward_step(
            tparams, {"tokens": torch.from_numpy(toks), "cache_len": torch.from_numpy(cache_len)},
            tcache, compute_dtype=torch.float32)
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jlog, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}")
        nxt = jlog[:, -1].argmax(-1)
        assert (tlog[:, -1].argmax(-1).numpy() == nxt).all()
        cache_len = cache_len + toks.shape[1]
        toks = nxt[:, None].astype(np.int32)
    # every site of both forwards went through ops.lut_amm's plain versions
    assert sum(ref.calls.values()) == 2 * len(sites)
    assert sum(counters.launches().values()) == 0
