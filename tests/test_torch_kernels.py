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
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.kernels import ops, ref
from repro_torch.testing import LAYOUTS, RAGGED, make_amm_inputs, quantize_np, tie_gaps

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


@pytest.mark.parametrize("n", [4, 128])
@pytest.mark.parametrize("c,m", [(64, 2048), (64, 1024), (64, 6144), (192, 2048)])
def test_launch_geometry_fills_the_card(n, c, m):
    """Decode (N=4, one N tile) and a prefill chunk (N=128) at qwen3_1p7b's
    sites: the fused kernel launches about one wave of one block per SM of an
    H100 and covers every M tile; v2 launches about one block per SM."""
    sms = 132
    n_tiles = v2_mod.cdiv(n, v2_mod.BLOCK_N)
    if c == 64:
        g = fused_mod.fused_geometry(n, c, 16, 32, m, sms)
        n_mtiles = v2_mod.cdiv(m, 4 * g["quads"])
        assert g["m_ranges"] * g["tiles_per_range"] >= n_mtiles
        assert (g["m_ranges"] - 1) * g["tiles_per_range"] < n_mtiles
        assert 96 <= n_tiles * g["m_ranges"] <= sms
        assert g["smem"] <= v2_mod.MAX_SMEM
    g = v2_mod.v2_geometry(n, c, 16, 32, m, sms)
    blocks = n_tiles * v2_mod.cdiv(m, 4 * g["quads"])
    # more than one wave only when even the widest tile cannot avoid it
    assert 64 <= blocks and (blocks <= sms or g["quads"] == max(v2_mod.QUADS))
    assert g["smem"] <= v2_mod.MAX_SMEM and g["chunk_c"] == 64   # C split evenly


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
