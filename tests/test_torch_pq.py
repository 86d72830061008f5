"""The port's PQ math, table quantization and LUT linear layer against the
JAX reference, on the same numpy inputs (repro_torch.core vs repro.core)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amm as jamm
from repro.core import pq as jpq
from repro.core import quant as jquant
from repro_torch.core import amm, pq, quant
from repro_torch.core.lut_layer import deploy_param_specs
from repro_torch.testing import RAGGED, make_amm_inputs, tie_gaps

IDS = [str(s) for s in RAGGED]
# a differing code must sit on an fp32 near-tie: the two distances agree to
# within this relative gap (a few ulps of the distance's magnitude)
TIE_EPS = 1e-5


@pytest.mark.parametrize("shape", RAGGED, ids=IDS)
def test_distances_and_codes_match_reference(shape):
    n, d, m, k, v = shape
    x, P, _, _ = make_amm_inputs(n, d, m, k, v, seed=n + d)
    ref = np.asarray(jpq.pairwise_sq_dists(jpq.split_subvectors(jnp.asarray(x), v),
                                           jnp.asarray(P)))
    got = pq.pairwise_sq_dists(pq.split_subvectors(torch.from_numpy(x), v),
                               torch.from_numpy(P))
    # fp32 expansion in both; summation order may differ by a few ulps
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)

    codes_ref = torch.from_numpy(np.array(jpq.encode_indices(jnp.asarray(x),
                                                               jnp.asarray(P))))
    codes = pq.encode_indices(torch.from_numpy(x), torch.from_numpy(P))
    assert codes.dtype == torch.int32 and codes.shape == (n, d // v)
    gaps = tie_gaps(torch.from_numpy(x), torch.from_numpy(P), codes, codes_ref)
    assert (gaps <= TIE_EPS).all(), f"codes differ off a near-tie: gaps {gaps}"


def test_argmin_keeps_lowest_index_on_exact_ties():
    # two identical centroids: the lower index must win, as in jnp.argmin
    P = np.zeros((1, 4, 2), np.float32)
    P[0, 1] = P[0, 3] = [1.0, 1.0]
    P[0, 0] = P[0, 2] = [5.0, 5.0]
    x = np.ones((3, 2), np.float32)
    codes = pq.encode_indices(torch.from_numpy(x), torch.from_numpy(P))
    assert codes.tolist() == [[1], [1], [1]]
    enc = pq.hard_encode(pq.pairwise_sq_dists(pq.split_subvectors(torch.from_numpy(x), 2),
                                              torch.from_numpy(P)))
    assert enc[:, 0].argmax(-1).tolist() == [1, 1, 1]


def test_split_subvectors_rejects_ragged_width():
    with pytest.raises(ValueError):
        pq.split_subvectors(torch.zeros(2, 10), 4)


@pytest.mark.parametrize("shape", RAGGED[:3], ids=IDS[:3])
def test_contractions_match_reference(shape):
    """lut_contract (fp32 one-hot), lut_contract_int8 and gather_lut on the
    reference's own codes."""
    n, d, m, k, v = shape
    x, P, T, _ = make_amm_inputs(n, d, m, k, v, seed=7 * n)
    dists = jpq.pairwise_sq_dists(jpq.split_subvectors(jnp.asarray(x), v), jnp.asarray(P))
    enc = jpq.hard_encode(dists)
    enc_t = torch.from_numpy(np.array(enc))
    np.testing.assert_allclose(pq.lut_contract(enc_t, torch.from_numpy(T)).numpy(),
                               np.asarray(jpq.lut_contract(enc, jnp.asarray(T))),
                               rtol=1e-5, atol=1e-5)   # fp32 sums in another order

    qt = jquant.quantize_table(jnp.asarray(T), m_shared=True)
    q, s = np.array(qt.q), np.array(qt.scale)
    got = pq.lut_contract_int8(enc_t, torch.from_numpy(q), torch.from_numpy(s))
    ref = jpq.lut_contract_int8(enc, qt.q, qt.scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))   # exact int32, one rounding

    idx = np.array(jnp.argmin(dists, -1))
    got = pq.gather_lut(torch.from_numpy(idx), torch.from_numpy(q.astype(np.int32)))
    ref = jpq.gather_lut(jnp.asarray(idx), jnp.asarray(q.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))   # exact integers


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout", ["per_codebook", "per_column", "m_shared"])
def test_quantize_table_bit_for_bit(layout, bits):
    _, _, T, _ = make_amm_inputs(4, 96, 130, 16, 16, seed=bits)
    kw = {"per_column": layout == "per_column", "m_shared": layout == "m_shared"}
    ref = jquant.quantize_table(jnp.asarray(T), bits=bits, **kw)
    got = quant.quantize_table(torch.from_numpy(T), bits=bits, **kw)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(got.dequant(torch.float32).numpy(),
                                  np.asarray(ref.dequant(jnp.float32)))


@pytest.mark.parametrize("use_kernel,int8_dot,per_column",
                         [(True, False, False), (False, True, False), (False, False, False),
                          (False, False, True)],
                         ids=["kernel", "int8_dot", "dequant_onehot", "dequant_per_column"])
def test_lut_linear_lut_infer_matches_reference(use_kernel, int8_dot, per_column):
    """All three LUT_INFER branches of lut_linear, with a bias, on (B, S, D)."""
    d, m, k, v = 64, 48, 16, 8
    x, P, T, b = make_amm_inputs(2 * 5, d, m, k, v, seed=31)
    x = x.reshape(2, 5, d)
    cfg_kw = dict(k=k, v=v, per_column=per_column, int8_dot=int8_dot, use_kernel=use_kernel)
    qt = jquant.quantize_table(jnp.asarray(T), per_column=per_column,
                               m_shared=int8_dot or use_kernel)
    jparams = {"centroids": jnp.asarray(P), "table_q": qt.q, "table_scale": qt.scale,
               "b": jnp.asarray(b)}
    ref = np.asarray(jamm.lut_linear(jamm.LUTConfig(**cfg_kw), jamm.Mode.LUT_INFER, jparams,
                                     jnp.asarray(x)))
    tparams = {key: torch.from_numpy(np.array(val)) for key, val in jparams.items()}
    got = amm.lut_linear(amm.LUTConfig(**cfg_kw), amm.Mode.LUT_INFER, tparams,
                         torch.from_numpy(x))
    assert got.shape == (2, 5, m) and got.dtype == torch.float32
    # the reference's own kernel-vs-oracle bound (tests/test_fused_decode.py:61)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_lut_linear_dense_and_train():
    x, _, _, _ = make_amm_inputs(6, 32, 8, 16, 8, seed=3)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 8), dtype=np.float32)
    b = rng.standard_normal((8,), dtype=np.float32)
    ref = np.asarray(jamm.lut_linear(jamm.LUTConfig(), jamm.Mode.DENSE,
                                     {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    got = amm.lut_linear(amm.LUTConfig(), amm.Mode.DENSE,
                         {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)  # fp32 matmul order
    # LUT_TRAIN: the fake-quantized table of the frozen weight, read through
    # the straight-through codes (the gradients: tests/test_torch_train.py)
    _, P, _, _ = make_amm_inputs(6, 32, 8, 16, 8, seed=4)
    cfg = dict(k=16, v=8)
    ref = np.asarray(jamm.lut_linear(jamm.LUTConfig(**cfg), jamm.Mode.LUT_TRAIN,
                                     {"centroids": jnp.asarray(P), "log_t": jnp.float32(0.0)},
                                     jnp.asarray(x), frozen={"w": jnp.asarray(w),
                                                             "b": jnp.asarray(b)}))
    got = amm.lut_linear(amm.LUTConfig(**cfg), amm.Mode.LUT_TRAIN,
                         {"centroids": torch.from_numpy(P), "log_t": torch.tensor(0.0)},
                         torch.from_numpy(x), frozen={"w": torch.from_numpy(w),
                                                      "b": torch.from_numpy(b)})
    codes = pq.encode_indices(torch.from_numpy(x), torch.from_numpy(P))
    codes_ref = torch.from_numpy(np.array(jpq.encode_indices(jnp.asarray(x), jnp.asarray(P))))
    assert (tie_gaps(torch.from_numpy(x), torch.from_numpy(P), codes, codes_ref) <= TIE_EPS).all()
    same = (codes == codes_ref).all(dim=1).numpy()
    np.testing.assert_allclose(got.numpy()[same], ref[same], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="frozen"):
        amm.lut_linear(amm.LUTConfig(), amm.Mode.LUT_TRAIN, {}, torch.from_numpy(x))


@pytest.mark.parametrize("flags,shape", [({"use_kernel": True}, (1, 1, 48)),
                                         ({"int8_dot": True}, (1, 1, 48)),
                                         ({"per_column": True}, (4, 1, 48)),
                                         ({}, (4, 1, 1))])
def test_deploy_param_specs_scale_layout(flags, shape):
    from repro.core.lut_layer import deploy_param_specs as jspecs

    cfg = amm.LUTConfig(k=16, v=8, **flags)
    got = deploy_param_specs(32, 48, cfg, bias=True)
    ref = jspecs(32, 48, jamm.LUTConfig(k=16, v=8, **flags), bias=True)
    assert got["table_scale"].shape == shape
    for key, spec in ref.items():
        assert got[key].shape == spec.shape
        assert str(got[key].dtype).removeprefix("torch.") == str(spec.dtype)
