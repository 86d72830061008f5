"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA Hopper GPU and skips without one. This file
imports neither JAX nor the reference package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.kernels import ops, ref
from repro_torch.testing import LAYOUTS, RAGGED, make_amm_inputs, quantize_np, rows_near_tie

pytestmark = pytest.mark.cuda
TIE_EPS = 1e-6        # relative fp32 distance gap where another sum order may flip a code
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
    ref.calls.update(fused_decode_plain=0, lut_amm_v2_plain=0)
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
