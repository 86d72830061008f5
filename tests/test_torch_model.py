"""The port's models against the JAX reference, from the same params: the
reference's `bundle.init(PRNGKey(0))`, carried over as numpy by
`repro_torch.weights.params_from_numpy`. Every arch the port builds: the
dense family, moe, ssm and hybrid (the families also have their own files:
tests/test_torch_moe.py, test_torch_ssm.py, test_torch_hybrid.py); the
enc-dec and vlm archs' configs and sites here, their forwards in
tests/test_torch_encdec.py and test_torch_vlm.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.kernels import counters
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod
from repro_torch.kernels import ref
from repro_torch.models import common
from repro_torch.weights import params_from_numpy

ARCHS = ["qwen3_1p7b", "llama3_8b", "bert_base", "command_r_35b", "minitron_8b",
         "mamba2_370m", "zamba2_1p2b", "arctic_480b", "llama4_maverick_400b"]
# the families whose inputs are not token ids alone (their forwards:
# tests/test_torch_encdec.py, test_torch_vlm.py)
OTHER_INPUTS = ["whisper_tiny", "qwen2_vl_7b"]
MODES = ["dense", "lut_infer"]
B, S_MAX, CHUNK = 2, 16, 4
# fp32 everywhere; matmuls, softmax and the fp32 rescale sum in another order
# than XLA's, so logits agree to float rounding, not bit for bit
ATOL, RTOL = 1e-4, 1e-4


@functools.lru_cache(maxsize=None)
def _bundles(arch_name, mode):
    """Reduced arch (lut_use_kernel: m-shared scales, LUT sites through the
    kernels) in both packages, and the reference's params in both layouts.
    Cached: callers build their own caches and never write to params."""
    jarch = jcfg.reduce_arch(jcfg.get_arch(arch_name), lut_use_kernel=True)
    tarch = tcfg.reduce_arch(tcfg.get_arch(arch_name), lut_use_kernel=True)
    jb = jcfg.build_model(jarch, mode)
    tb = tcfg.build_model(tarch, mode)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tb, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def test_arch_spec_fields_match_reference():
    assert [f.name for f in dataclasses.fields(tcfg.ArchSpec)] == \
        [f.name for f in dataclasses.fields(jcfg.ArchSpec)]
    for name in ARCHS + OTHER_INPUTS:
        j, t = jcfg.get_arch(name), tcfg.get_arch(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(tcfg.reduce_arch(t, lut_use_kernel=True)) == \
            dataclasses.asdict(jcfg.reduce_arch(j, lut_use_kernel=True))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch_name", ARCHS + OTHER_INPUTS)
def test_sites_match_reference(arch_name, mode):
    """The same sites resolve to the same modes and LUT configs, at full size."""
    jsites = jcfg.build_model(arch_name, mode).sites()
    tsites = tcfg.build_model(arch_name, mode).sites()
    assert len(tsites) == len(jsites)
    for t, j in zip(tsites, jsites):
        assert (t.path, t.layer, t.stack_index, t.kind, t.d_in, t.d_out, t.bias, t.tape_key) == \
            (j.path, j.layer, j.stack_index, j.kind, j.d_in, j.d_out, j.bias, j.tape_key)
        assert t.mode.value == j.mode.value
        assert dataclasses.asdict(t.lut) == dataclasses.asdict(j.lut)


def test_params_carry_is_dtype_exact():
    _, jparams, tb, tparams = _bundles("qwen3_1p7b", "lut_infer")
    lut = tparams["segments"][1][0]["attn"]["q"]
    jlut = jparams["segments"][1]["attn"]["q"]
    assert lut["table_q"].dtype == torch.int8 and lut["table_scale"].shape == (1, 1, 128)
    np.testing.assert_array_equal(lut["table_q"].numpy(), np.asarray(jlut["table_q"][0]))
    assert len(tparams["segments"][1]) == 3           # layers 1..3 unstacked
    assert "lm_head" not in tparams                   # tied embeddings
    bf = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3), jnp.bfloat16)
    from repro_torch.weights import tensor_from_numpy
    t = tensor_from_numpy(np.asarray(bf), torch.device("cpu"))
    assert t.dtype == torch.bfloat16 and t.float().tolist() == [[0, 1, 2], [3, 4, 5]]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch_name", ARCHS)
def test_forward_step_logits_match_reference(arch_name, mode):
    """A prefill chunk, then two decode steps on the deferred-write path."""
    jb, jparams, tb, tparams = _bundles(arch_name, mode)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, tb.arch.vocab, (B, CHUNK), dtype=np.int32)
    ref.calls.update(dict.fromkeys(ref.calls, 0))
    jcache = jb.init_caches(B, S_MAX, dtype=jnp.float32)
    tcache = tb.init_caches(B, S_MAX, dtype=torch.float32, device="cpu")
    counters.reset()

    toks = prompt
    cache_len = np.zeros((B,), np.int32)
    for step in range(3):
        jlog, jcache = jb.forward_step(
            jparams, {"tokens": jnp.asarray(toks), "cache_len": jnp.asarray(cache_len)},
            jcache, compute_dtype=jnp.float32)
        tlog, tcache = tb.forward_step(
            tparams, {"tokens": torch.from_numpy(toks), "cache_len": torch.from_numpy(cache_len)},
            tcache, compute_dtype=torch.float32)
        jlog = np.asarray(jlog)
        assert tlog.shape == jlog.shape == (B, toks.shape[1], tb.arch.vocab)
        np.testing.assert_allclose(tlog.numpy(), jlog, atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
        nxt = jlog[:, -1].argmax(-1)
        assert (tlog[:, -1].argmax(-1).numpy() == nxt).all()
        cache_len = cache_len + toks.shape[1]
        toks = nxt[:, None].astype(np.int32)
    # the one cache write per forward left the same K/V (and recurrent
    # state) as the reference's
    want = jax.tree_util.tree_leaves(jcache)
    got = flatten_tree(tcache)
    assert len(got) == len(want)
    for jleaf, (tpath, tleaf) in zip(want, got.items()):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), atol=ATOL, rtol=RTOL,
                                   err_msg=tpath)
    if mode == "lut_infer":
        # 3 forwards x the LUT-site calls of one (expert sites contract in
        # plain tensor ops), all on the CPU plain versions
        assert sum(ref.calls.values()) == 3 * _lut_calls_per_forward(tb)
        assert fused_mod.launches == 0 and v2_mod.launches == 0


def _lut_calls_per_forward(bundle) -> int:
    n_inv = len(bundle.cfg.invocation_points) if bundle.kind == "hybrid" else 1
    return sum(n_inv if s.path.startswith("shared/") else 1 for s in bundle.lut_sites()
               if s.kind not in ("moe/gate", "moe/up", "moe/down"))


def test_write_rows_leave_other_slots_untouched():
    """A forward that may write only row 1 changes no cache entry of row 0."""
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2),
                          "lut_infer")
    params = tb.init(torch.Generator().manual_seed(0), device="cpu")
    caches = tb.init_caches(B, S_MAX, dtype=torch.float32, device="cpu")
    toks = torch.full((B, CHUNK), 7, dtype=torch.int32)
    for s in (CHUNK, 1):              # prefill path, then the deferred decode write
        tb.forward_step(params, {"tokens": toks[:, :s], "cache_len": torch.tensor([0, 4]),
                                 "write_rows": torch.tensor([1])}, caches)
        for c in caches:
            assert not c["k"][:, 0].any() and not c["v"][:, 0].any()
            assert c["k"][:, 1].any()


def test_model_pieces_follow_the_reference_conventions():
    x = torch.linspace(-3, 3, 13)
    # gelu is the tanh approximation (jax.nn.gelu's default), not erf
    np.testing.assert_allclose(common.activation("gelu", x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), atol=1e-6)
    xr = np.random.default_rng(1).standard_normal((2, 3, 2, 8), dtype=np.float32)
    pos = np.array([[0, 5, 9], [1, 2, 3]], np.int32)
    from repro.models.common import apply_rope as japply_rope
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(japply_rope(jnp.asarray(xr), jnp.asarray(pos), 10000.0)), atol=1e-5)
    # M-RoPE with three equal streams is RoPE (distinct streams:
    # tests/test_torch_vlm.py)
    pos3 = np.broadcast_to(pos, (3, *pos.shape))
    from repro.models.common import apply_mrope as japply_mrope
    np.testing.assert_allclose(
        common.apply_mrope(torch.from_numpy(xr), torch.from_numpy(pos3.copy()), 1e6,
                           (1, 1, 2)).numpy(),
        np.asarray(japply_mrope(jnp.asarray(xr), jnp.asarray(pos3), 1e6, (1, 1, 2))), atol=1e-5)
    # every arch of the reference builds, the enc-dec and vision families too,
    # with the reference's bundle kinds
    for family, kind in (("audio", "encdec"), ("vlm", "lm")):
        arch = dataclasses.replace(tcfg.get_arch("qwen3_1p7b"), family=family, n_enc_layers=2,
                                   enc_frames=8)
        assert tcfg.build_model(arch).kind == jcfg.build_model(
            dataclasses.replace(jcfg.get_arch("qwen3_1p7b"), family=family, n_enc_layers=2,
                                enc_frames=8)).kind == kind
    for name in ("whisper_tiny", "qwen2_vl_7b"):
        assert dataclasses.asdict(tcfg.get_arch(name)) == dataclasses.asdict(jcfg.get_arch(name))
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS and tcfg.EXTRA_IDS == jcfg.EXTRA_IDS
