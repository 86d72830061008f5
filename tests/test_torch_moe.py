"""The port's MoE FFN and the moe family (arctic_480b, llama4_maverick_400b)
against the JAX reference, from the same numpy inputs and params: the
expert contraction in its three modes, GShard routing with capacity drops,
the shared expert and the dense residual branch, and greedy engine tokens."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.amm import LUTConfig as JLUTConfig
from repro.core.amm import Mode as JMode
from repro.models import moe as jmoe
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs as tcfg
from repro_torch.core.amm import LUTConfig, Mode
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_numpy, tensor_from_numpy

ATOL = RTOL = 1e-4          # the port's model tolerance (tests/test_torch_model.py)
ENGINE = dict(n_slots=2, max_seq=32, prefill_chunk=8)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL, **kw)


def _to_port(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), torch.device("cpu")), tree)


@pytest.mark.parametrize("site", ["dense", "lut", "lut_int8_dot"])
def test_expert_linear_matches_reference(site):
    """(E, Cap, d_in) -> (E, Cap, d_out): DENSE, LUT_INFER through the
    dequantized table, and LUT_INFER with int8_dot (exact int32 sums,
    bytewise); all experts, and a subset of them by index."""
    lut = dict(k=16, v=16, int8_dot=site == "lut_int8_dot")
    mode = "dense" if site == "dense" else "lut_infer"
    jsite = jmoe.ExpertSiteCfg(n_experts=4, d_in=64, d_out=48, mode=JMode(mode),
                               lut=JLUTConfig(**lut))
    tsite = tmoe.ExpertSiteCfg(n_experts=4, d_in=64, d_out=48, mode=Mode(mode),
                               lut=LUTConfig(**lut))
    jp = jmoe.expert_linear_init(jax.random.PRNGKey(1), jsite)
    tp = _to_port(jp)
    x = np.random.default_rng(0).standard_normal((4, 6, 64), dtype=np.float32)
    want = np.asarray(jmoe.expert_linear(jsite, jp, jnp.asarray(x)))
    got = tmoe.expert_linear(tsite, tp, torch.from_numpy(x))
    if site == "lut_int8_dot":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want)
    sub = torch.tensor([3, 1])
    _close(tmoe.expert_linear(tsite, tp, torch.from_numpy(x[[3, 1]]), sub), want[[3, 1]])


def test_expert_lut_train_raises():
    """A LUT_TRAIN expert site holds the frozen stacked weight beside the
    shared codebooks and the temperature (the reference's shapes); without
    its frozen weight it raises. (Its values against the reference:
    tests/test_torch_train_families.py.)"""
    s = tmoe.ExpertSiteCfg(n_experts=2, d_in=32, d_out=8, mode=Mode.LUT_TRAIN,
                           lut=LUTConfig(k=16, v=16))
    specs = tmoe.expert_linear_specs(s)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {"w": (2, 32, 8), "centroids": (2, 16, 16), "log_t": ()}
    p = tmoe.expert_linear_init(torch.Generator().manual_seed(0), s)
    assert tmoe.expert_linear(s, p, torch.zeros((2, 1, 32))).shape == (2, 1, 8)
    with pytest.raises(KeyError, match="w"):
        tmoe.expert_linear(s, {k: v for k, v in p.items() if k != "w"}, torch.zeros((2, 1, 32)))


@functools.lru_cache(maxsize=None)
def _bundles(arch_name, mode, n_layers=2, **kw):
    """Reduced moe arch in both packages, the reference's params in both
    layouts (LUT sites through the kernels: m-shared scales)."""
    kw = dict(n_layers=n_layers, lut_use_kernel=True, **kw)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch(arch_name), **kw), mode)
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch(arch_name), **kw), mode)
    jp = jb.init(jax.random.PRNGKey(0))
    return jb, jp, tb, params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch_name,mode,s", [
    ("arctic_480b", "lut_infer", 8),               # top-2 over 8 tokens
    ("arctic_480b", "dense", 1),                   # decode: a group of 1, nothing dropped
    ("llama4_maverick_400b", "lut_infer", 12),     # top-1 + the shared expert
])
def test_moe_matches_reference(arch_name, mode, s):
    """One MoE FFN: the same routing (dispatch slots, capacity drops) from the
    same logits, the output and the aux value. Over several tokens the
    capacity factor is cut to 0.5, so that the experts cannot take every
    choice and tokens are dropped."""
    jb, jp, tb, tp = _bundles(arch_name, mode)
    jm, tm = jb.cfg.segments[-1][1].moe, tb.cfg.segments[-1][1].moe
    if s > 1:
        jm = dataclasses.replace(jm, capacity_factor=0.5)
        tm = dataclasses.replace(tm, capacity_factor=0.5)
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][-1]["moe"])
    tlayer = tp["segments"][-1][0]["moe"]
    x = np.random.default_rng(s).standard_normal((3, s, jm.d_model), dtype=np.float32)
    jy, jaux = jmoe.moe(jm, jlayer, jnp.asarray(x))
    ty, taux = tmoe.moe(tm, tlayer, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)
    if s > 1:
        # fewer expert slots than choices: tokens were dropped
        cap = max(jm.top_k, int(0.5 * jm.top_k * s / jm.n_experts) + 1)
        assert cap * jm.n_experts < jm.top_k * s


def test_arctic_block_carries_the_dense_residual_and_llama4_the_shared_expert():
    _, _, tb, tp = _bundles("arctic_480b", "lut_infer")
    blk = tb.cfg.segments[-1][1]
    assert blk.kind == "moe" and blk.residual_mlp is not None and blk.moe.shared is None
    assert set(tp["segments"][-1][0]) == {"norm1", "norm2", "attn", "moe", "residual_mlp"}
    moe = tp["segments"][-1][0]["moe"]
    assert moe["router"]["w"].dtype == torch.float32 and "table_q" not in moe["router"]
    assert moe["gate"]["table_q"].shape == (4, 8, 16, 256)      # (E, C, K, F)
    assert moe["gate"]["table_scale"].shape == (4, 1, 1, 256)   # m-shared per expert
    _, _, tb, tp = _bundles("llama4_maverick_400b", "lut_infer")
    assert tb.cfg.segments[-1][1].moe.shared is not None
    assert "shared" in tp["segments"][-1][0]["moe"]


@pytest.mark.parametrize("arch_name", ["arctic_480b", "llama4_maverick_400b"])
def test_engine_greedy_tokens_equal_the_reference_engine(arch_name):
    """Ragged prompts (MoE caches are attention K/V only), three requests on
    two slots: the same greedy tokens through both engines."""
    jb, jp, tb, tp = _bundles(arch_name, "lut_infer")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, tb.arch.vocab, n).tolist() for n in (8, 5, 13)]
    outs = []
    for eng in (JServingEngine(jb, jp, **ENGINE), ServingEngine(tb, tp, device="cpu", **ENGINE)):
        for p in prompts:
            eng.submit(p, max_tokens=5)
        outs.append([r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)])
    assert outs[0] == outs[1]


def test_moe_param_specs_and_bf16_router():
    """A bf16 arch keeps its router fp32 (the reference's moe_init), and the
    port's param specs name every reference leaf with its shape and dtype."""
    arch = dataclasses.replace(tcfg.reduce_arch(tcfg.get_arch("arctic_480b"), n_layers=2,
                                                lut_use_kernel=True), param_dtype="bfloat16")
    tb = tcfg.build_model(arch, "lut_infer")
    jarch = dataclasses.replace(jcfg.reduce_arch(jcfg.get_arch("arctic_480b"), n_layers=2,
                                                 lut_use_kernel=True), param_dtype="bfloat16")
    jspecs = jax.tree_util.tree_flatten_with_path(
        jcfg.build_model(jarch, "lut_infer").param_specs())[0]
    from repro_torch.checkpoint.paths import flatten_tree

    tspecs = flatten_tree(tb.param_specs())
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(a.shape), str(a.dtype)) for path, a in jspecs}
    got = {p: (tuple(s.shape), str(s.dtype).removeprefix("torch.")) for p, s in tspecs.items()}
    assert got == want
    assert got["segments/1/moe/router/w"][1] == "float32"
