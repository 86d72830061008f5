"""The port's dry run and H100 roofline against the reference's.

`repro_torch.launch.dryrun` traces a cell on the meta device
(`roofline.op_cost.OpCostMode`, a `launch.mesh.DryMesh`); the reference
lowers and compiles it with XLA. Here, in one process and on one device (the
reference's `launch.dryrun` forces 512 host devices when imported, so it is
not imported): the Table 1 costs, the dry-run shapes and inputs, the ring
model's wire bytes, matmul flops, two reduced qwen3_1p7b DENSE cells (a
decode serve step and a train step) against the reference's compiled
steps, the LUT sites' charges, a (2, 4) mesh's per-rank bytes, the H100
bound of the kernel table, and the quickstart example.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as rcfg
from repro import core as rcore
from repro.roofline.analysis import analyze_compiled, collective_bytes
from repro.roofline.analysis import memory_stats as ref_memory_stats
from repro.roofline.hlo_cost import HloCostModel, analyze_hlo_text
from repro_torch import configs as tcfg
from repro_torch import core as tcore
from repro_torch.kernels import autotune, ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dry_mesh
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import OpCostMode

ROOT = pathlib.Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# Table 1, shapes and inputs: exact
# ---------------------------------------------------------------------------

TABLE1_CFGS = [dict(k=16, v=8), dict(k=16, v=32), dict(k=8, v=16, per_column=True),
               dict(k=512, v=64, bits=4)]


@pytest.mark.parametrize("cfg", TABLE1_CFGS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_table1_costs_equal_the_reference(cfg):
    rc, tc = rcore.LUTConfig(**cfg), tcore.LUTConfig(**cfg)
    for n, d, m in ((1, 64, 64), (1024, 256, 512), (4, 2048, 6144), (128, 6144, 2048)):
        assert tcore.lut_flops(n, d, m, tc) == rcore.lut_flops(n, d, m, rc)
        assert tcore.dense_flops(n, d, m) == rcore.dense_flops(n, d, m)
        assert tcore.lut_table_bytes(d, m, tc) == rcore.lut_table_bytes(d, m, rc)
        for b in (2, 4):
            assert tcore.dense_bytes(d, m, b) == rcore.dense_bytes(d, m, b)


@pytest.mark.parametrize("shape", list(rcfg.SHAPES))
def test_shapes_and_inputs_equal_the_reference(shape):
    """SHAPES, shape_applicable and input_specs' shapes and dtypes for
    every arch; cache_len is a CPU int32 tensor (the cache full to
    seq_len - 1 at decode, empty at prefill)."""
    assert dataclasses.astuple(tcfg.SHAPES[shape]) == dataclasses.astuple(rcfg.SHAPES[shape])
    assert [a.name for a in tcfg.all_archs()] == [a.name for a in rcfg.all_archs()]
    sp = tcfg.SHAPES[shape]
    for name in rcfg.ARCH_IDS:
        assert (tcfg.shape_applicable(tcfg.get_arch(name), shape)
                == rcfg.shape_applicable(rcfg.get_arch(name), shape))
        want = rcfg.input_specs(name, shape)
        got = tcfg.input_specs(name, shape)
        assert list(got) == list(want), (name, shape)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (name, shape, k)
            assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), (name, shape, k)
            assert got[k].device.type == ("cpu" if k == "cache_len" else "meta")
        if "cache_len" in got:
            assert set(got["cache_len"].tolist()) == {sp.seq_len - 1 if sp.kind == "decode" else 0}


# ---------------------------------------------------------------------------
# the ring model and the matmul count, against the reference's parsers
# ---------------------------------------------------------------------------

def _hlo(kind: str, out_shape: str, in_shape: str) -> str:
    return f"  %c = {out_shape} {kind}({in_shape} %x), replica_groups={{}}\n"


@pytest.mark.parametrize("kind", ["all_reduce", "all_max", "all_mean", "all_gather",
                                  "gather_dim", "all_to_all", "reduce_scatter", "broadcast"])
def test_dry_mesh_wire_bytes_follow_the_reference_ring_model(kind):
    """A (2, 4) DryMesh's wire bytes per collective and axis against
    `repro.roofline.analysis.collective_bytes` on the HLO of the same
    collective (the port's broadcast as a collective-permute). Kept
    difference: the reference's parser charges a reduce-scatter its result
    (input / n), its docstring's ring model the input; the port charges the
    input."""
    mesh = dry_mesh(2, 4)
    n = mesh.size("model")
    x = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    hlo = {
        "all_reduce": _hlo("all-reduce", "bf16[8,16]", "bf16[8,16]"),
        "all_max": _hlo("all-reduce", "bf16[8,16]", "bf16[8,16]"),
        "all_mean": _hlo("all-reduce", "bf16[8,16]", "bf16[8,16]"),
        "all_gather": _hlo("all-gather", f"bf16[{n},8,16]", "bf16[8,16]"),
        "gather_dim": _hlo("all-gather", f"bf16[8,{16 * n}]", "bf16[8,16]"),
        "all_to_all": _hlo("all-to-all", "bf16[4,4,16]", "bf16[4,4,16]"),
        "reduce_scatter": _hlo("reduce-scatter", f"bf16[8,{16 // n}]", "bf16[8,16]"),
        "broadcast": _hlo("collective-permute", "bf16[8,16]", "bf16[8,16]"),
    }[kind]
    want = sum(collective_bytes(hlo).values())
    if kind == "reduce_scatter":
        want *= n
    mesh.reset_counters()
    if kind == "all_to_all":
        out = mesh.all_to_all(torch.empty((4, 4, 16), dtype=torch.bfloat16, device="meta"),
                              "model")
    elif kind == "reduce_scatter":
        out = mesh.reduce_scatter(x, 1, "model")
    elif kind == "gather_dim":
        out = mesh.gather_dim(x, 1, "model")
    elif kind == "broadcast":
        out = mesh.broadcast(x, 0, "model")
    else:
        out = getattr(mesh, kind)(x, "model")
    assert out.is_meta
    by_kind, by_axis, links = mesh.wire_summary()
    assert by_axis == {"model": want}
    assert links == {"model": analysis.NVLINK_BW}          # ranks 0-3: one node
    counted = "all_reduce" if kind == "gather_dim" else kind
    assert mesh.axis_counters["model"][counted] == 1


@pytest.mark.parametrize("case", ["matmul", "batched_einsum"])
def test_op_cost_matmul_flops_equal_the_reference(case):
    if case == "matmul":
        shapes, eq = ((64, 96), (96, 48)), "ij,jk->ik"
    else:
        shapes, eq = ((4, 32, 24), (4, 24, 40)), "bij,bjk->bik"
    hlo = jax.jit(lambda a, b: jnp.einsum(eq, a, b)).lower(
        *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile().as_text()
    with OpCostMode() as mode:
        torch.einsum(eq, *(torch.empty(s, device="meta") for s in shapes))
    assert sum(mode.flops.values()) == analyze_hlo_text(hlo).flops
    assert mode.flops["fp32"] > 0 and mode.flops["bf16"] == 0


# ---------------------------------------------------------------------------
# reduced qwen3_1p7b cells against the reference's compiled steps
# ---------------------------------------------------------------------------

REDUCED = dict(n_layers=2, vocab=64)
CELLS = {"serve": tcfg.ShapeSpec("decode_b8_c32", "decode", 32, 8),
         "train": tcfg.ShapeSpec("train_8x16", "train", 16, 8)}


def _overrides() -> dict:
    base = tcfg.get_arch("qwen3_1p7b")
    red = tcfg.reduce_arch(base, **REDUCED)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(base, f.name)}


def _reference_cell(kind: str):
    """(compiled, bundle) of the reference's DENSE cell on one device, as its
    dry run lowers it (donated caches, or params and moments)."""
    from repro.optim import SOFT_PQ_RULES, AdamW
    from repro.optim.schedule import cosine_with_warmup
    from repro.train.train_step import make_serve_step, make_train_step

    arch = rcfg.reduce_arch(rcfg.get_arch("qwen3_1p7b"), **REDUCED)
    bundle = rcfg.build_model(arch, rcore.Mode.DENSE)
    pspecs = bundle.param_specs()
    sp = CELLS[kind]
    i32 = jnp.int32
    if kind == "train":
        opt = AdamW(lr=cosine_with_warmup(1e-3, total_steps=10_000, warmup_steps=200),
                    rules=SOFT_PQ_RULES, state_dtype=jnp.float32)
        ospecs = jax.eval_shape(lambda p: opt.init(p, None), pspecs)
        batch = {k: jax.ShapeDtypeStruct((sp.global_batch, sp.seq_len), i32)
                 for k in ("labels", "tokens")}
        fn = jax.jit(make_train_step(bundle, opt, grad_accum=arch.grad_accum),
                     donate_argnums=(0, 1))
        return fn.lower(pspecs, ospecs, batch).compile(), bundle
    cspecs = bundle.init_caches(sp.global_batch, sp.seq_len, abstract=True, dtype=jnp.bfloat16)
    batch = {"cache_len": jax.ShapeDtypeStruct((sp.global_batch,), i32),
             "tokens": jax.ShapeDtypeStruct((sp.global_batch, 1), i32)}
    fn = jax.jit(make_serve_step(bundle), donate_argnums=(2,))
    return fn.lower(pspecs, batch, cspecs).compile(), bundle


# XLA's data-movement ops that the port's eager step runs as views (the
# layer stack's dynamic-slice, transposes, broadcasts, layout copies), and
# each side's dtype conversions (the CPU backend upcasts every bf16 dot's
# operands); both left out of the flop comparison (kept differences)
XLA_ONLY = ("convert", "copy", "transpose", "dynamic-slice", "broadcast")
PORT_CASTS = ("_to_copy",)


def _reference_flops_by_kind(hlo_text: str) -> dict[str, float]:
    """`analyze_hlo_text`'s flops split by HLO op kind (fusions opened,
    while bodies times their trip count), summing to its total."""
    from repro.roofline.hlo_cost import _BODY_RE, _CALLS_RE, _COND_RE, _TRIP_RE

    model = HloCostModel(hlo_text)
    out: dict[str, float] = {}

    def visit(comp: str, mult: float) -> None:
        table = model._op_table(comp)
        for op in model.comps[comp]:
            if op.kind == "fusion":
                visit(_CALLS_RE.search(op.attrs).group(1), mult)
            elif op.kind == "while":
                trip = _TRIP_RE.search(op.attrs)
                for m in (_BODY_RE.search(op.attrs), _COND_RE.search(op.attrs)):
                    visit(m.group(1), mult * (float(trip.group(1)) if trip else 1.0))
            else:
                c = model._op_cost(op, table, count_bytes=False)
                out[op.kind] = out.get(op.kind, 0.0) + c.flops * mult

    visit(model.entry, 1.0)
    return out


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_reduced_dense_cell_matches_the_reference(kind):
    """n_params, param bytes, tokens and argument bytes exact; the matmul
    flops exact, and the total within 5% of the reference's
    `analyze_compiled` but for XLA_ONLY's and PORT_CASTS' op kinds."""
    rec, trace = dryrun.trace_cell("qwen3_1p7b", CELLS[kind], mode="dense",
                                   arch_overrides=_overrides(), mesh=dry_mesh(1, 1))
    compiled, bundle = _reference_cell(kind)
    leaves = jax.tree_util.tree_leaves(bundle.param_specs())
    assert rec["n_params"] == sum(leaf.size for leaf in leaves)
    assert rec["param_bytes_global"] == sum(leaf.size * leaf.dtype.itemsize for leaf in leaves)
    sp = CELLS[kind]
    assert rec["tokens_per_step"] == sp.global_batch * (1 if kind == "serve" else sp.seq_len)
    want_mem = ref_memory_stats(compiled)
    assert rec["memory"]["argument_size_in_bytes"] == want_mem["argument_size_in_bytes"]
    by_kind = _reference_flops_by_kind(compiled.as_text())
    assert sum(by_kind.values()) == analyze_compiled(compiled).flops
    assert trace.by_op["mm"] + trace.by_op.get("bmm", 0.0) == by_kind["dot"]
    assert rec["roofline"]["flops_per_device"] == sum(trace.by_op.values())
    want = sum(f for k, f in by_kind.items() if k not in XLA_ONLY)
    got = sum(f for k, f in trace.by_op.items() if k not in PORT_CASTS)
    assert abs(got - want) <= 0.05 * want, (got, want)
    assert set(rec) >= {"arch", "shape", "mode", "mesh", "multi_pod", "fsdp", "n_params",
                        "param_bytes_global", "trace_s", "memory", "roofline",
                        "tokens_per_step"}
    assert rec["roofline"]["collective_bytes_per_device"] == 0
    assert trace.peak_bytes > 0


def test_lut_infer_cell_charges_each_site_once_per_forward():
    """A reduced LUT_INFER decode cell through the kernels: every LUT site
    charged exactly `lut_site_cost` once, for the version the autotuner
    picks on the card at that shape."""
    rec, trace = dryrun.trace_cell("qwen3_1p7b", CELLS["serve"], arch_overrides=_overrides(),
                                   mesh=dry_mesh(1, 1))
    bundle = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), **REDUCED,
                                               lut_use_kernel=True), tcore.Mode.LUT_INFER)
    n = CELLS["serve"].global_batch
    want = []
    for site in bundle.lut_sites():
        c, k, v, m = site.d_in // site.lut.v, site.lut.k, site.lut.v, site.d_out
        version, _, _ = autotune.kernel_choice(n, m, c, k, v, dtype="bfloat16",
                                               backend=autotune.BACKEND_CUDA)
        kernel = ops.KERNEL_OF_VERSION[version]
        want.append((kernel, (n, m, c, k, v), analysis.lut_site_cost(n, c, k, v, m, 2, kernel)))
    got = [(s["kernel"], s["shape"], s["cost"]) for s in trace.sites]
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert rec["lut_sites_charged"] == len(bundle.lut_sites()) > 0


def test_data_model_mesh_trace_holds_the_rank_shards():
    """A (2, 4) DryMesh train trace: the rank's param and moment bytes are
    the port's own `place` / `Zero1` per-rank bytes, and both axes carry
    collectives over NVLink (ranks 0-7: one node)."""
    from repro_torch.distributed.data_parallel import Zero1
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import place
    from repro_torch.optim import AdamW

    mesh = dry_mesh(2, 4)
    rec, _ = dryrun.trace_cell("qwen3_1p7b", CELLS["train"], mode="dense",
                               arch_overrides=_overrides(), mesh=mesh)
    bundle = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), **REDUCED),
                              tcore.Mode.DENSE)
    rules = ShardingRules(data=2, model=4)
    _, lp, lay = place(bundle, dryrun.meta_params(bundle), rules, mesh, train=True)
    state = Zero1.build(mesh, lp, None, rules, tp=lay).init_state(AdamW(), lp)
    nbytes = dryrun.tree_bytes
    assert rec["per_device"]["param_bytes"] == nbytes(lp)
    assert rec["per_device"]["opt_bytes"] == nbytes(state)
    assert rec["per_device"]["param_bytes"] < rec["param_bytes_global"]
    axes = rec["roofline"]["collective_by_axis"]
    assert set(axes) == {"data", "model"} and min(axes.values()) > 0
    assert rec["roofline"]["link_bw_by_axis"] == {"data": analysis.NVLINK_BW,
                                                  "model": analysis.NVLINK_BW}


# ---------------------------------------------------------------------------
# the kernel table's bound, and the quickstart example
# ---------------------------------------------------------------------------

def _old_bound_ms(n, c, k, v, m, x_bytes, *, kernel="lut_amm"):
    """chip_smoke.bound_ms as it was before its constants and count moved to
    roofline.analysis (PERF.md's kernel table was computed by it)."""
    hbm, fp32, int8 = 3.35e12, 67e12, 1979e12
    if kernel == "encode":
        nbytes = n * c * v * x_bytes + c * k * v * 4 + n * c * 4
        t_ops = 2 * n * c * k * v / fp32
    else:
        nbytes = n * c * v * x_bytes + c * k * v * 4 + c * k * m + m * 4 + n * m * x_bytes
        lookup = 2 * n * c * m / fp32 if kernel == "lut_amm_v1" else n * c * m / int8
        t_ops = 2 * n * c * k * v / fp32 + lookup
    t_bytes = nbytes / hbm
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("kernel", ["fused_decode", "lut_amm_v2", "lut_amm_v1", "encode"])
def test_lut_site_cost_equals_the_old_kernel_bound(kernel):
    """The four qwen3_1p7b sites (q/o, k/v, gate/up, down) x N = 4, 20, 128:
    the bound of each kernel row, bit for bit."""
    for c, m in ((64, 2048), (64, 1024), (64, 6144), (192, 2048)):
        for n in (4, 20, 128):
            cost = analysis.lut_site_cost(n, c, 16, 32, m, 4, kernel)
            assert (cost.t_bound * 1e3, cost.bound_by) == _old_bound_ms(n, c, 16, 32, m, 4,
                                                                        kernel=kernel)
    assert autotune.HBM_BW is analysis.HBM_BW and autotune.FP32_FLOPS is analysis.FP32_FLOPS


def test_quickstart_table1_numbers_equal_the_reference(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples_torch" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.main(["--device", "cpu"])
    n, d, m = mod.N, mod.D, mod.M
    cfg = rcore.LUTConfig(k=16, v=8, bits=8)
    assert (n, d, m, mod.CFG.k, mod.CFG.v) == (1024, 256, 512, 16, 8)
    assert got["dense_flops"] == rcore.dense_flops(n, d, m)
    assert got["lut_flops"] == rcore.lut_flops(n, d, m, cfg)
    assert got["dense_bytes"] == rcore.dense_bytes(d, m)
    assert got["lut_table_bytes"] == rcore.lut_table_bytes(d, m, cfg)
    assert 0 < got["rel_error"] < 0.5
    assert "paper Table 1" in capsys.readouterr().out
