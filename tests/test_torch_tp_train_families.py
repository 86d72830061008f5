"""Tensor-parallel training of the MoE, SSM and hybrid families on a
("data", "model") = (2, 2) mesh: the port's step against its single-rank
step, with the experts over both axes, the SSD heads and the shared block.

One spawn of 4 gloo ranks on the CPU does all the rank work of this module
(`tests/_tp_ranks.py`) at reduced width, with E, the heads and the
codebooks divisible by dp * tp: arctic_480b (top-2 and a dense residual
branch, grad_accum 2), llama4_maverick_400b (top-1 and a shared expert),
mamba2_370m and zamba2_1p2b (4 mamba layers, two invocations of the shared
block), each DENSE (two steps, clip 1.0) and LUT_TRAIN (one step, layer 0
dense and layer 1 LUT, expert sites included). Held here, per family:

  * the losses against the single-rank step within SINGLE_LOSS_RTOL, the
    first step's params by the leaf rule (`testing.AdamLeafRule`; a log_t
    by AdamW of its rank's own gradient), the second DENSE step's by the
    float64 witness (`testing.witness_ratio`); frozen leaves untouched;
  * every gradient leaf (gathered to whole leaves, the experts over both
    axes) against the single-rank gradient within GRAD_L2 / GRAD_MAX, a
    log_t within LOG_T_TERMS of its terms' magnitudes; the global norm. A
    missing or doubled model-axis sum (the aux term, a B/C block, the norm
    scale) or data-axis scale (an expert leaf) is off by a factor;
  * each rank's routing decisions bytewise the single rank's on its rows,
    and each of its experts' outputs bytewise the unsharded experts' on
    the slots it received from every data rank;
  * each rank's param and moment shapes (`testing.expected_rank_shapes`
    with the layout's kept differences); replicated leaves bytewise equal
    across each model group and params across each data group (but the
    experts, which differ by data rank); the data all-to-all ran;
  * a Trainer commit from (2, 2) in the reference's layout (the reference's
    Checkpointer restores it), which the port restores at (4, 1) and
    (1, 2);
  * under FSDP (`ShardingRules(fsdp=True)`), one DENSE step of arctic_480b,
    mamba2_370m and zamba2_1p2b: the loss, the leaf rule, the gradients and
    their norm, each rank's parts and the replicas.

The reference's (2, 4) sharded step against the port's (2, 2) step of
reduced arctic_480b and mamba2_370m is in tests/test_torch_dp.py."""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.configs import build_model as jbuild
from repro.configs import get_arch as jget
from repro.configs import reduce_arch as jreduce
from repro.core.amm import Mode as JMode
from repro.optim import AdamW as JAdamW
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.data_parallel import Zero1
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import activation
from repro_torch.testing import (GRAD_L2, GRAD_MAX, WITNESS, _rel, expected_rank_shapes,
                                 lut_train_grads, witness_ratio)
from repro_torch.weights import (is_stacked, reference_arrays, reference_leaves,
                                 tree_from_reference, tree_map_ref)
from tests._tp_ranks import dp_batch, dp_model, dp_single, run_ranks, tp_jobs, tp_single_grads

BASE = dict(layers=2, vocab=64, d=64, d_ff=128, lr=1e-2, batch=8, seq=16)
FAMILIES = {"arctic_480b": dict(BASE, accum=2), "llama4_maverick_400b": BASE,
            "mamba2_370m": dict(BASE, d_ff=0), "zamba2_1p2b": dict(BASE, layers=4)}
MOE = ("arctic_480b", "llama4_maverick_400b")
COMMITS = ("arctic_480b", "zamba2_1p2b")
MODES = ("dense", "lut_train")
MESH = (2, 2)
DENSE_STEPS, TRAINER_STEPS = 2, 2
SINGLE_LOSS_RTOL = 1e-5
NORM_RTOL = 1e-6
LOG_T_TERMS = 1e-6
CASES = [(f, m) for f in FAMILIES for m in MODES]
# one FSDP DENSE step each (`ShardingRules(fsdp=True)`: weights over "data" too)
FSDP_FAMILIES = ("arctic_480b", "mamba2_370m", "zamba2_1p2b")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the models are small, and
    the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spec_of(family: str, mode: str) -> dict:
    if mode == "dense":
        return dict(FAMILIES[family], arch=family, mode="dense", clip=1.0)
    return dict(FAMILIES[family], arch=family, mode="lut_train", clip=None, wd=0.01)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> dict:
    ck = {f: tmp_path_factory.mktemp(f"ck_{f}") for f in COMMITS}
    jobs, keys = [], []
    for f, m in CASES:
        steps = DENSE_STEPS if m == "dense" else 1
        jobs.append(("tp_train", (spec_of(f, m), None, steps)))
        keys.append(("train", f, m))
        if f in MOE:
            jobs.append(("tp_route_record", (spec_of(f, m),)))
            keys.append(("route", f, m))
    for f in COMMITS:
        jobs.append(("tp_trainer", (spec_of(f, "dense"), str(ck[f]), TRAINER_STEPS)))
        keys.append(("trainer", f, "dense"))
    for f in FSDP_FAMILIES:
        jobs.append(("tp_train", (dict(spec_of(f, "dense"), fsdp=True), None, 1)))
        keys.append(("fsdp", f, "dense"))
    out = run_ranks(tp_jobs, 4, jobs, axis=MESH, timeout=600)
    return {"by": {k: [r[i] for r in out] for i, k in enumerate(keys)}, "ck": ck}


def _as_tree(flat: dict, like) -> dict:
    return tree_from_reference(like, flat, device="cpu")


def _layout(bundle, mesh=MESH):
    return tensor_parallel.layout(bundle, ShardingRules(data=mesh[0], model=mesh[1]), train=True)


def _hold_log_t(got_1, grads: dict, params, opt) -> int:
    """Each log_t after one step against AdamW applied to the rank's own
    gradient, within 1e-5 of its move and 2 ulps (tests/test_torch_tp_train.py:
    a log_t's gradient, a cancelling sum far below Adam's eps, is held by
    its terms in `test_family_tp_gradients_match_the_single_rank_gradients`)."""
    n = 0
    for path, layers in reference_leaves(got_1).items():
        if not path.endswith("log_t"):
            continue
        start = reference_leaves(params)[path]
        g = np.asarray(grads[path]).reshape(len(layers))
        for j, (p1, p0) in enumerate(zip(layers, start)):
            tree = {"site": {"log_t": p0}}
            want, _, _ = opt.update({"site": {"log_t": torch.tensor(g[j])}}, opt.init(tree), tree)
            want = want["site"]["log_t"]
            ulp = torch.finfo(torch.float32).eps * want.abs()
            assert (p1 - want).abs() <= 1e-5 * (want - p0).abs() + 2 * ulp, (path, j)
            n += 1
    return n


def test_the_families_train_on_a_model_mesh():
    """`tp_refusal(train=True)` admits the MoE, SSM and hybrid families, DENSE
    and LUT_TRAIN; their layouts name the kept differences and the partial
    leaves and blocks."""
    for name in FAMILIES:
        for mode in (Mode.DENSE, Mode.LUT_TRAIN):
            b = build_model(reduce_arch(get_arch(name), n_layers=2), mode)
            assert tensor_parallel.tp_refusal(b, train=True) is None, name
            lay = _layout(b)
            if name in MOE:
                assert lay.kept == ("experts_over_data_and_model",) and lay.data == 2
                assert any(p.endswith("moe/router/w") for p in lay.partial)
                assert all(p.rsplit("/", 2)[-2] in ("gate", "up", "down")
                           for p in lay.over_data) and lay.over_data
            else:
                assert "ssm_heads" in lay.kept and not lay.over_data
                blocks = {p.rsplit("/mamba/", 1)[1] for p, v in lay.partial.items()
                          if v is not None}
                assert blocks == {"conv_b", "conv_w", "in_proj/w"}, blocks
                assert any(p.endswith("mamba/norm/scale") for p in lay.partial)
    # at data = 1 the experts are over "model" only, as tensor-parallel serving places them
    b = build_model(reduce_arch(get_arch("arctic_480b"), n_layers=2), Mode.DENSE)
    assert _layout(b, (1, 2)).kept == ("experts_over_model",)


@pytest.mark.parametrize("family", MOE)
def test_init_rank_is_the_rank_part_of_the_whole_init(family):
    """`tensor_parallel.init_rank` draws the whole init's values and keeps
    each rank's part: bytewise `place(train=True)` of `bundle.init` from
    the same generator, at (2, 2) (experts over both axes) and (1, 2)."""
    spec = spec_of(family, "lut_train")
    bundle = dp_model(spec)[0]
    whole = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    for d, m in ((2, 2), (1, 2)):
        rules = ShardingRules(data=d, model=m)
        for rank in range(d * m):
            mesh = HostMesh(data=d, model=m, rank=rank, device=torch.device("cpu"),
                            backend="gloo")
            _, want, _ = tensor_parallel.place(bundle, whole, rules, mesh, train=True)
            _, got, lay = tensor_parallel.init_rank(bundle, rules, mesh,
                                                    torch.Generator().manual_seed(3))
            assert lay.over_data if d > 1 else not lay.over_data
            got, want = reference_leaves(got), reference_leaves(want)
            assert sorted(got) == sorted(want)
            for path, ls in want.items():
                for j, w in enumerate(ls):
                    assert torch.equal(got[path][j], w), ((d, m), rank, path, j)


@pytest.mark.parametrize("family", ["arctic_480b", "zamba2_1p2b"])
def test_init_rank_under_fsdp_is_the_rank_part_of_the_whole_init(family):
    """Under FSDP `init_rank` cuts each group of leaves as it is drawn (a
    layer, the embedding, the shared block: `transformer.init_keeping`) and
    keeps the rank's data part of each leaf the spec splits over "data":
    bytewise `place(train=True)` of `bundle.init` from the same generator,
    at (2, 2) and on a data mesh (2, 1)."""
    bundle = dp_model(spec_of(family, "lut_train"))[0]
    whole = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    for d, m in ((2, 2), (2, 1)):
        rules = ShardingRules(data=d, model=m, fsdp=True)
        for rank in range(d * m):
            mesh = HostMesh(data=d, model=m, rank=rank, device=torch.device("cpu"),
                            backend="gloo")
            _, want, _ = tensor_parallel.place(bundle, whole, rules, mesh, train=True)
            _, got, lay = tensor_parallel.init_rank(bundle, rules, mesh,
                                                    torch.Generator().manual_seed(3))
            assert lay.fsdp and lay.dp == d
            got, want = reference_leaves(got), reference_leaves(want)
            assert sorted(got) == sorted(want)
            for path, ls in want.items():
                for j, w in enumerate(ls):
                    assert torch.equal(got[path][j], w), ((d, m), rank, path, j)


def test_lut_train_grads_frees_the_graph_and_the_params():
    """`testing.lut_train_grads` with its log_t terms leaves nothing alive:
    a terms hook that held the tensor it is registered on made a cycle
    through autograd's graph that Python's collector cannot free, and with
    it every recomputed chunk's inputs, the expert weights among them
    (arctic_480b's ~27 GB on the card)."""
    import gc
    import weakref

    from repro_torch import testing

    spec = spec_of("arctic_480b", "lut_train")
    bundle, params, _, _ = dp_model(spec)
    w = weakref.ref(params["segments"][1][0]["moe"]["up"]["w"])
    terms = testing.lut_train_grads(bundle, params, dp_batch(spec, 0))[3]
    assert any(v[0] > 0 for p, v in terms.items() if "/moe/" in p)
    del params
    gc.collect()
    assert w() is None


@pytest.mark.parametrize("family,mode", CASES)
def test_family_tp_steps_match_the_single_rank_step(ranks, family, mode):
    """Two DENSE steps, or one LUT_TRAIN step, at (2, 2): the losses, the
    first step by the leaf rule (a log_t by AdamW of the rank's own
    gradient), the second DENSE step by the float64 witness; frozen leaves
    untouched; no LUT kernel and no plain LUT call."""
    spec = spec_of(family, mode)
    steps = DENSE_STEPS if mode == "dense" else 1
    losses, states, rule, params = dp_single(spec, None, steps)
    _, _, opt, frozen = dp_model(spec)
    like = {"params": params, "opt": opt.init(params, frozen)}
    single = _as_tree(states[-1], like)
    if steps > 1:
        _, exact, _, _ = dp_single(spec, None, steps, float64=True)
        witness = _as_tree(exact[-1], like)
    single_1 = _as_tree(states[0], like)["params"]
    frozen_paths = [p for p, ls in reference_leaves(frozen or {}).items() if ls[0]]
    assert mode == "dense" or frozen_paths
    start = reference_arrays(params)
    for r in ranks["by"][("train", family, mode)]:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        got_1 = _as_tree(r["params_1"], params)
        if mode == "lut_train":
            assert _hold_log_t(got_1, r["grads"], params, opt) > 0
            got_1 = tree_map_ref(lambda p, g, w: w if p.endswith("log_t") else g, got_1,
                                 single_1)
        worst, where = rule.check(got_1, single_1, params)
        assert worst <= 1.0, (r["rank"], worst, where)
        assert sorted(r["arrays"]) == sorted(states[-1])
        if steps > 1:
            got = _as_tree(r["arrays"], like)
            for key, st in (("params", params), ("opt", None)):
                ratio, where = witness_ratio(got[key], single[key], witness[key], st)
                assert ratio <= WITNESS, (key, ratio, where)
        for path in frozen_paths:
            np.testing.assert_array_equal(r["arrays"][f"params/{path}"], start[path],
                                          err_msg=path)
        assert int(r["arrays"]["opt/.step"]) == steps
        assert sum(r["launches"].values()) == 0 and r["plain"] == 0


@pytest.mark.parametrize("family,mode", CASES)
def test_family_tp_gradients_match_the_single_rank_gradients(ranks, family, mode):
    """Every gradient leaf before the update, gathered to whole leaves,
    against the single-rank gradient; the global norm likewise."""
    spec = spec_of(family, mode)
    single = tp_single_grads(spec)
    terms = {}
    if mode == "lut_train":
        bundle, params, _, _ = dp_model(spec)
        terms = lut_train_grads(bundle, params, dp_batch(spec, 0))[3]
    for r in ranks["by"][("train", family, mode)]:
        assert sorted(r["grads"]) == sorted(single["grads"]), r["rank"]
        assert abs(r["grad_loss"] - single["loss"]) <= SINGLE_LOSS_RTOL * abs(single["loss"])
        assert abs(r["grad_norm0"] - single["norm"]) <= NORM_RTOL * single["norm"], \
            (r["grad_norm0"], single["norm"])
        for path, want in single["grads"].items():
            got = r["grads"][path]
            assert got.shape == want.shape, path
            if path.endswith("log_t"):
                unit = np.maximum(np.asarray(terms[path]), 1e-30)
                assert (np.abs(got - want) <= LOG_T_TERMS * unit).all(), (path, got, want)
                continue
            l2, mx = _rel(torch.as_tensor(got), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (r["rank"], path, l2, mx)


def _single_routes(spec: dict):
    """The single rank's no-gradient forward of the first batch: each MoE
    layer's dispatch, and the bundle and params."""
    bundle, params, _, _ = dp_model(spec)
    route, got = moe_mod.route, []

    def record(cfg, p, x):
        out = route(cfg, p, x)
        got.append(out[2].clone())
        return out

    moe_mod.route = record
    try:
        with torch.no_grad():
            bundle.train_logits(params, dp_batch(spec, 0), compute_dtype=torch.float32)
    finally:
        moe_mod.route = route
    return got, bundle, params


def _moe_layers(bundle, params):
    """(MoE config, its params) of each MoE layer in forward order."""
    out = []
    for (count, bcfg), layers in zip(bundle.cfg.segments, params["segments"]):
        out += [(bcfg.moe, lp["moe"]) for lp in layers] if bcfg.kind == "moe" else []
    return out


@pytest.mark.parametrize("family,mode", [(f, m) for f in MOE for m in MODES])
def test_routing_and_expert_outputs_are_the_single_ranks_bytewise(ranks, family, mode):
    """Each rank's routing decisions (dispatch and kept slots) on its rows
    are the single rank's bytewise, and its experts' outputs on the slots
    every data rank sent them are the unsharded experts' on the same slots,
    bytewise; the slots came by the data all-to-all."""
    spec = spec_of(family, mode)
    want, bundle, params = _single_routes(spec)
    layers = _moe_layers(bundle, params)
    assert len(want) == len(layers) == spec["layers"]
    n_sent = 0
    for r in ranks["by"][("route", family, mode)]:
        d, _ = r["rank"]
        assert len(r["dispatch"]) == len(want)
        for got_d, want_d in zip(r["dispatch"], want):
            g = want_d.shape[0] // MESH[0]
            np.testing.assert_array_equal(got_d, want_d[d * g:(d + 1) * g].numpy())
        for rec, (cfg, p) in zip(r["experts"], layers):
            sent = torch.as_tensor(rec["sent"])
            active = sent.nonzero()[:, 0]
            ids = torch.as_tensor(rec["ids"])[active]
            xa = torch.as_tensor(rec["x"])[active]
            with torch.no_grad():
                gate = activation(cfg.act, moe_mod.expert_linear(cfg.gate, p["gate"], xa, ids))
                up = moe_mod.expert_linear(cfg.up, p["up"], xa, ids)
                out = moe_mod.expert_linear(cfg.down, p["down"], gate * up, ids)
            np.testing.assert_array_equal(torch.as_tensor(rec["h"])[active].numpy(), out.numpy())
            n_sent += int(active.numel())
        assert r["axis_counters"]["data"]["all_to_all"] == 2 * len(want)
    assert n_sent > 0


@pytest.mark.parametrize("family,mode", CASES)
def test_family_rank_shapes_and_replicas(ranks, family, mode):
    """Each rank's params and moments are its cut (the spec's, but for the
    layout's kept differences); replicated leaves bytewise equal across each
    model group, params across each data group but the experts; the
    collectives ran on both axes."""
    spec = spec_of(family, mode)
    bundle, _, _, frozen = dp_model(spec)
    rules = ShardingRules(data=2, model=2)
    frozen_paths = {p for p, ls in reference_leaves(frozen or {}).items() if ls[0]}
    lay = _layout(bundle)
    by = {tuple(r["rank"]): r for r in ranks["by"][("train", family, mode)]}
    for (d, m), r in by.items():
        want_p, want_m = expected_rank_shapes(bundle, rules, d, frozen_paths, lay.kept)
        assert r["param_shapes"] == {p: [tuple(s) for s in v] for p, v in want_p.items()}
        assert r["moment_shapes"] == {p: [tuple(s) for s in v] for p, v in want_m.items()}
        for path, a in r["local"].items():
            if path not in lay.cuts:
                np.testing.assert_array_equal(a, by[(d, 1 - m)]["local"][path], err_msg=path)
            if path not in lay.over_data:
                np.testing.assert_array_equal(a, by[(1 - d, m)]["local"][path], err_msg=path)
        c = r["axis_counters"]
        assert c["model"]["all_reduce"] > 0 and c["data"]["all_mean"] > 0
        assert (c["data"]["all_to_all"] > 0) == (family in MOE)


def _restore_on(spec, ck: str, data: int, model: int, rank: int):
    """The port's restore of the newest commit as rank `rank` of a (data,
    model) mesh (shapes and cuts only: no process group)."""
    bundle, params, opt, frozen = dp_model(spec)
    mesh = HostMesh(data=data, model=model, rank=rank, device=torch.device("cpu"),
                    backend="gloo")
    rules = ShardingRules(data=data, model=model)
    if model > 1:
        _, lp, lay = tensor_parallel.place(bundle, params, rules, mesh, train=True)
        layout = Zero1.build(mesh, lp, frozen, rules, tp=lay)
    else:
        lp, layout, lay = params, Zero1.build(mesh, params, frozen, rules), None
    like = {"params": lp, "opt": layout.init_state(opt, lp, frozen)}
    return Checkpointer(ck).restore(like, shardings=layout.cuts(lp)), lay


@pytest.mark.parametrize("family", COMMITS)
def test_family_commit_is_the_reference_layout_and_restores_at_other_meshes(ranks, family):
    """The Trainer at (2, 2): rank 0 commits the gathered state (experts
    and the SSD blocks back in the reference's order); the reference's
    Checkpointer restores it; the port restores each rank's part at (4, 1)
    (ZeRO-1 over 4 data ranks) and (1, 2) (the model shards), each param its
    part of the committed array and each moment of its rank's shape."""
    spec = spec_of(family, "dense")
    ck = ranks["ck"][family]
    arch = jreduce(jget(family), n_layers=spec["layers"], vocab=spec["vocab"],
                   d_model=spec["d"], d_ff=spec["d_ff"])
    jp = jax.eval_shape(jbuild(arch, JMode.DENSE).init, jax.random.PRNGKey(0))
    step, tree = JCheckpointer(str(ck)).restore(
        {"params": jp, "opt": jax.eval_shape(JAdamW().init, jp)})
    with np.load(ck / f"step_{TRAINER_STEPS:08d}" / "arrays.npz") as f:
        files = dict(f)
    got = jflatten(tree)
    assert step == TRAINER_STEPS and sorted(got) == sorted(files)
    for path, a in got.items():
        np.testing.assert_array_equal(a, files[path], err_msg=path)
    for r in ranks["by"][("trainer", family, "dense")]:      # every rank gathered it
        assert sorted(r["whole"]) == sorted(files)
        for path, a in r["whole"].items():
            np.testing.assert_array_equal(a, files[path], err_msg=path)
    bundle = dp_model(spec)[0]
    for d, m in ((4, 1), (1, 2)):
        rules = ShardingRules(data=d, model=m)
        for rank in range(d * m):
            (k, restored), lay = _restore_on(spec, str(ck), d, m, rank)
            assert k == TRAINER_STEPS
            dr, mr = rank // m, rank % m
            _, want_m = expected_rank_shapes(bundle, rules, dr, kept=lay.kept if lay else ())
            for path, layers in reference_leaves(restored["params"]).items():
                whole = torch.as_tensor(files[f"params/{path}"])
                for j, t in enumerate(layers):
                    w = whole[j] if is_stacked(path) else whole
                    part = w if lay is None else lay.part(path, w, dr, mr)
                    np.testing.assert_array_equal(t.numpy(), part.numpy(),
                                                  err_msg=f"{(d, m)} {rank} {path}[{j}]")
            for path, layers in reference_leaves(restored["opt"].m).items():
                assert [tuple(t.shape) for t in layers] == want_m[path], (d, m, rank, path)


@pytest.mark.parametrize("family", FSDP_FAMILIES)
def test_fsdp_family_tp_steps_match_the_single_rank_step(ranks, family):
    """One FSDP DENSE step at (2, 2) (arctic_480b with grad_accum 2: its
    router and attention weights over "data" too, its experts the rank's
    own; mamba2_370m's in_proj rows over "data" beside its head-selected
    columns; zamba2_1p2b's shared block gathered once per forward): the
    loss and the params after it by the leaf rule, the gradients before it
    (gathered) and their global norm, against the single rank's."""
    spec = dict(spec_of(family, "dense"), fsdp=True)
    losses, states, rule, params = dp_single(spec, None, 1)
    _, _, opt, frozen = dp_model(spec)
    want_1 = _as_tree(states[0], {"params": params, "opt": opt.init(params, frozen)})["params"]
    single = tp_single_grads(spec)
    for r in ranks["by"][("fsdp", family, "dense")]:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        worst, where = rule.check(_as_tree(r["params_1"], params), want_1, params)
        assert worst <= 1.0, (r["rank"], worst, where)
        assert abs(r["grad_norm0"] - single["norm"]) <= NORM_RTOL * single["norm"]
        for path, want in single["grads"].items():
            l2, mx = _rel(torch.as_tensor(r["grads"][path]), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (r["rank"], path, l2, mx)
        assert sum(r["launches"].values()) == 0 and r["plain"] == 0


@pytest.mark.parametrize("family", FSDP_FAMILIES)
def test_fsdp_family_rank_shapes_and_replicas(ranks, family):
    """Each rank's params and moments are its FSDP part (the spec's, but for
    the layout's kept differences: the experts whole over "data" where a
    rank holds its own, in_proj's head selection, the hybrid's fuse and out
    whole over "model"); a leaf kept whole over "data" is bytewise equal
    across each data group; the data gathers and their reduce-scatters ran,
    and the step gathered nothing after its update."""
    spec = dict(spec_of(family, "dense"), fsdp=True)
    bundle = dp_model(spec)[0]
    rules = ShardingRules(data=2, model=2, fsdp=True)
    lay = tensor_parallel.layout(bundle, rules, train=True)
    assert lay.fsdp and not set(lay.fsdp) & lay.over_data
    by = {tuple(r["rank"]): r for r in ranks["by"][("fsdp", family, "dense")]}
    for (d, m), r in by.items():
        want_p, want_m = expected_rank_shapes(bundle, rules, d, kept=lay.kept)
        assert r["param_shapes"] == {p: [tuple(s) for s in v] for p, v in want_p.items()}
        assert r["moment_shapes"] == {p: [tuple(s) for s in v] for p, v in want_m.items()}
        for path, a in r["local"].items():
            if path not in lay.fsdp and path not in lay.over_data:
                np.testing.assert_array_equal(a, by[(1 - d, m)]["local"][path], err_msg=path)
        c = r["axis_counters"]["data"]
        assert c["all_gather"] > 0 and c["reduce_scatter"] > 0
        assert r["step_gathers"] == [r["grad_counters"]["data"]["all_gather"]]
