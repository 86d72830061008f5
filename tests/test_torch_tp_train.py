"""Tensor-parallel training on a ("data", "model") mesh: the port's (2, 2)
step of the dense decoder LMs against its single-rank step, with the
reference's fake-quant scales and checkpoint format.

One spawn of 4 gloo ranks on the CPU does all the rank work of this module
on the (2, 2) mesh that `elastic.ElasticContext.build` makes of 4 devices
with prefer_model=2 (`tests/_tp_ranks.py`), at the reduced sizes of the
reference's sharded test (tests/test_sharded.py: llama3_8b, 2 layers, width
64, vocab 64) and its qwen3_1p7b LUT_TRAIN variant (layer 0 dense, layer 1
LUT): 3 DENSE steps (clip 1.0), one LUT_TRAIN step with grad_accum 2, each
rank's gradients before the update, the Trainer's commits, the fake-quant
scales of row and column shards, and the FSDP steps and commit. Held here:

  * the losses against the single-rank step within SINGLE_LOSS_RTOL, the
    first step's params by the leaf rule (`testing.AdamLeafRule`), the last
    DENSE step's by the float64 witness (`testing.witness_ratio`);
  * every gradient leaf (gathered to whole leaves) against the single-rank
    gradient: L2 and largest entry within GRAD_L2 / GRAD_MAX, log_t within
    1e-6 of its terms' magnitudes (a cancelling sum). A missing or doubled
    model-axis sum is off by a factor;
  * the global norm against the single-rank norm;
  * each rank's param and moment shapes against `ShardingRules(data=2,
    model=2)`'s `param_spec` / `opt_spec` cuts; replicated leaves bytewise
    equal across each model group and params across each data group;
  * the fake-quant scale of a row and a column shard in each layout
    (per-codebook, per-column, m-shared) equal to the reference's
    unsharded scale of the same numpy table, and the shard's fake-quant
    values its part of the unsharded ones;
  * a Trainer commit from (2, 2) that the reference's Checkpointer
    restores, and that the port restores bytewise at (2, 2), (1, 2) and one
    rank;
  * FSDP (`ShardingRules(fsdp=True)`) at (2, 2): three DENSE steps held as
    the ZeRO-1 steps are, each rank's parts by `param_spec(fsdp=True)`, no
    all-gather after the update, and a Trainer commit in the reference's
    layout that restores under ZeRO-1 and FSDP at other meshes (and the
    ZeRO-1 commit under FSDP);
  * the refusals that remain: the enc-dec and vision-LM families under
    tensor-parallel training (the MoE, SSM and hybrid families:
    tests/test_torch_tp_train_families.py).

The reference's (2, 4) sharded step against the port's (2, 2) step is in
tests/test_torch_dp.py, beside its module-scoped reference fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.configs import build_model as jbuild
from repro.configs import get_arch as jget
from repro.configs import reduce_arch as jreduce
from repro.core import quant as jquant
from repro.core.amm import Mode as JMode
from repro.optim import AdamW as JAdamW
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.distributed import elastic, tensor_parallel
from repro_torch.distributed.data_parallel import Zero1, make_sharded_grads_fn
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import HostMesh
from repro_torch.testing import (GRAD_L2, GRAD_MAX, WITNESS, _rel, expected_rank_shapes,
                                 lut_train_grads, witness_ratio)
from repro_torch.weights import (reference_arrays, reference_leaves, tree_from_reference,
                                 tree_map_ref)
from tests._tp_ranks import (dp_batch, dp_model, dp_single, run_ranks, tp_elastic_jobs,
                             tp_single_grads)

SHARDED = dict(arch="llama3_8b", layers=2, vocab=64, d=64, d_ff=128, mode="dense", lr=1e-2,
               clip=None, batch=8, seq=16)
DENSE = dict(SHARDED, clip=1.0)
LUT = dict(SHARDED, arch="qwen3_1p7b", mode="lut_train", accum=2, wd=0.01)
FSDP = dict(DENSE, fsdp=True)        # weights and tables over "data" too
MESH = (2, 2)
DENSE_STEPS, TRAINER_STEPS, FSDP_STEPS = 3, 4, 3
SINGLE_LOSS_RTOL = 1e-5
NORM_RTOL = 1e-6
LOG_T_TERMS = 1e-6
SCALE_TABLE = (8, 4, 12)           # (C, K, M): C and M both split by 2
LAYOUTS = {"per_codebook": (False, False), "per_column": (True, False),
           "m_shared": (False, True)}


def _scale_cases() -> list:
    rng = np.random.default_rng(0)
    return [(role, pc, m8, rng.standard_normal(SCALE_TABLE).astype(np.float32)
             * rng.uniform(0.1, 3.0, (SCALE_TABLE[0], 1, SCALE_TABLE[2])).astype(np.float32))
            for role in ("col", "row") for pc, m8 in LAYOUTS.values()]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> dict:
    ck, ck_fsdp = tmp_path_factory.mktemp("tp_ck"), tmp_path_factory.mktemp("tp_ck_fsdp")
    cases = _scale_cases()
    jobs = [("tp_train", (DENSE, None, DENSE_STEPS)), ("tp_train", (LUT, None, 1)),
            ("tp_trainer", (DENSE, str(ck), TRAINER_STEPS)), ("tp_scales", (cases,)),
            ("tp_train", (FSDP, None, FSDP_STEPS)),
            ("tp_trainer", (FSDP, str(ck_fsdp), TRAINER_STEPS))]
    # the mesh of an elastic context over 4 devices that prefers model 2: (2, 2)
    out = run_ranks(tp_elastic_jobs, 4, 4, MESH[1], jobs, axis=None)
    assert all(r[-1] == {"mesh": MESH, "rules": MESH} for r in out)
    return {"dense": [r[0] for r in out], "lut": [r[1] for r in out],
            "trainer": [r[2] for r in out], "scales": [r[3] for r in out], "ck": ck,
            "cases": cases, "fsdp": [r[4] for r in out], "fsdp_trainer": [r[5] for r in out],
            "ck_fsdp": ck_fsdp}


def _as_tree(flat: dict, like) -> dict:
    return tree_from_reference(like, flat, device="cpu")


def _hold_log_t(got_1, grads: dict, params, opt) -> None:
    """Each log_t after one step against AdamW applied to the rank's own
    gradient (held against the single rank's by its terms in
    `test_tp_gradients_match_the_single_rank_gradients`): within 1e-5 of its
    move and 2 ulps of its value. A log_t gradient is a cancelling sum far
    below Adam's eps (~1e-9 against 1e-8), so its first update is
    proportional to it and carries its relative rounding (~1e-4), which the
    leaf rule's 1e-4 of the move does not leave room for."""
    assert opt.clip_norm is None
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
    assert n > 0


@pytest.mark.parametrize("case", ["dense", "lut"])
def test_tp_steps_match_the_single_rank_step(ranks, case):
    """3 DENSE steps, or one LUT_TRAIN step with grad_accum 2, at (2, 2):
    the losses, the first step by the leaf rule (a log_t by AdamW of the
    rank's own gradient, `_hold_log_t`), the last DENSE step by the float64
    witness; frozen leaves untouched."""
    spec, steps = (DENSE, DENSE_STEPS) if case == "dense" else (LUT, 1)
    losses, states, rule, params = dp_single(spec, None, steps)
    bundle, _, opt, frozen = dp_model(spec)
    like = {"params": params, "opt": opt.init(params, frozen)}
    single = _as_tree(states[-1], like)
    if steps > 1:
        _, exact, _, _ = dp_single(spec, None, steps, float64=True)
        witness = _as_tree(exact[-1], {"params": {k: v for k, v in params.items()},
                                       "opt": opt.init(params, frozen)})
    single_1 = _as_tree(states[0], like)["params"]
    frozen_paths = [p for p, ls in reference_leaves(frozen or {}).items() if ls[0]]
    assert case == "dense" or frozen_paths
    start = reference_arrays(params)
    for r in ranks[case]:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        got_1 = _as_tree(r["params_1"], params)
        if case == "lut":
            _hold_log_t(got_1, r["grads"], params, opt)
            got_1 = tree_map_ref(lambda p, g, w: w if p.endswith("log_t") else g, got_1,
                                 single_1)
        worst, where = rule.check(got_1, single_1, params)
        assert worst <= 1.0, (r["rank"], worst, where)
        assert sorted(r["arrays"]) == sorted(states[-1])
        got = _as_tree(r["arrays"], like)
        if steps > 1:
            for key, start in (("params", params), ("opt", None)):
                ratio, where = witness_ratio(got[key], single[key], witness[key], start)
                assert ratio <= WITNESS, (key, ratio, where)
        for path in frozen_paths:                    # frozen: untouched
            np.testing.assert_array_equal(r["arrays"][f"params/{path}"], start[path],
                                          err_msg=path)
        assert int(r["arrays"]["opt/.step"]) == steps
        assert sum(r["launches"].values()) == 0 and r["plain"] == 0


@pytest.mark.parametrize("case", ["dense", "lut"])
def test_tp_gradients_match_the_single_rank_gradients(ranks, case):
    """Every gradient leaf, before the update, gathered to whole leaves,
    against the single-rank gradient; the global norm likewise."""
    spec = DENSE if case == "dense" else LUT
    single = tp_single_grads(spec)
    terms = {}
    if case == "lut":            # log_t's scale: the magnitudes of its cancelling terms
        bundle, params, _, _ = dp_model(spec)
        terms = lut_train_grads(bundle, params, dp_batch(spec, 0))[3]
    n_log_t = 0
    for r in ranks[case]:
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
                n_log_t += 1
                continue
            l2, mx = _rel(torch.as_tensor(got), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (r["rank"], path, l2, mx)
    assert case == "dense" or n_log_t > 0


@pytest.mark.parametrize("case", ["dense", "lut"])
def test_tp_rank_shapes_and_replicas(ranks, case):
    """Each rank's params and moments are its `ShardingRules(data=2,
    model=2)` cut; replicated leaves are bytewise equal across each model
    group and params across each data group; the collectives ran on both
    axes."""
    spec = DENSE if case == "dense" else LUT
    bundle, params, _, frozen = dp_model(spec)
    rules = ShardingRules(data=2, model=2)
    frozen_paths = {p for p, ls in reference_leaves(frozen or {}).items() if ls[0]}
    lay = tensor_parallel.layout(bundle, rules, train=True)
    by = {tuple(r["rank"]): r for r in ranks[case]}
    for (d, m), r in by.items():
        want_p, want_m = expected_rank_shapes(bundle, rules, d, frozen_paths)
        assert r["param_shapes"] == {p: [tuple(s) for s in v] for p, v in want_p.items()}
        assert r["moment_shapes"] == {p: [tuple(s) for s in v] for p, v in want_m.items()}
        other = by[(d, 1 - m)]                      # the same data row, the other model rank
        for path, a in r["local"].items():
            if path not in lay.cuts:
                np.testing.assert_array_equal(a, other["local"][path], err_msg=path)
            np.testing.assert_array_equal(a, by[(1 - d, m)]["local"][path], err_msg=path)
        c = r["axis_counters"]
        assert c["model"]["all_reduce"] > 0 and c["data"]["all_mean"] > 0
        assert c["data"]["all_gather"] + c["data"]["broadcast"] > 0
    assert lay.roles and (case == "dense" or lay.partial)


def test_fake_quant_scales_of_row_and_column_shards_are_the_unsharded_ones(ranks):
    """A row (C-split) and a column (M-split) shard's fake-quant scale, in
    each layout, is its part of the reference's scale of the whole numpy
    table; its fake-quantized values are its part of the port's unsharded
    ones. The layouts whose max runs over the split axis take the peers'
    max (`reduced`); the others are local."""
    from repro_torch.core import quant

    c, _, m = SCALE_TABLE
    for i, (role, pc, m8, table) in enumerate(ranks["cases"]):
        want_s = np.asarray(jquant.table_scale(jnp.asarray(table), per_column=pc, m_shared=m8))
        want_fq = quant.fake_quant(torch.as_tensor(table), per_column=pc, m_shared=m8).numpy()
        for r, res in zip(ranks["dense"], ranks["scales"]):
            mr = r["rank"][1]
            got = res[i]
            assert got["reduced"] == ((role == "row") if m8 else (role == "col" and not pc))
            if role == "col":
                part_fq = want_fq[:, :, mr * m // 2:(mr + 1) * m // 2]
                part_s = want_s if want_s.shape[-1] == 1 else \
                    want_s[..., mr * m // 2:(mr + 1) * m // 2]
            else:
                part_fq = want_fq[mr * c // 2:(mr + 1) * c // 2]
                part_s = want_s if want_s.shape[0] == 1 else want_s[mr * c // 2:(mr + 1) * c // 2]
            np.testing.assert_array_equal(got["scale"], part_s, err_msg=f"{role} {pc} {m8}")
            np.testing.assert_array_equal(got["fq"], part_fq, err_msg=f"{role} {pc} {m8}")


def _restore_on(spec, ck: str, data: int, model: int, rank: int, fsdp: bool = False):
    """The port's restore of the newest commit as rank `rank` of a (data,
    model) mesh (shapes and cuts only: no process group), under ZeRO-1 or
    FSDP: its params and moments."""
    bundle, params, opt, frozen = dp_model(spec)
    mesh = HostMesh(data=data, model=model, rank=rank, device=torch.device("cpu"),
                    backend="gloo")
    rules = ShardingRules(data=data, model=model, fsdp=fsdp)
    if model > 1 or fsdp:
        _, lp, lay = tensor_parallel.place(bundle, params, rules, mesh, train=True)
        layout = Zero1.build(mesh, lp, frozen, rules, tp=lay)
    else:
        lp, layout = params, Zero1.build(mesh, params, frozen, rules)
    like = {"params": lp, "opt": layout.init_state(opt, lp, frozen)}
    return Checkpointer(ck).restore(like, shardings=layout.cuts(lp))


def test_trainer_commit_is_the_reference_layout_and_restores_at_any_mesh(ranks):
    """The Trainer at (2, 2): rank 0 commits the gathered state; the
    reference restores it; the port restores it bytewise as each rank of
    (2, 2) (its own shards at the commit), of (1, 2) (its model shards) and
    as one rank (everything)."""
    ck = str(ranks["ck"])
    jb = jbuild(jreduce(jget("llama3_8b"), n_layers=2, vocab=64, d_model=64, d_ff=128),
                JMode.DENSE)
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    step, tree = JCheckpointer(ck).restore({"params": jp, "opt": jax.eval_shape(JAdamW().init,
                                                                                  jp)})
    with np.load(ranks["ck"] / f"step_{TRAINER_STEPS:08d}" / "arrays.npz") as f:
        files = dict(f)
    got = jflatten(tree)
    assert step == TRAINER_STEPS and sorted(got) == sorted(files)
    for path, a in got.items():
        np.testing.assert_array_equal(a, files[path], err_msg=path)
    for r in ranks["trainer"]:                  # every rank gathered the committed state
        assert sorted(r["whole"]) == sorted(files)
        for path, a in r["whole"].items():
            np.testing.assert_array_equal(a, files[path], err_msg=path)
    for d, m in ((2, 2), (1, 2), (1, 1)):
        for rank in range(d * m):
            k, restored = _restore_on(DENSE, ck, d, m, rank)
            assert k == TRAINER_STEPS
            got = {p: [t.numpy() for t in ls] for p, ls in reference_leaves(restored).items()}
            if (d, m) == (2, 2):             # each rank's own shards at the commit
                want = next(r for r in ranks["trainer"]
                            if tuple(r["rank"]) == (rank // 2, rank % 2))["own"]
            else:                            # its model shard of each whole layer
                bundle, _, _, _ = dp_model(DENSE)
                lay = (tensor_parallel.layout(bundle, ShardingRules(data=d, model=m), train=True)
                       if m > 1 else None)

                def part(path, a, lay=lay, rank=rank):
                    key = path.split("/", 2)[-1] if path.startswith("opt/") else \
                        path.split("/", 1)[1]
                    if lay is None or a.shape == (0,) or key not in lay.cuts:
                        return a
                    return tensor_parallel.cut(torch.as_tensor(a), lay.cuts[key], rank,
                                               lay.tp).numpy()

                want = {p: [part(p, a) for a in (files[p] if "segments/" in p else [files[p]])]
                        for p in files}
            assert sorted(got) == sorted(want)
            for path, layers in want.items():
                for j, a in enumerate(layers):
                    np.testing.assert_array_equal(got[path][j], a,
                                                  err_msg=f"{(d, m)} {rank} {path}[{j}]")


def test_remaining_refusals_name_their_reason():
    """A model mesh (or FSDP) without a training layout and a whole-logits
    loss on a model mesh are refused; tensor-parallel training admits the
    enc-dec and vision-LM families, DENSE and LUT_TRAIN (`tp_refusal(train=
    True)` is None and `layout(train=True)` builds them; their steps:
    tests/test_torch_tp_encdec_vlm.py), and refuses LUT_INFER bundles. FSDP builds: `Zero1.build` under
    `ShardingRules(fsdp=True)` on the layout of its parts (a data cut of
    every leaf the spec splits over "data" too), and
    `ElasticContext.build(fsdp=True)` hands its step FSDP's rules. The
    decoder LMs and the MoE, SSM and hybrid families train
    (tests/test_torch_tp_train_families.py)."""
    bundle, params, _, _ = dp_model(DENSE)
    mesh = HostMesh(data=2, model=2, rank=0, device=torch.device("cpu"), backend="gloo")
    fsdp = ShardingRules(data=2, model=2, fsdp=True)
    with pytest.raises(ValueError, match="FSDP trains a rank's parts"):
        Zero1.build(mesh, params, rules=fsdp)
    _, fp, flay = tensor_parallel.place(bundle, params, fsdp, mesh, train=True)
    built = Zero1.build(mesh, fp, None, fsdp, tp=flay)
    assert built.fsdp and flay.fsdp and flay.dp == 2
    cut = {p: c for p, cs in reference_leaves(built.params_plan).items() for c in cs}
    assert {p for p, c in cut.items() if c.dim is not None} == set(flay.fsdp)
    made = {}
    ctx = elastic.ElasticContext.build(["cpu"], lambda m, r: made.setdefault("rules", r),
                                       fsdp=True)
    assert ctx.rules.fsdp and made["rules"] is ctx.rules and (ctx.mesh.data, ctx.mesh.model) \
        == (1, 1)
    with pytest.raises(ValueError, match="tensor-parallel shard"):
        Zero1.build(mesh, params, rules=ShardingRules(data=2, model=2))
    rules = ShardingRules(data=2, model=2)
    _, lp, lay = tensor_parallel.place(bundle, params, rules, mesh, train=True)
    layout = Zero1.build(mesh, lp, None, rules, tp=lay)
    with pytest.raises(NotImplementedError, match="vocab-parallel"):
        make_sharded_grads_fn(bundle, layout, loss_fn=lambda p, b: None)
    for name in ("whisper_tiny", "qwen2_vl_7b"):
        for mode in (Mode.DENSE, Mode.LUT_TRAIN):
            b = build_model(reduce_arch(get_arch(name), n_layers=2), mode)
            assert tensor_parallel.tp_refusal(b, train=True) is None, name
            lay = tensor_parallel.layout(b, rules, train=True)
            assert lay.train and lay.roles, name
        b = build_model(reduce_arch(get_arch(name), n_layers=2), Mode.LUT_INFER)
        assert "not LUT_INFER" in tensor_parallel.tp_refusal(b, train=True)
        with pytest.raises(NotImplementedError, match="not LUT_INFER"):
            tensor_parallel.layout(b, rules, train=True)
    for name in ("qwen3_1p7b", "llama3_8b", "arctic_480b", "llama4_maverick_400b",
                 "mamba2_370m", "zamba2_1p2b"):
        for mode in (Mode.DENSE, Mode.LUT_TRAIN):
            assert tensor_parallel.tp_refusal(build_model(reduce_arch(get_arch(name)), mode),
                                              train=True) is None


# ---------------------------------------------------------------------------
# FSDP at (2, 2): weights and tables over "data" too, inside the model shards
# ---------------------------------------------------------------------------

def test_fsdp_tp_steps_match_the_single_rank_step(ranks):
    """Three FSDP DENSE steps at (2, 2) (each rank its data part of its model
    shard of every leaf `param_spec(fsdp=True)` splits over "data", gathered
    per block): the losses, the first step by the leaf rule, the last by
    the float64 witness, as the ZeRO-1 steps are held, the gradients before
    the update (gathered to whole leaves) and their global norm against the
    single rank's."""
    losses, states, rule, params = dp_single(FSDP, None, FSDP_STEPS)
    _, exact, _, _ = dp_single(FSDP, None, FSDP_STEPS, float64=True)
    _, _, opt, frozen = dp_model(FSDP)
    like = {"params": params, "opt": opt.init(params, frozen)}
    single, witness = _as_tree(states[-1], like), _as_tree(exact[-1], like)
    grads = tp_single_grads(FSDP)
    for r in ranks["fsdp"]:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        worst, where = rule.check(_as_tree(r["params_1"], params),
                                  _as_tree(states[0], like)["params"], params)
        assert worst <= 1.0, (r["rank"], worst, where)
        got = _as_tree(r["arrays"], like)
        for key, start in (("params", params), ("opt", None)):
            ratio, where = witness_ratio(got[key], single[key], witness[key], start)
            assert ratio <= WITNESS, (key, ratio, where)
        assert abs(r["grad_norm0"] - grads["norm"]) <= NORM_RTOL * grads["norm"]
        for path, want in grads["grads"].items():
            l2, mx = _rel(torch.as_tensor(r["grads"][path]), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (r["rank"], path, l2, mx)
        assert sum(r["launches"].values()) == 0 and r["plain"] == 0


def test_fsdp_tp_rank_shapes_and_replicas(ranks):
    """Each rank holds exactly its `ShardingRules(data=2, model=2,
    fsdp=True)` part of every param, its moments the same; a leaf the spec
    keeps whole over "data" is bytewise equal across each data group (and,
    kept whole over "model" too, across each model group); the data gathers
    and their reduce-scatters ran, and a step gathers nothing after its
    update (its gathers are its gradient fn's)."""
    bundle = dp_model(FSDP)[0]
    rules = ShardingRules(data=2, model=2, fsdp=True)
    lay = tensor_parallel.layout(bundle, rules, train=True)
    assert lay.fsdp and "embed/table" in lay.fsdp
    by = {tuple(r["rank"]): r for r in ranks["fsdp"]}
    for (d, m), r in by.items():
        want_p, want_m = expected_rank_shapes(bundle, rules, d)
        assert r["param_shapes"] == {p: [tuple(s) for s in v] for p, v in want_p.items()}
        assert r["moment_shapes"] == {p: [tuple(s) for s in v] for p, v in want_m.items()}
        for path, a in r["local"].items():
            if path in lay.fsdp:
                continue
            np.testing.assert_array_equal(a, by[(1 - d, m)]["local"][path], err_msg=path)
            if path not in lay.cuts:
                np.testing.assert_array_equal(a, by[(d, 1 - m)]["local"][path], err_msg=path)
        c = r["axis_counters"]
        assert c["data"]["all_gather"] > 0 and c["data"]["reduce_scatter"] > 0
        assert c["model"]["all_reduce"] > 0 and c["data"]["all_mean"] > 0
        assert r["step_gathers"] == [r["grad_counters"]["data"]["all_gather"]] * FSDP_STEPS


def test_fsdp_commit_is_the_reference_layout_and_restores_under_zero1_and_fsdp(ranks):
    """The Trainer under FSDP at (2, 2): rank 0 commits the gathered state,
    which the reference's Checkpointer restores bytewise; every rank
    restores its own parts at the commit; the commit restores under ZeRO-1
    at (2, 2) and (1, 2) and under FSDP at (2, 1), and the ZeRO-1 commit of
    `test_trainer_commit_is_the_reference_layout_and_restores_at_any_mesh`
    under FSDP at (2, 2): each param its part of the committed array, each
    moment of its rank's shape."""
    ck = ranks["ck_fsdp"]
    jb = jbuild(jreduce(jget("llama3_8b"), n_layers=2, vocab=64, d_model=64, d_ff=128),
                JMode.DENSE)
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    step, tree = JCheckpointer(str(ck)).restore(
        {"params": jp, "opt": jax.eval_shape(JAdamW().init, jp)})
    with np.load(ck / f"step_{TRAINER_STEPS:08d}" / "arrays.npz") as f:
        files = dict(f)
    got = jflatten(tree)
    assert step == TRAINER_STEPS and sorted(got) == sorted(files)
    for path, a in got.items():
        np.testing.assert_array_equal(a, files[path], err_msg=path)
    for r in ranks["fsdp_trainer"]:
        for path, a in r["whole"].items():
            np.testing.assert_array_equal(a, files[path], err_msg=path)
    bundle = dp_model(FSDP)[0]
    for source, commit in ((ck, files), (ranks["ck"], None)):
        if commit is None:
            with np.load(source / f"step_{TRAINER_STEPS:08d}" / "arrays.npz") as f:
                commit = dict(f)
        meshes = ([(2, 2, False), (1, 2, False), (2, 1, True), (2, 2, True)] if source == ck
                  else [(2, 2, True)])
        for d, m, fsdp in meshes:
            rules = ShardingRules(data=d, model=m, fsdp=fsdp)
            lay = (tensor_parallel.layout(bundle, rules, train=True) if m > 1 or fsdp
                   else None)
            for rank in range(d * m):
                k, restored = _restore_on(FSDP, str(source), d, m, rank, fsdp=fsdp)
                assert k == TRAINER_STEPS
                dr, mr = rank // m, rank % m
                if (source, d, m, fsdp) == (ck, 2, 2, True):     # its own parts at the commit
                    own = next(r for r in ranks["fsdp_trainer"]
                               if tuple(r["rank"]) == (dr, mr))["own"]
                    got = {p: [t.numpy() for t in ls]
                           for p, ls in reference_leaves(restored).items()}
                    assert sorted(got) == sorted(own)
                    for path, layers in own.items():
                        for j, a in enumerate(layers):
                            np.testing.assert_array_equal(got[path][j], a, err_msg=path)
                for path, layers in reference_leaves(restored["params"]).items():
                    whole = torch.as_tensor(commit[f"params/{path}"])
                    for j, t in enumerate(layers):
                        w = whole[j] if path.startswith("segments/") else whole
                        part = w if lay is None else lay.part(path, w, dr, mr)
                        np.testing.assert_array_equal(t.numpy(), part.numpy(),
                                                      err_msg=f"{(d, m, fsdp)} {rank} {path}")
                _, want_m = expected_rank_shapes(bundle, rules, dr)
                for path, layers in reference_leaves(restored["opt"].m).items():
                    assert [tuple(t.shape) for t in layers] == want_m[path], (d, m, path)
