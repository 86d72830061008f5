"""The port's data-parallel training layer against the reference's: the
sharding rules of the optimizer state (ZeRO-1), FSDP and the batch, the
data-parallel step with ZeRO-1 moments, elastic rescale, and checkpoints
across the packages.

Specs: for every param and moment leaf of all 11 archs (DENSE, LUT_TRAIN
and LUT_INFER trees at full published width, shapes only) at (data, model)
in {(2, 1), (2, 4), (4, 2)}: `opt_spec` through `opt_shardings` on the
port's per-layer AdamW state, and the `fsdp=True` `param_spec` (with and
without the site roles), equal to the reference's `PartitionSpec` entries;
`batch_shardings` with and without M-RoPE's pos. The reference's rules need
a mesh of that many devices, so its side runs in a subprocess with forced
host devices.

The step: one step at dp 2 (gloo ranks on the CPU) on the reference test's
reduced llama3_8b against the reference's sharded step (tests/test_sharded.py:
its bound, loss 1e-4, params rtol 1e-2 / atol 1e-3), and two steps against
the port's single-rank step within `testing.AdamLeafRule` (the rule of
tests/test_torch_train.py over several steps), dense and LUT_TRAIN with
grad_accum 2 (frozen leaves untouched); each rank's ZeRO-1 shards by
`opt_spec`; both ranks' params bytewise equal. The same reference step
against the port's (2, 2) tensor-parallel step with ZeRO-1 inside its model
shards (the rest of that slice: tests/test_torch_tp_train.py), and of
reduced arctic_480b and mamba2_370m (tests/test_torch_tp_train_families.py). Elastic
rescale and the Trainer's rank-0 commits: tests/test_torch_elastic.py.

FSDP (`ShardingRules(fsdp=True)`): the reference's (2, 4) GSPMD step under
its FSDP rules (the same subprocess) against the port's dp 2 and (2, 2)
FSDP steps within its bound; the dp-2 FSDP steps against the single-rank
step (3 DENSE steps with the float64 witness, LUT_TRAIN with grad_accum 2),
each rank's parts by `param_spec(fsdp=True)`, no all-gather after the
update; `HostMesh.reduce_scatter` (native and the CUDA-under-gloo
emulation) and the data gather's gradient in float64; and every rank's
param and moment bytes of full-width qwen3_1p7b, llama3_8b and
command_r_35b at (8, 1) and (2, 4), ZeRO-1 and FSDP, built on meta
tensors, against the reference's `shard_shape` sums."""

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, build_model, get_arch
from repro_torch.core.amm import Mode
from repro_torch.core.lut_layer import ParamSpec
from repro_torch.distributed.sharding import ShardingRules, site_roles
from repro_torch.optim import AdamWState, lut_frozen_mask
from repro_torch.testing import WITNESS, witness_ratio
from repro_torch.weights import layer_specs, reference_leaves, tree_from_reference, tree_map_ref
from tests._subproc import run_with_devices
from tests._tp_ranks import dp_batch, dp_model, dp_single, dp_train, run_ranks, tp_jobs

ARCHS = ARCH_IDS + EXTRA_IDS
MODES = ("dense", "lut_train", "lut_infer")
MESHES = ((2, 1), (2, 4), (4, 2))
BATCHES = {"lm": {"tokens": (8, 16), "labels": (8, 16)},
           "vlm": {"embeds": (8, 16, 32), "labels": (8, 16), "pos": (3, 8, 16)},
           "ragged": {"tokens": (6, 16), "labels": (6, 16), "pos": (3, 6, 16)}}
# the reference test's sharded step and its bound (tests/test_sharded.py)
SHARDED = dict(arch="llama3_8b", layers=2, vocab=64, d=64, d_ff=128, mode="dense", lr=1e-2,
               clip=None, batch=8, seq=16)
REF_LOSS_TOL, REF_RTOL, REF_ATOL = 1e-4, 1e-2, 1e-3
SINGLE_LOSS_RTOL = 1e-5      # the mean of two half-batch losses against the batch's
# the per-rank bytes of the full-width trees, ZeRO-1 against FSDP
BYTES_ARCHS = ("qwen3_1p7b", "llama3_8b", "command_r_35b")
BYTES_MESHES = ((8, 1), (2, 4))


def _js(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference_specs() -> dict:
    """{"d,m": {arch: {mode: {"opt", "fsdp", "fsdp_roles"}}, "batch": ...}} from
    the reference's rules on a (data, model) host mesh."""
    out = run_with_devices(textwrap.dedent(f"""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint.checkpointer import tree_paths
        from repro.configs import build_model, get_arch
        from repro.core.amm import Mode
        from repro.distributed.sharding import ShardingRules, site_roles
        from repro.launch.mesh import make_mesh
        from repro.optim import AdamW, lut_frozen_mask

        def js(spec):
            return [list(e) if isinstance(e, tuple) else e for e in spec]

        res = {{}}
        for d, m in {MESHES!r}:
            mesh = make_mesh((d, m), ("data", "model"))
            rules, fsdp = ShardingRules(mesh), ShardingRules(mesh, fsdp=True)
            per = res[f"{{d}},{{m}}"] = {{}}
            for name in {ARCHS!r}:
                for mode in {MODES!r}:
                    b = build_model(get_arch(name), Mode(mode))
                    specs = jax.eval_shape(b.init, jax.random.PRNGKey(0))
                    frozen = lut_frozen_mask(specs) if mode == "lut_train" else None
                    ospecs = jax.eval_shape(lambda p: AdamW().init(p, frozen), specs)
                    osh = rules.opt_shardings(ospecs)
                    leaves = dict(zip(tree_paths(specs), jax.tree_util.tree_leaves(specs)))
                    roles = site_roles(b)
                    per.setdefault(name, {{}})[mode] = {{
                        "opt": {{p: js(s.spec) for p, s in zip(
                            tree_paths(ospecs), jax.tree_util.tree_leaves(osh))}},
                        "fsdp": {{p: js(fsdp.param_spec(p, l.shape)) for p, l in leaves.items()}},
                        "fsdp_roles": {{p: js(fsdp.param_spec(p, l.shape, site_roles=roles))
                                       for p, l in leaves.items()}},
                    }}
            per["batch"] = {{
                k: {{n: js(s.spec) for n, s in rules.batch_shardings(
                    {{n: jax.ShapeDtypeStruct(sh, jnp.float32) for n, sh in b.items()}}).items()}}
                for k, b in {BATCHES!r}.items()}}
        # per-device param and moment bytes of the full-width DENSE trees
        def shard_bytes(tree, shardings):
            return sum(int(np.prod(sh.shard_shape(l.shape))) * l.dtype.itemsize for l, sh in zip(
                jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(shardings)))

        res["bytes"] = {{}}
        for d, m in {BYTES_MESHES!r}:
            mesh = make_mesh((d, m), ("data", "model"))
            for name in {BYTES_ARCHS!r}:
                b = build_model(get_arch(name), Mode.DENSE)
                specs = jax.eval_shape(b.init, jax.random.PRNGKey(0))
                ospecs = jax.eval_shape(AdamW().init, specs)
                for fsdp in (False, True):
                    r = ShardingRules(mesh, fsdp=fsdp)
                    osh = r.opt_shardings(ospecs)
                    res["bytes"][f"{{d}},{{m}},{{name}},{{fsdp}}"] = [
                        shard_bytes(specs, r.params_shardings(specs, b)),
                        shard_bytes(ospecs.m, osh.m) + shard_bytes(ospecs.v, osh.v)]
        print("SPECS=" + json.dumps(res))
        """), n_devices=8)
    line = next(ln for ln in out.splitlines() if ln.startswith("SPECS="))
    return json.loads(line[len("SPECS="):])


def _port_opt_specs(bundle, rules) -> dict:
    """{reference moment path: [the spec of each of its per-layer leaves]}
    from `opt_shardings` on the port's AdamW state of `bundle` (ParamSpec
    leaves: nothing is allocated)."""
    params = layer_specs(bundle)
    frozen = (lut_frozen_mask(params) if bundle.mode == Mode.LUT_TRAIN
              else tree_map_ref(lambda _p, _l: False, params))
    moments = tree_map_ref(lambda _p, s, fz: ParamSpec((0,), s.dtype) if fz else s,
                           params, frozen)
    state = AdamWState(step=ParamSpec((), torch.int32), m=moments, v=moments)
    out: dict = {}
    tree_map_ref(lambda p, _leaf, spec: out.setdefault(p, []).append(_js(spec)),
                 state, rules.opt_shardings(state))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_opt_and_fsdp_specs_match_the_reference(reference_specs, name, mesh):
    d, m = mesh
    rules, fsdp = ShardingRules(model=m, data=d), ShardingRules(model=m, data=d, fsdp=True)
    n_zero1 = 0
    for mode in MODES:
        want = reference_specs[f"{d},{m}"][name][mode]
        bundle = build_model(get_arch(name), Mode(mode))
        got = _port_opt_specs(bundle, rules)
        assert sorted(got) == sorted(want["opt"]), (mode, name)
        for path, specs in got.items():
            assert all(s == want["opt"][path] for s in specs), (mode, path, specs,
                                                                want["opt"][path])
            n_zero1 += "data" in want["opt"][path]
        roles = site_roles(bundle)
        for path, spec in flatten_tree(bundle.param_specs()).items():
            assert _js(fsdp.param_spec(path, spec.shape)) == want["fsdp"][path], (mode, path)
            assert _js(fsdp.param_spec(path, spec.shape, site_roles=roles)) \
                == want["fsdp_roles"][path], (mode, path)
    assert n_zero1 > 0, name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_batch_shardings_match_the_reference(reference_specs, mesh):
    d, m = mesh
    rules = ShardingRules(model=m, data=d)
    for kind, batch in BATCHES.items():
        got = rules.batch_shardings({k: torch.empty(0).new_empty(s) for k, s in batch.items()})
        assert {k: _js(s) for k, s in got.items()} == reference_specs[f"{d},{m}"]["batch"][kind]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

# the MoE and SSM families' steps against the same reference step: experts
# over both axes with the token all-to-all, and the SSD heads
FAMILY_STEPS = {"arctic_480b": dict(SHARDED, arch="arctic_480b"),
                "mamba2_370m": dict(SHARDED, arch="mamba2_370m", d_ff=0)}


@pytest.fixture(scope="module")
def reference_sharded_step(tmp_path_factory) -> dict:
    """The reference's init and its sharded step on the (2, 4) mesh
    (tests/test_sharded.py's setup): {"init": flat arrays, "params":
    flat arrays after one step, "loss", "fsdp": {"params", "loss"} of the
    same step under `ShardingRules(mesh, fsdp=True)`}, of SHARDED, and the
    same under "families" for each of FAMILY_STEPS (one subprocess)."""
    d = tmp_path_factory.mktemp("sharded")
    specs = {"sharded": SHARDED, **FAMILY_STEPS}
    run_with_devices(textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint.checkpointer import flatten_tree
        from repro.configs import build_model, get_arch, reduce_arch
        from repro.core.amm import Mode
        from repro.data import MarkovLM
        from repro.distributed.sharding import ShardingRules
        from repro.launch.mesh import make_mesh
        from repro.optim import AdamW
        from repro.train.train_step import make_train_step

        for name, s in {specs!r}.items():
            arch = reduce_arch(get_arch(s["arch"]), n_layers=s["layers"], vocab=s["vocab"],
                               d_model=s["d"], d_ff=s["d_ff"])
            data = MarkovLM(vocab=arch.vocab, seq_len=s["seq"], batch=s["batch"])
            bundle = build_model(arch, Mode.DENSE)
            params = bundle.init(jax.random.PRNGKey(0))
            opt = AdamW(lr=s["lr"], clip_norm=s["clip"])
            ostate = opt.init(params)
            batch = data.batch_at(0)
            step = make_train_step(bundle, opt, compute_dtype=jnp.float32)
            mesh = make_mesh((2, 4), ("data", "model"))
            for tag, fsdp in (("step", False), ("fsdp", True)):
                rules = ShardingRules(mesh, fsdp=fsdp)
                ps = rules.params_shardings(jax.eval_shape(lambda: params))
                os_ = rules.opt_shardings(jax.eval_shape(lambda: ostate))
                bs = rules.batch_shardings({{k: jax.eval_shape(lambda v=v: v)
                                            for k, v in batch.items()}})
                with mesh:
                    p_sh, _, m_sh = jax.jit(step, in_shardings=(ps, os_, bs),
                                            out_shardings=(ps, os_, None))(
                        jax.device_put(params, ps), jax.device_put(ostate, os_),
                        {{k: jax.device_put(v, bs[k]) for k, v in batch.items()}})
                np.savez(f"{d}/{{name}}_{{tag}}.npz", loss=np.float32(m_sh["loss"]),
                         **flatten_tree(p_sh))
            np.savez(f"{d}/{{name}}_init.npz", **flatten_tree(params))
        """), n_devices=8)

    def read(name: str) -> dict:
        out = {}
        for tag in ("step", "fsdp"):
            with np.load(d / f"{name}_{tag}.npz") as g:
                out[tag] = {"params": {k: g[k] for k in g.files if k != "loss"},
                            "loss": float(g["loss"])}
        with np.load(d / f"{name}_init.npz") as f:
            return {"init": dict(f), **out["step"], "fsdp": out["fsdp"]}

    return {**read("sharded"), "families": {n: read(n) for n in FAMILY_STEPS}}


def _as_tree(flat: dict, like) -> dict:
    return tree_from_reference(like, flat, device="cpu")


def test_dp2_step_matches_the_reference_sharded_step(reference_sharded_step):
    ref = reference_sharded_step
    ranks = run_ranks(dp_train, 2, SHARDED, ref["init"], 1, axis="data")
    for r in ranks:
        assert abs(r["loss"][0] - ref["loss"]) < REF_LOSS_TOL
        for path, want in ref["params"].items():
            np.testing.assert_allclose(r["params"][path], want, rtol=REF_RTOL, atol=REF_ATOL,
                                       err_msg=path)


@pytest.fixture(scope="module")
def tp22_ranks(reference_sharded_step) -> dict:
    """One spawn of the (2, 2) mesh's 4 ranks: the port's DENSE step
    (`tests/_tp_ranks.tp_train`) from the reference's init of SHARDED and of
    each of FAMILY_STEPS, with ZeRO-1 and with FSDP: {(name, fsdp): [each
    rank's result]}."""
    ref = reference_sharded_step
    inits = {"sharded": ref["init"], **{n: f["init"] for n, f in ref["families"].items()}}
    specs = {"sharded": SHARDED, **FAMILY_STEPS}
    keys = [(name, fsdp) for fsdp in (False, True) for name in specs]
    jobs = [("tp_train", (dict(specs[name], fsdp=fsdp), inits[name], 1)) for name, fsdp in keys]
    out = run_ranks(tp_jobs, 4, jobs, axis=(2, 2), timeout=600)
    return {key: [r[i] for r in out] for i, key in enumerate(keys)}


def test_tp22_step_matches_the_reference_sharded_step(reference_sharded_step, tp22_ranks):
    """The port's (data, model) = (2, 2) DENSE step (tensor-parallel shards,
    ZeRO-1 inside them, `tests/_tp_ranks.tp_train`) from the reference's
    init, against the reference's (2, 4) sharded step within its bound."""
    ref = reference_sharded_step
    for r in tp22_ranks[("sharded", False)]:
        assert abs(r["loss"][0] - ref["loss"]) < REF_LOSS_TOL
        for path, want in ref["params"].items():
            np.testing.assert_allclose(r["arrays"][f"params/{path}"], want, rtol=REF_RTOL,
                                       atol=REF_ATOL, err_msg=path)


def test_tp22_family_steps_match_the_reference_sharded_step(reference_sharded_step,
                                                           tp22_ranks):
    """The port's (2, 2) DENSE step of reduced arctic_480b (its experts over
    both axes, tokens by the data all-to-all) and reduced mamba2_370m (its
    SSD heads) from the reference's init, against the reference's (2, 4)
    sharded step (the specs' placement: E over "data", each expert's M and
    in_proj's columns over "model") within its bound."""
    fams = reference_sharded_step["families"]
    for name in FAMILY_STEPS:
        for r in tp22_ranks[(name, False)]:
            ref = fams[name]
            assert abs(r["loss"][0] - ref["loss"]) < REF_LOSS_TOL, name
            assert {p for p in r["arrays"] if p.startswith("params/")} == \
                {f"params/{p}" for p in ref["params"]}, name
            for path, want in ref["params"].items():
                np.testing.assert_allclose(r["arrays"][f"params/{path}"], want, rtol=REF_RTOL,
                                           atol=REF_ATOL, err_msg=f"{name} {path}")
            if name == "arctic_480b":
                assert r["axis_counters"]["data"]["all_to_all"] > 0


def test_dp2_moe_step_matches_the_single_rank_step():
    """An MoE step at dp 2 (reduced arctic_480b, top-2 with capacity drops):
    the load-balance fractions are the data axis' means, the global
    batch's, so the loss is the single-rank step's within
    SINGLE_LOSS_RTOL and the params after it within the leaf rule (each
    rank's own fractions put the loss 4.6e-5 off)."""
    spec = dict(FAMILY_STEPS["arctic_480b"], clip=1.0)
    ranks = run_ranks(dp_train, 2, spec, None, 1, axis="data")
    losses, states, rule, params = dp_single(spec, None, 1)
    _, _, opt, frozen = dp_model(spec)
    want = _as_tree(states[0], {"params": params, "opt": opt.init(params, frozen)})["params"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        worst, where = rule.check(_as_tree(r["params_1"], params), want, params)
        assert worst <= 1.0, (worst, where)


# the leaf rule holds the first step: from the second on, each fp32 run's
# rounding moves the next step's forward, so the last step of the dense case
# is held by the float64 witness. LUT_TRAIN takes one step: the witness's
# ratio of two rounding errors is noise at a scalar leaf (log_t)
@pytest.mark.parametrize("case,steps", [(dict(SHARDED, clip=1.0), 3),
                                        (dict(SHARDED, arch="qwen3_1p7b", mode="lut_train",
                                              accum=2, wd=0.01), 1)],
                         ids=["dense", "lut_train_accum2"])
def test_dp2_steps_match_the_single_rank_step(case, steps):
    ranks = run_ranks(dp_train, 2, case, None, steps, axis="data")
    losses, states, rule, params = dp_single(case, None, steps)
    bundle, _, opt, frozen = dp_model(case)
    like = {"params": params, "opt": opt.init(params, frozen)}
    single = _as_tree(states[-1], like)
    if steps > 1:
        _, exact, _, _ = dp_single(case, None, steps, float64=True)
        witness = _as_tree(exact[-1], {"params": tree_map_ref(lambda _p, t: t.double(), params),
                                       "opt": opt.init(params, frozen)})
    for r in ranks:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        assert sorted(r["arrays"]) == sorted(states[-1])
        # after one step the leaf rule; after the last, the float64 witness
        worst, where = rule.check(_as_tree(r["params_1"], params),
                                  _as_tree(states[0], like)["params"], params)
        assert worst <= 1.0, (worst, where)
        got = _as_tree(r["arrays"], like)
        for key, start in (("params", params), ("opt", None)) if steps > 1 else ():
            ratio, where = witness_ratio(got[key], single[key], witness[key], start)
            assert ratio <= WITNESS, (key, ratio, where)
        for path, a in states[-1].items():        # frozen leaves: bit for bit
            if path.startswith("opt/") and a.shape == (0,):
                assert r["arrays"][path].shape == (0,)
        assert int(r["arrays"]["opt/.step"]) == steps
    for path, a in ranks[0]["params"].items():      # both ranks hold the same params
        np.testing.assert_array_equal(a, ranks[1]["params"][path], err_msg=path)
    # each rank holds its ZeRO-1 shard of every moment, by opt_spec's data dim
    rules = ShardingRules(data=2)
    specs = flatten_tree(bundle.param_specs())
    frozen_paths = {p for p, leaves in reference_leaves(frozen or {}).items() if leaves[0]}
    n_cut = 0
    for p, shapes in ranks[0]["shards"].items():
        path = p
        full = tuple(specs[p].shape)
        spec = rules.opt_spec(p, full)
        stacked = len(shapes) > 1 or p.startswith("segments/")
        if p in frozen_paths:
            assert all(s == (0,) for s in shapes), path
        elif "data" not in spec:
            assert shapes == [full[1:]] * len(shapes) if stacked else shapes == [full], path
        elif stacked and spec.index("data") == 0:      # whole layers per rank
            assert shapes == [full[1:], (0,)] and ranks[1]["shards"][path] == [(0,), full[1:]]
            n_cut += 1
        else:
            dim = spec.index("data")
            half = list(full)
            half[dim] //= 2
            assert shapes == [tuple(half[1:])] * len(shapes) if stacked else \
                shapes == [tuple(half)], path
            n_cut += 1
    assert n_cut > 0
    c = ranks[0]["counters"]
    assert c["all_mean"] == 2 * steps and c["all_gather"] + c["broadcast"] > 0


# ---------------------------------------------------------------------------
# FSDP: weights and tables over "data" too
# ---------------------------------------------------------------------------

# the single-rank holds of test_dp2_steps_match_the_single_rank_step, under FSDP
FSDP_DP_CASES = {"dense": (dict(SHARDED, clip=1.0, fsdp=True), 3),
                 "lut_train_accum2": (dict(SHARDED, arch="qwen3_1p7b", mode="lut_train",
                                           accum=2, wd=0.01, fsdp=True), 1)}


# one FSDP DENSE step of the MoE (its experts split over "data" by the spec,
# gathered per block), SSM and hybrid families on a data mesh
FSDP_DP_FAMILIES = {"arctic_480b": dict(SHARDED, arch="arctic_480b", clip=1.0, accum=2),
                    "mamba2_370m": dict(SHARDED, arch="mamba2_370m", d_ff=0, clip=1.0),
                    "zamba2_1p2b": dict(SHARDED, arch="zamba2_1p2b", layers=4, clip=1.0)}


@pytest.fixture(scope="module")
def fsdp_dp2_ranks(reference_sharded_step) -> dict:
    """One spawn of 2 data ranks on the CPU under `ShardingRules(fsdp=True)`:
    the step from the reference's init of SHARDED, the FSDP_DP_CASES, one
    step of each of FSDP_DP_FAMILIES, and the collectives' checks
    (`tests/_tp_ranks.fsdp_collectives`)."""
    jobs = [("tp_train", (dict(SHARDED, fsdp=True), reference_sharded_step["init"], 1))]
    jobs += [("tp_train", (spec, None, steps)) for spec, steps in FSDP_DP_CASES.values()]
    jobs += [("tp_train", (dict(spec, fsdp=True), None, 1)) for spec in FSDP_DP_FAMILIES.values()]
    jobs += [("fsdp_collectives", (7,))]
    out = run_ranks(tp_jobs, 2, jobs, axis="data")
    keys = ["reference", *FSDP_DP_CASES, *FSDP_DP_FAMILIES, "collectives"]
    return {key: [r[i] for r in out] for i, key in enumerate(keys)}


@pytest.mark.parametrize("case", ["dp2-llama3_8b", "tp22-llama3_8b", "tp22-arctic_480b",
                                  "tp22-mamba2_370m"])
def test_fsdp_steps_match_the_reference_fsdp_step(reference_sharded_step, request, case):
    """The port's FSDP DENSE step at dp 2 and at (2, 2) (each rank its data
    part of every leaf `param_spec(fsdp=True)` splits over "data" too, the
    forward gathering them per block), from the reference's init, against
    the reference's (2, 4) GSPMD step under `ShardingRules(mesh, fsdp=True)`
    within its bound; the whole params after it, gathered."""
    mesh, name = case.split("-")
    if mesh == "dp2":
        ref, ranks = reference_sharded_step, request.getfixturevalue("fsdp_dp2_ranks")["reference"]
    else:
        ref = (reference_sharded_step if name == "llama3_8b"
               else reference_sharded_step["families"][name])
        ranks = request.getfixturevalue("tp22_ranks")[("sharded" if name == "llama3_8b"
                                                       else name, True)]
    want = ref["fsdp"]
    for r in ranks:
        assert abs(r["loss"][0] - want["loss"]) < REF_LOSS_TOL, (case, r["loss"], want["loss"])
        assert {p for p in r["arrays"] if p.startswith("params/")} == \
            {f"params/{p}" for p in want["params"]}
        for path, w in want["params"].items():
            np.testing.assert_allclose(r["arrays"][f"params/{path}"], w, rtol=REF_RTOL,
                                       atol=REF_ATOL, err_msg=f"{case} {path}")
        c = r["axis_counters"]["data"]
        assert c["all_gather"] > 0 and c["reduce_scatter"] > 0, c
        # no param all-gather after the update: a step gathers what its
        # gradient fn alone gathers
        assert r["step_gathers"] == [r["grad_counters"]["data"]["all_gather"]] * len(r["loss"])


@pytest.mark.parametrize("case", list(FSDP_DP_CASES))
def test_fsdp_dp2_steps_match_the_single_rank_step(fsdp_dp2_ranks, case):
    """Three DENSE steps, or one LUT_TRAIN step with grad_accum 2, at dp 2
    under FSDP against the port's single-rank step: the losses, the first
    step by the leaf rule, the last DENSE step by the float64 witness, frozen
    leaves' moments empty; each rank's params and moments its
    `param_spec(fsdp=True)` / `opt_spec` part (`testing.expected_rank_shapes`),
    the leaves the spec keeps whole bytewise equal on both ranks; the
    gradients before the update (gathered) against the single rank's."""
    from repro_torch.distributed.tensor_parallel import layout as tp_layout
    from repro_torch.testing import GRAD_L2, GRAD_MAX, _rel, expected_rank_shapes
    from tests._tp_ranks import tp_single_grads

    spec, steps = FSDP_DP_CASES[case]
    ranks = fsdp_dp2_ranks[case]
    losses, states, rule, params = dp_single(spec, None, steps)
    bundle, _, opt, frozen = dp_model(spec)
    like = {"params": params, "opt": opt.init(params, frozen)}
    single = _as_tree(states[-1], like)
    if steps > 1:
        _, exact, _, _ = dp_single(spec, None, steps, float64=True)
        witness = _as_tree(exact[-1], {"params": tree_map_ref(lambda _p, t: t.double(), params),
                                       "opt": opt.init(params, frozen)})
    rules = ShardingRules(data=2, fsdp=True)
    lay = tp_layout(bundle, rules, train=True)
    assert lay.fsdp and not lay.roles and not lay.cuts
    frozen_paths = {p for p, leaves in reference_leaves(frozen or {}).items() if leaves[0]}
    grads = tp_single_grads(spec)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        assert sorted(r["arrays"]) == sorted(states[-1])
        worst, where = rule.check(_as_tree(r["params_1"], params),
                                  _as_tree(states[0], like)["params"], params)
        assert worst <= 1.0, (worst, where)
        got = _as_tree(r["arrays"], like)
        for key, start in (("params", params), ("opt", None)) if steps > 1 else ():
            ratio, where = witness_ratio(got[key], single[key], witness[key], start)
            assert ratio <= WITNESS, (key, ratio, where)
        for path, a in states[-1].items():
            if path.startswith("opt/") and a.shape == (0,):
                assert r["arrays"][path].shape == (0,)
        assert int(r["arrays"]["opt/.step"]) == steps
        want_p, want_m = expected_rank_shapes(bundle, rules, r["rank"][0], frozen_paths)
        assert r["param_shapes"] == want_p and r["moment_shapes"] == want_m
        for path, want in grads["grads"].items():
            l2, mx = _rel(torch.as_tensor(r["grads"][path]), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (path, l2, mx)
        assert r["step_gathers"] == [r["grad_counters"]["data"]["all_gather"]] * steps
    n_split = 0
    for path, a in ranks[0]["local"].items():
        if path in lay.fsdp:
            n_split += 1
        else:                                    # kept whole over "data": one value
            np.testing.assert_array_equal(a, ranks[1]["local"][path], err_msg=path)
    assert n_split > 0 and (case == "dense" or frozen_paths & set(lay.fsdp))


@pytest.mark.parametrize("family", list(FSDP_DP_FAMILIES))
def test_fsdp_dp2_family_steps_match_the_single_rank_step(fsdp_dp2_ranks, family):
    """One FSDP DENSE step at dp 2 of reduced arctic_480b (grad_accum 2; its
    expert stacks split over "data" by the spec and gathered per block, the
    router and attention too), mamba2_370m and zamba2_1p2b (its shared
    block gathered once per forward): the loss, the params after it by the
    leaf rule, the gradients before it against the single rank's; each
    rank's parts by `param_spec(fsdp=True)`."""
    from repro_torch.testing import GRAD_L2, GRAD_MAX, _rel, expected_rank_shapes
    from tests._tp_ranks import tp_single_grads

    spec = dict(FSDP_DP_FAMILIES[family], fsdp=True)
    losses, states, rule, params = dp_single(spec, None, 1)
    bundle, _, opt, frozen = dp_model(spec)
    want_1 = _as_tree(states[0], {"params": params, "opt": opt.init(params, frozen)})["params"]
    grads = tp_single_grads(spec)
    rules = ShardingRules(data=2, fsdp=True)
    for r in fsdp_dp2_ranks[family]:
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        worst, where = rule.check(_as_tree(r["params_1"], params), want_1, params)
        assert worst <= 1.0, (r["rank"], worst, where)
        for path, want in grads["grads"].items():
            l2, mx = _rel(torch.as_tensor(r["grads"][path]), torch.as_tensor(want))
            assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (path, l2, mx)
        want_p, want_m = expected_rank_shapes(bundle, rules, r["rank"][0])
        assert r["param_shapes"] == want_p and r["moment_shapes"] == want_m
        assert r["axis_counters"]["data"]["reduce_scatter"] > 0


def test_reduce_scatter_and_the_data_gather_gradient(fsdp_dp2_ranks):
    """`HostMesh.reduce_scatter` along dims 0 and 1, natively (gloo on the
    CPU) and through the all-reduce-and-slice that a CUDA tensor under gloo
    takes, equals the sum then the rank's slice (integer values: exact)
    and holds no storage beyond its own part (no view of the whole sum);
    the data gather's forward is the whole leaf, and its gradient the data
    ranks' mean of the whole leaf's gradient, sliced (float64)."""
    for r in fsdp_dp2_ranks["collectives"]:
        for (native, emulated), want in zip(r["rs"], r["want"]):
            np.testing.assert_array_equal(native, want)
            np.testing.assert_array_equal(emulated, want)
        assert all(own for pair in r["rs_own"] for own in pair), r["rs_own"]
        for g in r["gather"]:
            assert g["forward_equal"]
            np.testing.assert_allclose(g["grad"], g["want"], rtol=1e-12, atol=1e-12)


def _port_rank_bytes(name: str, data: int, model: int, fsdp: bool, rank: int) -> list[int]:
    """[param bytes, moment bytes (m and v)] a rank of the port holds for the
    full-width DENSE model: its plan built on meta tensors (nothing
    allocated), `place` and `Zero1` as a step builds them."""
    from repro_torch.distributed.data_parallel import Zero1
    from repro_torch.distributed.tensor_parallel import place
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.optim import AdamW

    bundle = build_model(get_arch(name), Mode.DENSE)
    params = tree_map_ref(lambda _p, s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                          layer_specs(bundle))
    mesh = HostMesh(data=data, model=model, rank=rank, device=torch.device("meta"),
                    backend="gloo")
    rules = ShardingRules(data=data, model=model, fsdp=fsdp)
    lp, lay = params, None
    if fsdp or model > 1:
        _, lp, lay = place(bundle, params, rules, mesh, train=True)
    layout = Zero1.build(mesh, lp, None, rules, tp=lay)
    state = layout.init_state(AdamW(), lp)

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for ls in reference_leaves(tree).values()
                   for t in ls)

    return [nbytes(lp), nbytes(state.m) + nbytes(state.v)]


@pytest.mark.parametrize("mesh", BYTES_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", BYTES_ARCHS)
def test_fsdp_and_zero1_per_rank_bytes_match_the_reference(reference_specs, name, mesh):
    """Every rank's param and moment bytes of the full-width DENSE model as
    the port holds them (the cut it really takes, on meta tensors), under
    ZeRO-1 and under FSDP, equal the reference's per-device
    `NamedSharding.shard_shape` sums; FSDP holds fewer param bytes (its
    moments about as many: the norms' are whole under FSDP, cut under
    ZeRO-1)."""
    d, m = mesh
    got = {}
    for fsdp in (False, True):
        want = reference_specs["bytes"][f"{d},{m},{name},{fsdp}"]
        for rank in range(d * m):
            got[fsdp] = _port_rank_bytes(name, d, m, fsdp, rank)
            assert got[fsdp] == want, (name, mesh, fsdp, rank, got[fsdp], want)
    assert got[True][0] < got[False][0]


EXPERT_STACKS = ("moe/gate/w", "moe/up/w", "moe/down/w")


def _echo_mesh(data: int):
    """A rank of a data mesh whose peers hold what it holds: each collective
    answers at its shapes without a process group (a gather stacks `data`
    copies, a reduce-scatter keeps the first part), enough to run the
    FSDP forward and backward of one rank in this process."""
    from repro_torch.launch.mesh import HostMesh

    class EchoMesh(HostMesh):
        def all_gather(self, t, axis=None):
            return torch.stack([t] * self.size(axis))

        def reduce_scatter(self, t, dim, axis=None):
            dim = dim % t.dim()
            return t.narrow(dim, 0, t.shape[dim] // self.size(axis)).clone()

        def all_to_all(self, t, axis=None):
            return t.clone()

        def all_reduce(self, t, axis=None):
            return t

        all_mean = all_max = all_reduce

    return EchoMesh(data=data, model=1, rank=0, device=torch.device("cpu"), backend="gloo")


# the hybrid's mamba stack always recomputes its blocks in training
FREED_CASES = [(f, True) for f in ("llama3_8b", *FSDP_DP_FAMILIES)] + [
    (f, False) for f in ("llama3_8b", "arctic_480b", "mamba2_370m")]


@pytest.mark.parametrize("family,remat", FREED_CASES,
                         ids=[f"{f}-{'remat' if r else 'no_remat'}" for f, r in FREED_CASES])
def test_fsdp_block_gathers_are_freed_after_the_block(family, remat):
    """FSDP's saving holds through the backward: a block's weights gathered
    over "data" inside its recomputed function are freed when the block's
    forward returns (their storage gone while the loss's graph is alive),
    and the recomputation gathers them again. Without recomputation the
    same gathers are kept to the backward, which the check tells apart.
    (The embedding, an untied head and the hybrid's shared block are
    gathered once per forward, outside the blocks.)"""
    import gc
    import sys

    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.distributed.tensor_parallel import place
    from repro_torch.models import sharded

    spec = dict(FSDP_DP_FAMILIES.get(family, SHARDED), fsdp=True)
    bundle, params, _, _ = dp_model(spec)
    mesh = _echo_mesh(2)
    local, lp, lay = place(bundle, params, ShardingRules(data=2, fsdp=True), mesh, train=True)
    if not remat:
        local = dataclasses.replace(local, cfg=dataclasses.replace(local.cfg, remat=False))
    tree_map_ref(lambda _p, t: t.requires_grad_(), lp)
    blocks: list = []          # (path, weak reference to its gathered storage) of each block
    orig = sharded.gather_data

    def recording(p, dims, m=None):
        out = orig(p, dims, m)
        if sys._getframe(1).f_code.co_name in ("_train_block_on", "_seg_apply"):
            blocks.extend((path, StorageWeakRef(t.untyped_storage()))
                          for path, ts in reference_leaves(out).items() if path in dims
                          for t in ts)
        return out

    sharded.gather_data = recording
    try:
        with sharded.bound(mesh):
            loss = local.loss(lp, dp_batch(spec, 0), compute_dtype=torch.float32)
            gc.collect()
            in_forward = len(blocks)
            alive = [path for path, ref in blocks if not ref.expired()]
            loss.backward()
    finally:
        sharded.gather_data = orig
    assert lay.fsdp and in_forward > 0
    if remat:
        assert not alive, alive
        assert len(blocks) == 2 * in_forward        # the recomputation gathered again
    else:
        # every one kept but the expert stacks, which the backward reads
        # through the copy of the routed experts (`moe.expert_linear`)
        assert len(blocks) == in_forward
        assert set(alive) == {p for p, _ in blocks if p not in EXPERT_STACKS}
