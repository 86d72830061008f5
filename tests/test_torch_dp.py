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
rescale and the Trainer's rank-0 commits: tests/test_torch_elastic.py."""

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
from tests._tp_ranks import dp_model, dp_single, dp_train, run_ranks, tp_jobs

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


def _js(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference_specs() -> dict:
    """{"d,m": {arch: {mode: {"opt", "fsdp", "fsdp_roles"}}, "batch": ...}} from
    the reference's rules on a (data, model) host mesh."""
    out = run_with_devices(textwrap.dedent(f"""
        import json
        import jax, jax.numpy as jnp
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
    flat arrays after one step, "loss"}, of SHARDED, and the same under
    "families" for each of FAMILY_STEPS (one subprocess)."""
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
            rules = ShardingRules(mesh)
            ps = rules.params_shardings(jax.eval_shape(lambda: params))
            os_ = rules.opt_shardings(jax.eval_shape(lambda: ostate))
            bs = rules.batch_shardings({{k: jax.eval_shape(lambda v=v: v)
                                        for k, v in batch.items()}})
            with mesh:
                p_sh, _, m_sh = jax.jit(step, in_shardings=(ps, os_, bs),
                                        out_shardings=(ps, os_, None))(
                    jax.device_put(params, ps), jax.device_put(ostate, os_),
                    {{k: jax.device_put(v, bs[k]) for k, v in batch.items()}})
            np.savez(f"{d}/{{name}}_init.npz", **flatten_tree(params))
            np.savez(f"{d}/{{name}}_step.npz", loss=np.float32(m_sh["loss"]),
                     **flatten_tree(p_sh))
        """), n_devices=8)

    def read(name: str) -> dict:
        with np.load(d / f"{name}_init.npz") as f, np.load(d / f"{name}_step.npz") as g:
            return {"init": dict(f), "params": {k: g[k] for k in g.files if k != "loss"},
                    "loss": float(g["loss"])}

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


def test_tp22_step_matches_the_reference_sharded_step(reference_sharded_step):
    """The port's (data, model) = (2, 2) DENSE step (tensor-parallel shards,
    ZeRO-1 inside them, `tests/_tp_ranks.tp_train`) from the reference's
    init, against the reference's (2, 4) sharded step within its bound."""
    ref = reference_sharded_step
    ranks = run_ranks(tp_jobs, 4, [("tp_train", (SHARDED, ref["init"], 1))], axis=(2, 2))
    for (r,) in ranks:
        assert abs(r["loss"][0] - ref["loss"]) < REF_LOSS_TOL
        for path, want in ref["params"].items():
            np.testing.assert_allclose(r["arrays"][f"params/{path}"], want, rtol=REF_RTOL,
                                       atol=REF_ATOL, err_msg=path)


def test_tp22_family_steps_match_the_reference_sharded_step(reference_sharded_step):
    """The port's (2, 2) DENSE step of reduced arctic_480b (its experts over
    both axes, tokens by the data all-to-all) and reduced mamba2_370m (its
    SSD heads) from the reference's init, against the reference's (2, 4)
    sharded step (the specs' placement: E over "data", each expert's M and
    in_proj's columns over "model") within its bound."""
    fams = reference_sharded_step["families"]
    jobs = [("tp_train", (spec, fams[name]["init"], 1)) for name, spec in FAMILY_STEPS.items()]
    ranks = run_ranks(tp_jobs, 4, jobs, axis=(2, 2))
    for got in ranks:
        for (name, spec), r in zip(FAMILY_STEPS.items(), got):
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
