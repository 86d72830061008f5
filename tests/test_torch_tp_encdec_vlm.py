"""Tensor-parallel serving and training of the enc-dec and vision-LM
families: whisper_tiny (its encoder, the decoder's self and cross
attention, the per-row cross K/V) and qwen2_vl_7b (embedding inputs,
M-RoPE positions, an untied head) on a ("data", "model") mesh.

One spawn of 4 gloo ranks on the CPU at (data, model) = (2, 2) does all the
rank work of this module (`tests/_tp_ranks.py`), at reduced width (2 + 2
layers, 8 frames, the M-RoPE sections kept): whisper_tiny at vocab 512,
which the spec splits, and at 511, which it does not (the embedding whole
on every rank, "embed_whole"), and qwen2_vl_7b. While the ranks run, one
subprocess runs the reference under 8 forced host devices from the same
params (the port's init, written in the reference's layout): its
unsharded serve step (jitted) and its sharded `make_serve_step` on a (2, 4)
mesh, and its (2, 4) GSPMD train step. Held here:

  * serving at tp 2 (each data row of the mesh serves alone): a prefill
    with frames or embeddings, then greedy decode steps, on dense and paged
    self caches, every forward's logits within LOGIT_ATOL of the unsharded
    port's, the tokens the reference's unsharded and sharded serve steps';
    `make_serve_step(mesh=)` bytewise `forward_step(mesh=)`; each
    row-parallel LUT site call (m-shared scales: exact int32 accumulators
    reduced) bytewise the unsharded site's on the gathered input and tables;
  * training at (2, 2), a DENSE step under ZeRO-1 and under FSDP and a
    LUT_TRAIN step: the loss within SINGLE_LOSS_RTOL of the single rank's,
    the params after it by the leaf rule (`testing.AdamLeafRule`; a log_t
    by AdamW of its own gradient), every gradient gathered whole against
    the single rank's (the encoder's among them: without the `copy` in
    front of the cross-attention's k and v, each rank's gradient into the
    encoder's output is its own heads' part only), each rank's shapes;
    the FSDP step bytewise the ZeRO-1 step; the DENSE step against the
    reference's (2, 4) GSPMD step within that test's bound;
  * each rank's param shapes at full published width (meta tensors) against
    the reference's shard shapes but for `Layout.kept`'s differences, when
    serving at tp 2 and 4 and training at (2, 2) and (2, 4), FSDP off and on.
"""

import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.sharding import ShardingRules, site_roles
from repro_torch.launch.mesh import HostMesh
from repro_torch.serving.engine import ServingEngine
from repro_torch.testing import (GRAD_L2, GRAD_MAX, _rel, expected_rank_shapes,
                                 kept_rank_shape, lut_train_grads, spec_part_shape)
from repro_torch.weights import is_stacked, reference_arrays, reference_leaves, \
    tree_from_reference, tree_map_ref
from tests._subproc import run_with_devices
from tests._tp_ranks import (SERVE_B, SERVE_MAX, collect, dp_batch, dp_model, dp_single,
                             greedy_serve, serve_inputs, serve_model, start_ranks, tp_jobs,
                             tp_single_grads)

BASE = dict(layers=2, d=64, d_ff=128, lr=1e-2, batch=8, seq=16, seed=0)
VARIANTS = {"whisper": dict(BASE, arch="whisper_tiny", vocab=512),
            "whisper_odd": dict(BASE, arch="whisper_tiny", vocab=511),
            "vlm": dict(BASE, arch="qwen2_vl_7b", vocab=512)}
MODES = ("dense", "lut_train")
MESH = (2, 2)
STEPS = 4                   # greedy decode steps after the prefill
LOGIT_ATOL = 1e-4           # a tensor-parallel forward's logits against the unsharded port's
SINGLE_LOSS_RTOL = 1e-5     # the mean of the data ranks' losses against the batch's
NORM_RTOL = 1e-6
LOG_T_TERMS = 1e-6          # a log_t gradient against its terms' magnitudes
# the reference's sharded step test's bound (tests/test_sharded.py)
REF_LOSS_TOL, REF_RTOL, REF_ATOL = 1e-4, 1e-2, 1e-3

# run with `d, specs, steps, b, s_max` assigned in front (the `runs` fixture)
REFERENCE = textwrap.dedent("""
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.checkpointer import flatten_tree, tree_paths
    from repro.configs import build_model, get_arch, reduce_arch
    from repro.core.amm import Mode
    from repro.distributed.sharding import ShardingRules
    from repro.launch.mesh import make_mesh
    from repro.optim import AdamW
    from repro.train.train_step import make_serve_step, make_train_step

    mesh = make_mesh((2, 4), ("data", "model"))
    rules = ShardingRules(mesh)

    def load(bundle, path):
        like = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
        with np.load(path) as f:
            leaves = [jnp.asarray(f[p]) for p in tree_paths(like)]
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)

    for name, s in specs.items():
        arch = reduce_arch(get_arch(s["arch"]), n_layers=s["layers"], vocab=s["vocab"],
                           d_model=s["d"], d_ff=s["d_ff"])
        inp = dict(np.load(f"{d}/{name}_inputs.npz"))
        binf = build_model(dataclasses.replace(arch, lut_use_kernel=True), Mode.LUT_INFER)
        jp = load(binf, f"{d}/{name}_serve.npz")
        table = np.asarray(jp["embed"]["table"])
        ps = rules.params_shardings(jax.eval_shape(lambda: jp), bundle=binf)
        fns, out = {}, {}
        for tag in ("plain", "sharded"):
            caches = binf.init_caches(b, s_max, dtype=jnp.float32)
            params = jp
            if tag == "sharded":
                cs = rules.cache_shardings(jax.eval_shape(lambda: caches), b)
                params, caches = jax.device_put(jp, ps), jax.device_put(caches, cs)
                step = make_serve_step(binf, compute_dtype=jnp.float32)
            batch = {"cache_len": jnp.zeros((b,), jnp.int32)}
            if "embeds" in inp:
                batch["embeds"] = jnp.asarray(inp["embeds"])
            else:
                batch.update(tokens=jnp.asarray(inp["prompt"]), frames=jnp.asarray(inp["frames"]))
            toks, cl = [], np.zeros((b,), np.int32)
            for _ in range(1 + steps):
                key = (tag, tuple(sorted((k, v.shape) for k, v in batch.items())))
                if tag == "plain":
                    if key not in fns:
                        fns[key] = jax.jit(lambda p, bt, c: binf.forward_step(
                            p, bt, c, compute_dtype=jnp.float32))
                    logits, caches = fns[key](params, batch, caches)
                else:
                    if key not in fns:
                        bs = rules.batch_shardings({k: jax.eval_shape(lambda v=v: v)
                                                    for k, v in batch.items()})
                        fns[key] = (jax.jit(step, in_shardings=(ps, bs, cs),
                                            out_shardings=(None, cs)), bs)
                    fn, bs = fns[key]
                    with mesh:
                        logits, caches = fn(params, {k: jax.device_put(v, bs[k])
                                                     for k, v in batch.items()}, caches)
                nxt = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)
                toks.append(nxt)
                cl = cl + logits.shape[1]
                batch = {"cache_len": jnp.asarray(cl)}
                if "embeds" in inp:
                    batch["embeds"] = jnp.asarray(table[nxt][:, None])
                else:
                    batch["tokens"] = jnp.asarray(nxt[:, None])
            out[tag] = np.stack(toks, 1)
        bd = build_model(arch, Mode.DENSE)
        jp = load(bd, f"{d}/{name}_train.npz")
        opt = AdamW(lr=s["lr"], clip_norm=s["clip"])
        ostate = opt.init(jp)
        batch = {k[len("train_"):]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith("train_")}
        tps = rules.params_shardings(jax.eval_shape(lambda: jp))
        os_ = rules.opt_shardings(jax.eval_shape(lambda: ostate))
        bs = rules.batch_shardings({k: jax.eval_shape(lambda v=v: v) for k, v in batch.items()})
        with mesh:
            p_sh, _, m_sh = jax.jit(make_train_step(bd, opt, compute_dtype=jnp.float32),
                                    in_shardings=(tps, os_, bs), out_shardings=(tps, os_, None))(
                jax.device_put(jp, tps), jax.device_put(ostate, os_),
                {k: jax.device_put(v, bs[k]) for k, v in batch.items()})
        np.savez(f"{d}/{name}_out.npz", loss=np.float32(m_sh["loss"]), **out,
                 **{f"params/{k}": v for k, v in flatten_tree(p_sh).items()})
    """)


def train_spec(name: str, mode: str, fsdp: bool = False) -> dict:
    if mode == "dense":
        return dict(VARIANTS[name], mode="dense", clip=1.0, fsdp=fsdp)
    return dict(VARIANTS[name], mode="lut_train", clip=None, wd=0.01, fsdp=fsdp)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the models are small, and
    the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The ranks' results {(job, variant, mode): [each rank's]} and the
    reference's {variant: {"plain", "sharded" tokens, "loss", "params/...":
    after its (2, 4) DENSE step}}, the two run side by side."""
    d = tmp_path_factory.mktemp("tp_encdec_vlm")
    jobs, keys = [], []
    for name, spec in VARIANTS.items():
        jobs.append(("tp_serve_family", (spec, STEPS)))
        keys.append(("serve", name, "lut_infer"))
        for mode, fsdp in (("dense", False), ("dense", True), ("lut_train", False)):
            jobs.append(("tp_train", (train_spec(name, mode, fsdp), None, 1)))
            keys.append(("fsdp" if fsdp else "train", name, mode))
        bundle, params = serve_model(spec)
        np.savez(d / f"{name}_serve.npz", **reference_arrays(params))
        np.savez(d / f"{name}_train.npz",
                 **reference_arrays(dp_model(train_spec(name, "dense"))[1]))
        np.savez(d / f"{name}_inputs.npz", **serve_inputs(spec),
                 **{f"train_{k}": v.numpy() for k, v in dp_batch(spec, 0).items()})
    handle = start_ranks(tp_jobs, 4, jobs, axis=MESH)
    try:
        specs = {n: train_spec(n, "dense") for n in VARIANTS}
        run_with_devices(f"d, specs, steps, b, s_max = {str(d)!r}, {specs!r}, {STEPS}, "
                         f"{SERVE_B}, {SERVE_MAX}\n" + REFERENCE, n_devices=8)
    finally:
        out = collect(handle, timeout=600)
    ref = {}
    for name in VARIANTS:
        with np.load(d / f"{name}_out.npz") as f:
            ref[name] = dict(f)
    return {"by": {k: [r[i] for r in out] for i, k in enumerate(keys)}, "ref": ref}


# ---------------------------------------------------------------------------
# the layouts, at full published width
# ---------------------------------------------------------------------------

def test_the_families_are_admitted_with_their_kept_differences():
    """`tp_refusal` admits whisper_tiny and qwen2_vl_7b, DENSE and LUT_INFER
    to serve, DENSE and LUT_TRAIN to train, and refuses the other mode with
    its reason; the layouts name the kept differences: whisper's cross K/V
    by heads, its embedding whole (vocab 51865 is odd), its attention whole
    at tp 4 (6 heads); the engine still refuses both families on a mesh,
    with its own reason."""
    for name in ("whisper_tiny", "qwen2_vl_7b"):
        for mode in (Mode.DENSE, Mode.LUT_INFER, Mode.LUT_TRAIN):
            b = build_model(get_arch(name), mode)
            assert (tensor_parallel.tp_refusal(b) is None) == (mode != Mode.LUT_TRAIN), name
            assert (tensor_parallel.tp_refusal(b, train=True) is None) == (
                mode != Mode.LUT_INFER), name
    whisper = build_model(get_arch("whisper_tiny"), Mode.LUT_INFER)
    kept = {tp: tensor_parallel.layout(whisper, ShardingRules(model=tp)).kept for tp in (2, 4)}
    assert kept == {2: ("cross_kv_by_heads", "embed_whole"), 4: ("heads_whole", "embed_whole")}
    lay = tensor_parallel.layout(whisper, ShardingRules(model=2))
    assert lay.roles["decoder/cross/k"] == "col" and lay.roles["decoder/cross/o"] == "row"
    assert not lay.vocab and "embed/table" not in lay.cuts
    vlm = build_model(get_arch("qwen2_vl_7b"), Mode.DENSE)
    assert tensor_parallel.layout(vlm, ShardingRules(model=2)).roles["lm_head"] == "col_gather"
    assert tensor_parallel.layout(vlm, ShardingRules(data=2, model=2),
                                  train=True).roles["lm_head"] == "col"
    mesh = HostMesh(data=1, model=2, rank=0, device=torch.device("cpu"), backend="gloo")
    for name, why in (("whisper_tiny", "could not run the encoder"),
                      ("qwen2_vl_7b", "could not give this model the embeddings")):
        b = build_model(reduce_arch(get_arch(name), n_layers=2), Mode.LUT_INFER)
        with pytest.raises(ValueError, match=why):
            ServingEngine(b, b.init(device="cpu"), mesh=mesh, device="cpu", autotune_lut=False)


def _serving_want(bundle, rules, lay, path: str, shape: tuple) -> tuple | None:
    """A serving rank's shape of a leaf by the spec, but for the kept
    differences; None for a LUT table's scale or bias (the spec replicates
    them, a rank holds the part that goes with its table's cut)."""
    if path.endswith(("/table_scale", "/b")):
        return None
    sizes = {"data": 1, "model": rules.model}
    own = kept_rank_shape(bundle, lay.kept, path, shape, sizes)
    if own is not None:
        return own
    spec = rules.param_spec(path, shape, site_roles=site_roles(bundle))
    return spec_part_shape(shape, spec, sizes)[is_stacked(path):]


@pytest.mark.parametrize("purpose", ("serve", "train"))
@pytest.mark.parametrize("name", ("whisper_tiny", "qwen2_vl_7b"))
def test_rank_shapes_at_full_width_follow_the_spec_or_a_kept_difference(name, purpose):
    """Each rank's part of every param leaf at full published width (meta
    tensors): serving (DENSE and LUT_INFER) at tp 2 and 4, each leaf the
    spec's shard shape (a table's scale and bias with its table's cut), and
    training (DENSE and LUT_TRAIN) at (2, 2) and (2, 4), FSDP off and on,
    `testing.expected_rank_shapes`, but for the kept differences
    `Layout.kept` names; the local bundle's param specs are the rank's."""
    modes = (Mode.DENSE, Mode.LUT_INFER) if purpose == "serve" else (Mode.DENSE, Mode.LUT_TRAIN)
    meshes = ([(1, 2, False), (1, 4, False)] if purpose == "serve" else
              [(d, m, f) for d, m in ((2, 2), (2, 4)) for f in (False, True)])
    for mode in modes:
        bundle = build_model(get_arch(name), mode)
        specs = flatten_tree(bundle.param_specs())
        for d, m, fsdp in meshes:
            rules = ShardingRules(data=d, model=m, fsdp=fsdp)
            train = purpose == "train"
            lay = tensor_parallel.layout(bundle, rules, train=train)
            local = flatten_tree(tensor_parallel.local_bundle(bundle, lay).param_specs())
            for dr in range(d):
                want = expected_rank_shapes(bundle, rules, dr, kept=lay.kept)[0] if train else {}
                for mr in range(m):
                    for path, ps in specs.items():
                        meta = torch.empty(tuple(ps.shape), dtype=ps.dtype, device="meta")
                        got = tuple(lay.part(path, meta, dr, mr, stacked=is_stacked(path)).shape)
                        got = got[is_stacked(path):]
                        w = (want[path][0] if train else
                             _serving_want(bundle, rules, lay, path, tuple(ps.shape)))
                        assert w is None or got == tuple(w), (mode, (d, m, fsdp), path, got, w)
                        if not fsdp:
                            loc = list(local[path].shape)[is_stacked(path):]
                            if path == "embed/table" and lay.vocab:
                                loc[0] //= m            # the configs keep the whole vocab
                            assert list(got) == loc, (mode, (d, m), path, got, loc)


# ---------------------------------------------------------------------------
# serving at tp 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANTS)
def test_tp_serving_matches_the_unsharded_port_and_the_reference(runs, name):
    """A prefill (whisper: 6 tokens with its frames, the encoder and the
    rank's heads of the cross K/V; qwen2_vl: 12 embedding rows) then STEPS
    greedy decode steps on each rank: every forward's logits within
    LOGIT_ATOL of the unsharded port's, dense and paged; the tokens equal
    the reference's unsharded serve step's and its sharded `make_serve_step`
    on a (2, 4) mesh; each row-parallel LUT site call bytewise the
    unsharded site's on the gathered input and tables (its codes the
    ranks'); the cross K/V cache holds the rank's KV heads."""
    spec = VARIANTS[name]
    bundle, params = serve_model(spec)
    inputs, table = serve_inputs(spec), params["embed"]["table"]

    def fwd(b, c):
        return bundle.forward_step(params, b, c)

    want = {paged: greedy_serve(fwd, bundle, inputs, table, STEPS, paged=paged)
            for paged in (False, True)}
    ref = runs["ref"][name]
    np.testing.assert_array_equal(ref["plain"], ref["sharded"])
    np.testing.assert_array_equal(want[False]["tokens"].numpy(), ref["plain"])
    arch = bundle.arch
    for r in runs["by"][("serve", name, "lut_infer")]:
        for case, paged in (("dense", False), ("paged", True)):
            got = r[case]
            assert len(got["logits"]) == 1 + STEPS
            for i, (g, w) in enumerate(zip(got["logits"], want[paged]["logits"])):
                np.testing.assert_allclose(g, w.numpy(), atol=LOGIT_ATOL, rtol=0,
                                           err_msg=f"{r['rank']} {case} forward {i}")
            np.testing.assert_array_equal(got["tokens"], ref["sharded"], err_msg=case)
        rows = r["rows"]
        assert rows["calls"] > 0 and rows["bytewise"] == rows["calls"] and \
            rows["codes_off"] == 0, rows
        if arch.family == "audio":
            assert r["cross_k"][3] == arch.n_kv_heads // MESH[1]
            assert "cross_kv_by_heads" in r["kept"]
            assert ("embed_whole" in r["kept"]) == (arch.vocab % MESH[1] != 0) != r["vocab"]
        assert r["k"][3] == arch.n_kv_heads // MESH[1]
        assert r["counters"]["all_reduce"] > 0


@pytest.mark.parametrize("name", VARIANTS)
def test_make_serve_step_on_a_mesh_is_forward_step(runs, name):
    """`train_step.make_serve_step(local, mesh=)`'s greedy run is bytewise
    `ModelBundle.forward_step(mesh=)`'s on every rank."""
    for r in runs["by"][("serve", name, "lut_infer")]:
        assert r["serve_step_bytewise"], r["rank"]


# ---------------------------------------------------------------------------
# training at (2, 2)
# ---------------------------------------------------------------------------

def _as_tree(flat: dict, like) -> dict:
    return tree_from_reference(like, flat, device="cpu")


def _hold_log_t(got_1, grads: dict, params, opt) -> int:
    """Each log_t after one step against AdamW applied to the rank's own
    gradient, within 1e-5 of its move and 2 ulps (the leaf rule's 1e-4 of
    the move is below a log_t's rounding: tests/test_torch_tp_train.py)."""
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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", VARIANTS)
def test_tp_step_matches_the_single_rank_step(runs, name, mode):
    """One step at (2, 2), DENSE (clip 1.0) or LUT_TRAIN: the loss within
    SINGLE_LOSS_RTOL, the params after it by the leaf rule (a log_t by
    AdamW of its own gradient), frozen leaves untouched, each rank's param
    and moment shapes its cut (`expected_rank_shapes` with the kept
    differences), replicated leaves bytewise equal across each model group
    and params across each data group; no LUT kernel and no plain LUT
    call."""
    spec = train_spec(name, mode)
    losses, states, rule, params = dp_single(spec, None, 1)
    bundle, _, opt, frozen = dp_model(spec)
    single_1 = _as_tree(states[0], {"params": params, "opt": opt.init(params, frozen)})["params"]
    frozen_paths = {p for p, ls in reference_leaves(frozen or {}).items() if ls[0]}
    assert (mode == "dense") != bool(frozen_paths)
    start = reference_arrays(params)
    rules = ShardingRules(data=MESH[0], model=MESH[1])
    lay = tensor_parallel.layout(bundle, rules, train=True)
    by = {tuple(r["rank"]): r for r in runs["by"][("train", name, mode)]}
    for (d, m), r in by.items():
        np.testing.assert_allclose(r["loss"], losses, rtol=SINGLE_LOSS_RTOL)
        got_1 = _as_tree(r["params_1"], params)
        if mode == "lut_train":
            assert _hold_log_t(got_1, r["grads"], params, opt) > 0
            got_1 = tree_map_ref(lambda p, g, w: w if p.endswith("log_t") else g, got_1,
                                 single_1)
        worst, where = rule.check(got_1, single_1, params)
        assert worst <= 1.0, ((d, m), worst, where)
        for path in frozen_paths:
            np.testing.assert_array_equal(r["arrays"][f"params/{path}"], start[path],
                                          err_msg=path)
        want_p, want_m = expected_rank_shapes(bundle, rules, d, frozen_paths, lay.kept)
        assert r["param_shapes"] == {p: [tuple(s) for s in v] for p, v in want_p.items()}
        assert r["moment_shapes"] == {p: [tuple(s) for s in v] for p, v in want_m.items()}
        for path, a in r["local"].items():
            if path not in lay.cuts:
                np.testing.assert_array_equal(a, by[(d, 1 - m)]["local"][path], err_msg=path)
            np.testing.assert_array_equal(a, by[(1 - d, m)]["local"][path], err_msg=path)
        assert sum(r["launches"].values()) == 0 and r["plain"] == 0


def _hold_grads(r: dict, single: dict, terms: dict, paths) -> int:
    """The rank's whole gradients (before the update) at `paths` against the
    single rank's: GRAD_L2 / GRAD_MAX, a log_t by its terms' magnitudes."""
    for path in paths:
        got, want = r["grads"][path], single["grads"][path]
        assert got.shape == want.shape, path
        if path.endswith("log_t"):
            unit = np.maximum(np.asarray(terms[path]), 1e-30)
            assert (np.abs(got - want) <= LOG_T_TERMS * unit).all(), (path, got, want)
            continue
        l2, mx = _rel(torch.as_tensor(got), torch.as_tensor(want))
        assert l2 <= GRAD_L2 and mx <= GRAD_MAX, (r["rank"], path, l2, mx)
    return len(paths)


def _single(name: str, mode: str):
    spec = train_spec(name, mode)
    terms = {}
    if mode == "lut_train":
        bundle, params, _, _ = dp_model(spec)
        terms = lut_train_grads(bundle, params, dp_batch(spec, 0))[3]
    return tp_single_grads(spec), terms


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", VARIANTS)
def test_tp_gradients_match_the_single_rank_gradients(runs, name, mode):
    """Every gradient leaf at (2, 2) before the update, gathered to whole
    leaves, against the single rank's; the global norm likewise."""
    single, terms = _single(name, mode)
    for r in runs["by"][("train", name, mode)]:
        assert sorted(r["grads"]) == sorted(single["grads"]), r["rank"]
        assert abs(r["grad_norm0"] - single["norm"]) <= NORM_RTOL * single["norm"]
        _hold_grads(r, single, terms, single["grads"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ("whisper", "whisper_odd"))
def test_encoder_gradients_match_the_single_rank(runs, name, mode):
    """The encoder's gradients at (2, 2) (its blocks' and its final norm's),
    which reach it through the decoder's cross-attention k and v of every
    rank's heads: each rank's gradient into the encoder's output is the sum
    over "model" of its heads' parts (the `copy` in front of the column
    sites), the single rank's."""
    single, terms = _single(name, mode)
    enc = [p for p in single["grads"] if p.startswith(("encoder/", "enc_norm/"))]
    assert len(enc) > 8
    for r in runs["by"][("train", name, mode)]:
        _hold_grads(r, single, terms, enc)


@pytest.mark.parametrize("name", VARIANTS)
def test_fsdp_step_is_the_zero1_step(runs, name):
    """The (2, 2) DENSE step under FSDP (each rank its "data" part of every
    leaf the spec splits over "data" too, gathered per block and per
    forward) is bytewise the ZeRO-1 step: its loss, its gradients and the
    params after it; each rank's parts by `param_spec(fsdp=True)` but for
    the kept differences; the data gathers and their reduce-scatters ran."""
    spec = train_spec(name, "dense", fsdp=True)
    bundle = dp_model(spec)[0]
    rules = ShardingRules(data=MESH[0], model=MESH[1], fsdp=True)
    lay = tensor_parallel.layout(bundle, rules, train=True)
    assert lay.fsdp
    zero1 = {tuple(r["rank"]): r for r in runs["by"][("train", name, "dense")]}
    for r in runs["by"][("fsdp", name, "dense")]:
        z = zero1[tuple(r["rank"])]
        assert r["loss"] == z["loss"] and r["grad_norm0"] == z["grad_norm0"]
        for key in ("grads", "params_1"):
            assert sorted(r[key]) == sorted(z[key])
            for path, a in z[key].items():
                np.testing.assert_array_equal(r[key][path], a, err_msg=f"{key} {path}")
        want_p, _ = expected_rank_shapes(bundle, rules, r["rank"][0], kept=lay.kept)
        assert r["param_shapes"] == {p: [tuple(s) for s in v] for p, v in want_p.items()}
        c = r["axis_counters"]["data"]
        assert c["all_gather"] > 0 and c["reduce_scatter"] > 0


@pytest.mark.parametrize("name", VARIANTS)
def test_tp_dense_step_matches_the_reference_sharded_step(runs, name):
    """The port's (2, 2) DENSE step against the reference's (2, 4) GSPMD
    step from the same params and batch (frames; embeddings and M-RoPE
    positions) within the reference test's bound."""
    ref = runs["ref"][name]
    for r in runs["by"][("train", name, "dense")]:
        assert abs(r["loss"][0] - float(ref["loss"])) < REF_LOSS_TOL
        params = {p for p in ref if p.startswith("params/")}
        assert {p for p in r["arrays"] if p.startswith("params/")} == params
        for path in params:
            np.testing.assert_allclose(r["arrays"][path], ref[path], rtol=REF_RTOL,
                                       atol=REF_ATOL, err_msg=path)
