"""Rank processes of the port's tensor-parallel tests (spawned; imports no JAX).
The ranks run on the CPU (tests/test_torch_tp.py) or share one card
(tests/test_torch_cuda.py).

`run_ranks(fn, tp, *args)` spawns `tp` ranks that join a gloo mesh on the
CPU and call `fn(mesh, *args)`; it returns their results in rank order,
tensors as numpy arrays. The mesh's ranks are on its "model" axis, or with
`axis="data"` on its "data" axis (tests/test_torch_dp.py); with `axis=None`
the ranks join no mesh and `fn(rank, init, *args)` joins one itself.
With `axis=(data, model)` the ranks join that 2-D mesh
(tests/test_torch_tp_train.py).
`tp_train`, `tp_trainer` and `tp_route_record` are the ranks' work in
tests/test_torch_tp_train.py and tests/test_torch_tp_train_families.py,
ZeRO-1 or (spec["fsdp"]) FSDP, and `fsdp_collectives` the FSDP collectives'
checks in tests/test_torch_dp.py.
`serve_family` (`serve_families`) is the ranks' work in
tests/test_torch_tp_families.py: the MoE, SSM and hybrid artifacts through
the unsharded and the tensor-parallel engines, with the experts' outputs
recorded too.
`serve_variant` (`serve_variants`) is the ranks' work in tests/test_torch_tp.py: the same
requests through the unsharded engine (rank 0) and through the dense, paged
and artifact tensor-parallel engines, every linear site's output and every
forward's logits recorded on each rank. The dense and paged engines are
built here from the whole param tree; the artifact engine is the
launcher's (`launch.serve.serve_on_mesh`), each rank reading only its
shards.
`tp_serve_family` is the ranks' serving work in
tests/test_torch_tp_encdec_vlm.py (the enc-dec and the vision-LM through
`ModelBundle.forward_step(mesh=)` and `make_serve_step(mesh=)`, by
`greedy_serve`), whose training work is `tp_train` on `dp_batch`'s
family batches.
The `dp_*` functions are the ranks' work in the data-parallel tests
(tests/test_torch_dp.py, test_torch_elastic.py, test_torch_grad_compression.py
and the card's test_torch_cuda.py): ZeRO-1 steps (`dp_train`) against the
single-rank step (`dp_single`), elastic rescale (`dp_elastic`), the Trainer
on a mesh (`dp_trainer`), the compressed reduce (`dp_compress`) and the
training launcher under torchrun's environment (`dp_launcher`).
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import socket
import traceback

import torch

DENSE_REQS = [([1, 2, 3, 4, 5, 6, 7], 6), ([9, 8, 7], 6)]
PAGED_REQS = [([1, 2, 3, 4, 5, 6, 7], 5), ([9, 8, 7], 5), ([1, 2, 3, 4, 5, 6, 7], 5),
              ([1, 2, 3, 4], 5)]
ARTIFACT_REQS = [([1, 2, 3, 4, 5], 5)]
ENGINE_KW = dict(n_slots=2, max_seq=32, prefill_chunk=4, autotune_lut=False)


def _rank_main(rank, devices, init, fn, args, q, axis="model"):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh

    try:
        if axis is None:
            q.put((rank, "ok", _host(fn(rank, init, *args))))
            return
        n = len(devices)
        data, model = (axis if isinstance(axis, tuple)
                       else (n if axis == "data" else 1, n if axis == "model" else 1))
        mesh = make_host_mesh(data=data, model=model,
                              rank=rank, devices=devices, init_method=init, timeout_s=300)
        try:
            q.put((rank, "ok", _host(fn(mesh, *args))))
        finally:
            mesh.close()
    except BaseException:             # noqa: BLE001 — the parent reports it
        q.put((rank, "error", traceback.format_exc()))


def _host(obj):
    """Tensors as numpy arrays (a queue would share a tensor's memory with
    the exiting rank), through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def start_ranks(fn, tp: int, *args, devices: list[str] | None = None, axis: str | None = "model"):
    """Spawn the ranks (on the CPU unless `devices` names each rank's) on the
    mesh axis `axis` (None: no mesh); `collect` the handle for their results."""
    devices = devices or ["cpu"] * tp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, devices, init, fn, args, q, axis))
             for r in range(tp)]
    for p in procs:
        p.start()
    return procs, q


def collect(handle, timeout: float = 300) -> list:
    procs, q = handle
    try:
        got = dict((r, (status, val)) for r, status, val in (q.get(timeout=timeout)
                                                               for _ in procs))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    errors = [val for status, val in got.values() if status != "ok"]
    assert not errors, "\n".join(errors)
    return [got[r][1] for r in range(len(procs))]


def run_ranks(fn, tp: int, *args, devices: list[str] | None = None,
              timeout: float = 300, axis: str | None = "model") -> list:
    return collect(start_ranks(fn, tp, *args, devices=devices, axis=axis), timeout)


@contextlib.contextmanager
def recording(experts: list | None = None, layers: list | None = None):
    """Record (site name, mode, tp role, output) of every linear site call
    (attention, MLP, mamba2, the router and the hybrid's fuse and out), and
    the logits and write lengths (the valid positions of each row) of every
    forward, in call order; with `experts`, also ((MoE layer call, expert
    site call in it), the site's experts held, the experts called, input,
    output) of every expert site call, and with `layers` (MoE layer call,
    input, output) of every MoE layer."""
    from repro_torch.configs import ModelBundle
    from repro_torch.models import attention, hybrid, mamba2, mlp, moe

    sites, logits = [], []
    mods = (attention, mlp, mamba2, moe, hybrid)
    orig = attention.linear, ModelBundle.forward_step, moe.expert_linear, moe.moe
    at = [0, 0]                       # (MoE layer call, expert site call in it)

    def linear(site, p, x):
        y = orig[0](site, p, x)
        role = site.tp or ""
        sites.append((site.name, site.mode.value, role, y.detach().cpu()))
        return y

    def forward_step(self, params, batch, caches, **kw):
        out = orig[1](self, params, batch, caches, **kw)
        logits.append((out[0].detach().cpu(), batch["write_len"].clone()))
        return out

    def moe_layer(cfg, p, x):
        at[:] = at[0] + 1, 0
        y, aux = orig[3](cfg, p, x)
        if layers is not None:
            layers.append((at[0], x.detach().cpu(), y.detach().cpu()))
        return y, aux

    def expert_linear(s, p, x, ids=None):
        y = orig[2](s, p, x, ids)
        at[1] += 1
        experts.append((tuple(at), s.n_experts, ids.cpu(), x.detach().cpu(), y.detach().cpu()))
        return y

    for mod in mods:
        mod.linear = linear
    ModelBundle.forward_step = forward_step
    if experts is not None:
        moe.expert_linear, moe.moe = expert_linear, moe_layer
    try:
        yield sites, logits
    finally:
        for mod in mods:
            mod.linear = orig[0]
        ModelBundle.forward_step = orig[1]
        moe.expert_linear, moe.moe = orig[2], orig[3]


def _run(eng, reqs) -> list[list[int]]:
    for prompt, n in reqs:
        eng.submit(prompt, max_tokens=n)
    return [r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)]


def serve_variant(mesh, art_dir: str) -> dict:
    """Rank 0: the unsharded engines' tokens and records, then (all ranks)
    the tensor-parallel dense, paged and artifact engines'. Returns
    {"plain": {...}, "tp": {...}} of tokens, site records and logits."""
    from repro_torch.kernels import counters
    from repro_torch.launch import serve
    from repro_torch.serving.artifact import load_artifact
    from repro_torch.serving.engine import ServingEngine

    dev = mesh.device
    art = load_artifact(art_dir, device=dev, restore_autotune=False)
    paged = dict(paged=True, page_size=4)
    cases = (("dense", {}, DENSE_REQS), ("paged", paged, PAGED_REQS),
             ("artifact", {}, ARTIFACT_REQS))
    out: dict = {"plain": {}, "tp": {}}
    if mesh.rank == 0:
        for name, kw, reqs in cases:
            with recording() as (sites, logits):
                toks = _run(ServingEngine(art.bundle, art.params, device=dev, **ENGINE_KW, **kw),
                            reqs)
            out["plain"][name] = {"tokens": toks, "sites": sites, "logits": logits}
    for name, kw, reqs in cases:
        box: dict = {}

        def on_engine(eng, _box=box):
            _box["eng"] = eng
            mesh.reset_counters()
            counters.reset()

        def lead(eng, source, _reqs=reqs):
            return _run(eng, _reqs), eng.stats()

        with recording() as (sites, logits):
            if name == "artifact":
                args = serve.parse_args(["--artifact", art_dir, "--slots", "2", "--max-seq",
                                         "32", "--prefill-chunk", "4"])
                got = serve.serve_on_mesh(mesh, args, lead=lead, on_engine=on_engine)
            else:
                eng = ServingEngine(art.bundle, art.params, mesh=mesh, device=dev, **ENGINE_KW,
                                    **kw)
                on_engine(eng)
                if mesh.rank == 0:
                    got = lead(eng, "")
                    eng.close()
                else:
                    got = eng.follow()
        toks, st = got if mesh.rank == 0 else (None, got)
        eng = box["eng"]
        rec = {"tokens": toks, "sites": sites, "logits": logits, "stats": st,
               "counters": dict(mesh.counters), "layout": dict(eng.layout.roles),
               "launches": counters.launches(), "plain_calls": counters.plain_calls(),
               "vocab": eng.layout.vocab}
        if name == "paged":
            rec["pool"] = [tuple(t.shape) for n, t in _pool_leaves(eng.caches)]
        elif name == "dense":
            rec["cache"] = [tuple(t.shape) for n, t in _pool_leaves(eng.caches, ("k", "v"))]
            rec["param_shapes"] = {k: tuple(v.shape) for k, v in
                                   eng.params["segments"][1][0]["attn"]["q"].items()}
        out["tp"][name] = rec
    return out


def serve_variants(mesh, art_dirs: dict[str, str]) -> dict:
    """`serve_variant` of each {variant: artifact directory}."""
    return {variant: serve_variant(mesh, d) for variant, d in art_dirs.items()}


def _pool_leaves(caches, names=("k_pool", "v_pool")):
    from repro_torch.configs import cache_leaves

    return [(n, t) for n, t in cache_leaves(caches) if n in names]


FAMILY_ENGINE_KW = dict(n_slots=2, max_seq=32, prefill_chunk=8, autotune_lut=False)


def serve_family(mesh, art_dir: str, reqs: list, paged: bool) -> dict:
    """One family's artifact: rank 0 serves `reqs` through the unsharded
    engines, then every rank through the tensor-parallel ones, dense and
    (with `paged`) paged, each with its site, expert and logit records.
    Returns {"plain": {case: ...}, "tp": {case: ...}}."""
    from repro_torch.configs import cache_leaves
    from repro_torch.serving.artifact import load_artifact
    from repro_torch.serving.engine import ServingEngine

    dev = mesh.device
    art = load_artifact(art_dir, device=dev, restore_autotune=False)
    cases = [("dense", {})] + ([("paged", dict(paged=True, page_size=4))] if paged else [])
    out: dict = {"plain": {}, "tp": {}}
    if mesh.rank == 0:
        for name, kw in cases:
            experts: list = []
            with recording(experts) as (sites, logits):
                toks = _run(ServingEngine(art.bundle, art.params, device=dev,
                                          **FAMILY_ENGINE_KW, **kw), reqs)
            out["plain"][name] = {"tokens": toks, "sites": sites, "logits": logits,
                                  "experts": experts}
    for name, kw in cases:
        experts, layers = [], []
        with recording(experts, layers) as (sites, logits):
            eng = ServingEngine(art.bundle, art.params, mesh=mesh, device=dev,
                                **FAMILY_ENGINE_KW, **kw)
            mesh.reset_counters()
            if mesh.rank == 0:
                toks, st = _run(eng, reqs), eng.stats()
                eng.close()
            else:
                toks, st = None, eng.follow()
        if name == "dense":
            # the rank's shards as load_artifact(mesh=) reads them: place()'s bytewise
            ranked = load_artifact(art_dir, mesh=mesh, restore_autotune=False).params.tree
            out["artifact_shards_equal"] = (
                _leaves(ranked).keys() == _leaves(eng.params).keys()
                and all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(_leaves(ranked).values(), _leaves(eng.params).values())))
        kv = [t for n, t in cache_leaves(eng.caches) if n in ("k", "v", "k_pool", "v_pool")]
        out["tp"][name] = {
            "tokens": toks, "sites": sites, "logits": logits, "experts": experts,
            "moe_layers": layers, "stats": st,
            "counters": dict(mesh.counters), "cuts": dict(eng.layout.cuts),
            "kept": eng.layout.kept,
            "kv_written": [bool(t.float().abs().sum() > 0) for t in kv],
            "cache_shapes": {n: tuple(t.shape) for n, t in cache_leaves(eng.caches)}}
    return out


def _leaves(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _leaves(t, f"{path}/{i}").items()}
    return {path: tree}


def serve_families(mesh, families: dict) -> dict:
    """`serve_family` of each {arch: (artifact directory, requests, paged)}."""
    return {name: serve_family(mesh, *args) for name, args in families.items()}


# ---------------------------------------------------------------------------
# data-parallel ranks (tests/test_torch_dp.py, tests/test_torch_grad_compression.py)
# ---------------------------------------------------------------------------

def dp_model(spec: dict, flat: dict | None = None):
    """(bundle, params, opt, frozen mask) of a small training run `spec`:
    the arch reduced to spec's width and depth, the params the reference's
    arrays `flat` (or the port's init from seed 0, on the CPU) on
    spec["device"] (the CPU by default), AdamW as spec says."""
    from repro_torch.configs import build_model
    from repro_torch.core.amm import Mode
    from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
    from repro_torch.weights import layer_specs, tree_from_reference, tree_map_ref

    bundle = build_model(spec_arch(spec), Mode(spec["mode"]))
    dev = spec.get("device", "cpu")
    params = (tree_from_reference(layer_specs(bundle), flat, device=dev) if flat is not None
              else tree_map_ref(lambda _p, t: t.to(dev), bundle.init(
                  torch.Generator().manual_seed(0), device="cpu")))
    lut = spec["mode"] == "lut_train"
    opt = AdamW(lr=spec["lr"], clip_norm=spec["clip"], weight_decay=spec.get("wd", 0.0),
                rules=SOFT_PQ_RULES if lut else ())
    return bundle, params, opt, lut_frozen_mask(params) if lut else None


def spec_arch(spec: dict):
    """The arch of a small run `spec`: reduced to its width and depth."""
    from repro_torch.configs import get_arch, reduce_arch

    return reduce_arch(get_arch(spec["arch"]), n_layers=spec["layers"], vocab=spec["vocab"],
                       d_model=spec["d"], d_ff=spec["d_ff"])


def dp_batch(spec: dict, i: int) -> dict:
    """The `i`-th global batch of `spec`: MarkovLM's tokens, or for the
    enc-dec and a model that takes embeddings `testing.family_batch`'s
    (frames, or embeddings and M-RoPE positions) from seed `i`."""
    import numpy as np

    from repro_torch.data import MarkovLM
    from repro_torch.testing import family_batch

    arch = spec_arch(spec)
    if arch.family == "audio" or arch.takes_embeds:
        batch = family_batch(arch, spec["batch"], spec["seq"], seed=i)
    else:
        batch = MarkovLM(vocab=spec["vocab"], seq_len=spec["seq"], batch=spec["batch"]
                         ).batch_at(i)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def dp_train(mesh, spec: dict, flat: dict | None, steps: int) -> dict:
    """`steps` data-parallel ZeRO-1 steps on the rank: the losses, grad
    norms, the params after the first step, the gathered state's reference
    arrays, this rank's params and moment shards' shapes, the mesh's
    collective counts and the kernel counts."""
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.kernels import counters
    from repro_torch.weights import reference_arrays, reference_leaves

    bundle, params, opt, frozen = dp_model(spec, flat)
    counters.reset()
    layout = Zero1.build(mesh, params, frozen)
    state = layout.init_state(opt, params, frozen)
    step = make_data_parallel_step(bundle, opt, layout, frozen_mask=frozen,
                                   compute_dtype=torch.float32,
                                   grad_accum=spec.get("accum", 1))
    out: dict = {"loss": [], "grad_norm": []}
    for i in range(steps):
        params, state, m = step(params, state, dp_batch(spec, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["params_1"] = reference_arrays(params)
    out["shards"] = {p: [tuple(t.shape) for t in leaves]
                     for p, leaves in reference_leaves(state.m).items()}
    out["params"] = reference_arrays(params)
    out["arrays"] = reference_arrays(layout.gather_state({"params": params, "opt": state}))
    out["counters"] = dict(mesh.counters)
    out["launches"], out["plain"] = counters.launches(), counters.plain_calls()
    return out


def dp_single(spec: dict, flat: dict | None, steps: int, *, float64: bool = False):
    """The port's single-rank step `steps` times on spec's device: (losses,
    the train state's reference arrays after each step, the
    `testing.AdamLeafRule` fed the first step's gradient, the params before
    the first step). With `float64`, the same steps in float64 (the
    witness: params, moments and compute)."""
    import contextlib
    import dataclasses

    from repro_torch.testing import AdamLeafRule, float64_compute
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import reference_arrays, tree_map_ref

    bundle, params, opt, frozen = dp_model(spec, flat)
    if float64:
        opt = dataclasses.replace(opt, state_dtype=torch.float64)
        params = tree_map_ref(lambda _p, t: t.double() if t.is_floating_point() else t, params)
    start, state = params, opt.init(params, frozen)
    step = make_train_step(bundle, opt, frozen_mask=frozen, grad_accum=spec.get("accum", 1),
                           compute_dtype=torch.float64 if float64 else torch.float32)
    rule, losses, states = AdamLeafRule(opt), [], []
    with float64_compute() if float64 else contextlib.nullcontext():
        for i in range(steps):
            m_old = state.m
            params, state, met = step(params, state, dp_batch(spec, i))
            if i == 0:     # the step's (clipped) gradient, up to a factor, from the first moment
                rule.note(tree_map_ref(lambda _p, m, m0: None if m.numel() == 0
                                       else m - opt.b1 * m0, state.m, m_old), opt.lr)
            losses.append(float(met["loss"]))
            states.append(reference_arrays({"params": params, "opt": state}))
    return losses, states, rule, start


def dp_elastic(rank: int, init: str, n: int, spec: dict, ckdir: str, steps: int,
               restore: bool) -> dict:
    """One rank of an elastic run on `n` CPU ranks: build the context (its
    own mesh; FSDP with spec["fsdp"]: the rank's parts), restore the newest
    checkpoint cut for it (`rescale`) if `restore`, run `steps` steps, then
    commit (rank 0) and leave."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.distributed.elastic import ElasticContext, rescale
    from repro_torch.weights import reference_leaves

    from repro_torch.distributed.tensor_parallel import place

    bundle, params, opt, frozen = dp_model(spec)
    made: dict = {}

    def make_step(mesh, rules):
        local, lp, lay = bundle, params, None
        if rules.fsdp:                   # the rank's parts
            local, lp, lay = place(bundle, params, rules, mesh, train=True)
        made["params"] = lp
        made["layout"] = Zero1.build(mesh, lp, frozen, rules, tp=lay)
        return make_data_parallel_step(local, opt, made["layout"], frozen_mask=frozen,
                                       compute_dtype=torch.float32)

    ctx = ElasticContext.build(["cpu"] * n, make_step, fsdp=spec.get("fsdp", False), rank=rank,
                               init_method=init)
    layout, ck, params = made["layout"], Checkpointer(ckdir), made["params"]
    state = layout.init_state(opt, params, frozen)
    start = 0
    try:
        if restore:
            start, tree = rescale(ck, {"params": params, "opt": state}, ctx,
                                  layout.cuts(params))
            params, state = tree["params"], tree["opt"]
        losses = []
        for i in range(start, start + steps):
            params, state, m = ctx.step_fn(params, state, dp_batch(spec, i))
            losses.append(float(m["loss"]))
        full = layout.gather_state({"params": params, "opt": state})
        if rank == 0:
            ck.save(start + steps, full, blocking=True)
        ctx.mesh.barrier()
    finally:
        ctx.mesh.close()
    return {"start": start, "step": int(state.step), "loss": losses,
            "mesh": (ctx.mesh.data, ctx.mesh.model), "fsdp": ctx.rules.fsdp,
            "shapes": {p: [tuple(t.shape) for t in ls]
                       for p, ls in reference_leaves(params).items()}}


def dp_compress(mesh, vecs, trees, toy: dict) -> dict:
    """The collective compressed mean of this rank's row of `vecs` and its
    tree, and the linear toy of tests/test_sharded.py through
    `make_compressed_grad_fn` (the global batch's rows split over the
    ranks)."""
    from repro_torch.train import grad_compression as gc

    r = mesh.rank
    out = {"vec": gc.compressed_mean_1d(torch.as_tensor(vecs[r]), mesh),
           "tree": gc.flat_vector(gc.compressed_mean_tree(_tree_of(trees[r]), mesh))}
    w = {"w": torch.as_tensor(toy["w"])}

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()

    batch = {"x": torch.as_tensor(toy["x"]), "y": torch.as_tensor(toy["y"])}
    loss, grads, res = gc.make_compressed_grad_fn(loss_fn, mesh)(w, gc.init_residual(w), batch)
    out["toy"] = {"loss": float(loss), "grad": grads["w"], "residual": res["w"]}
    return out


def _tree_of(arrays: dict):
    """A port-layout tree of {"embed": {"table"}, "segments": [[{"w"} per
    layer]]} from its reference arrays (w stacked over layers)."""
    return {"embed": {"table": torch.as_tensor(arrays["table"])},
            "segments": [[{"w": torch.as_tensor(w)} for w in arrays["w"]]]}


def dp_trainer(mesh, spec: dict, ckdir: str, steps: int) -> dict:
    """The Trainer over the rank's ZeRO-1 step: `steps` straight in one
    directory, then steps // 2, a commit, and a fresh Trainer resuming to
    `steps` in another; both runs' params and gathered moments."""
    import pathlib

    from repro_torch.distributed.data_parallel import Zero1, make_data_parallel_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.weights import reference_arrays

    bundle, start, opt, frozen = dp_model(spec)
    layout = Zero1.build(mesh, start, frozen)
    step = make_data_parallel_step(bundle, opt, layout, frozen_mask=frozen,
                                   compute_dtype=torch.float32)

    def fit(total: int, name: str):
        tr = Trainer(step_fn=step, batch_at=lambda i: dp_batch(spec, i),
                     cfg=TrainerConfig(total_steps=total, ckpt_every=steps // 2, log_every=0,
                                       ckpt_dir=str(pathlib.Path(ckdir) / name)),
                     mesh=mesh, layout=layout)
        params, state = tr.fit(start, layout.init_state(opt, start, frozen))
        return reference_arrays(layout.gather_state({"params": params, "opt": state})), tr

    straight, _ = fit(steps, "straight")
    fit(steps // 2, "split")
    resumed, tr = fit(steps, "split")
    return {"straight": straight, "resumed": resumed,
            "resumed_steps": [h["step"] for h in tr.history]}


def dp_launcher(rank: int, init: str, n: int, argv: list[str]) -> str:
    """`launch.train.main(argv)` as rank `rank` of `n` in torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT from `init`):
    the launcher joins the mesh itself. Returns what it printed."""
    import contextlib
    import io
    import os

    from repro_torch.launch import train

    host, port = init.removeprefix("tcp://").rsplit(":", 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), MASTER_ADDR=host, MASTER_PORT=port)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(argv)
    return out.getvalue()


# ---------------------------------------------------------------------------
# tensor-parallel training ranks (tests/test_torch_tp_train.py, test_torch_dp.py)
# ---------------------------------------------------------------------------

def tp_rank_state(mesh, spec: dict, flat: dict | None = None):
    """(local bundle, the rank's params, opt, its frozen mask or None, its
    Zero1 layout) of `dp_model(spec, flat)` on a (data, model) mesh, or
    with spec["fsdp"] its FSDP parts (on a data mesh too)."""
    from repro_torch.distributed.data_parallel import Zero1
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import place
    from repro_torch.optim import lut_frozen_mask

    bundle, params, opt, frozen = dp_model(spec, flat)
    rules = ShardingRules.for_mesh(mesh, fsdp=spec.get("fsdp", False))
    local, lp, lay = place(bundle, params, rules, mesh, train=True)
    lfrozen = lut_frozen_mask(lp) if frozen is not None else None
    return local, lp, opt, lfrozen, Zero1.build(mesh, lp, lfrozen, rules, tp=lay)


def grad_arrays(grads) -> dict:
    """{reference path: host array} of a gradient tree (frozen leaves, None,
    left out)."""
    from repro_torch.weights import is_stacked, reference_leaves, tensor_to_numpy

    import numpy as np

    out = {}
    for p, leaves in reference_leaves(grads).items():
        if leaves[0] is None:
            continue
        out[p] = (np.stack([tensor_to_numpy(g) for g in leaves]) if len(leaves) > 1
                  or is_stacked(p) else tensor_to_numpy(leaves[0]))
    return out


def tp_train(mesh, spec: dict, flat: dict | None, steps: int) -> dict:
    """On a rank of a (data, model) mesh: its gradients of the first global
    batch before any update (whole leaves, gathered over "model"), their
    global norm, then `steps` steps: the losses and grad norms, the whole
    params after the first step, the rank's own param and moment shard
    shapes and arrays, the gathered state's reference arrays, the
    collective counts per axis and the kernel counts."""
    from repro_torch.distributed.data_parallel import make_data_parallel_step, make_sharded_grads_fn
    from repro_torch.kernels import counters
    from repro_torch.optim import no_frozen
    from repro_torch.weights import reference_arrays, reference_leaves

    counters.reset()
    local, params, opt, frozen, layout = tp_rank_state(mesh, spec, flat)
    accum = spec.get("accum", 1)
    fz = frozen if frozen is not None else no_frozen(params)
    grads_fn = make_sharded_grads_fn(local, layout, compute_dtype=torch.float32, grad_accum=accum)
    mesh.reset_counters()
    loss0, _, grads = grads_fn(params, fz, dp_batch(spec, 0))
    out: dict = {"grad_loss": float(loss0),
                 "grad_counters": {a: dict(c) for a, c in mesh.axis_counters.items()},
                 "grad_norm0": float(layout.global_norm(opt, grads, fz)),
                 "grads": grad_arrays(layout.gather_model(layout.model_shards(grads))),
                 "rank": (mesh.data_rank, mesh.model_rank), "loss": [], "grad_norm": []}
    del grads
    state = layout.init_state(opt, params, frozen)
    step = make_data_parallel_step(local, opt, layout, frozen_mask=frozen,
                                   compute_dtype=torch.float32, grad_accum=accum)
    mesh.reset_counters()
    out["step_gathers"] = []           # the data all-gathers of each step
    for i in range(steps):
        before = mesh.axis_counters["data"]["all_gather"]
        params, state, m = step(params, state, dp_batch(spec, i))
        out["step_gathers"].append(mesh.axis_counters["data"]["all_gather"] - before)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["params_1"] = reference_arrays(layout.gather_model(layout.model_shards(params)))
    out["axis_counters"] = {a: dict(c) for a, c in mesh.axis_counters.items()}
    out["param_shapes"] = {p: [tuple(t.shape) for t in ls]
                           for p, ls in reference_leaves(params).items()}
    out["moment_shapes"] = {p: [tuple(t.shape) for t in ls]
                            for p, ls in reference_leaves(state.m).items()}
    out["local"] = reference_arrays(params)
    out["arrays"] = reference_arrays(layout.gather_state({"params": params, "opt": state}))
    out["launches"], out["plain"] = counters.launches(), counters.plain_calls()
    return out


def fsdp_collectives(mesh, seed: int) -> dict:
    """On a data rank: `reduce_scatter` of integer-valued tensors (sums
    exact) along dims 0 and 1, native and through the emulation that a CUDA
    tensor under gloo takes, whether each owns no more storage than its
    own elements, and the sum then the rank's slice; and the
    data gather (`sharded.gather_data`) in float64: its forward and its
    gradient against the whole leaf's gradient of every rank's loss,
    averaged over the ranks and sliced."""
    import numpy as np

    from repro_torch.models import sharded

    n, r = mesh.size("data"), mesh.data_rank
    rng = np.random.default_rng(seed)
    ts = torch.as_tensor(rng.integers(-50, 50, (n, 4 * n, 6 * n)).astype(np.float32))
    out: dict = {"rs": [], "want": [], "rs_own": []}
    for dim in (0, 1):
        native = mesh.reduce_scatter(ts[r].clone(), dim, "data")
        mesh._emulated = lambda t: True
        try:
            emulated = mesh.reduce_scatter(ts[r].clone(), dim, "data")
        finally:
            del mesh._emulated
        m = ts.shape[1 + dim] // n
        out["rs"].append((native, emulated))
        out["rs_own"].append([t.untyped_storage().nbytes() == t.numel() * t.element_size()
                              for t in (native, emulated)])
        out["want"].append(ts.sum(0).narrow(dim, r * m, m))
    w = torch.as_tensor(rng.standard_normal((4 * n, 6 * n)))
    xs = torch.as_tensor(rng.standard_normal((n, 5, 4 * n)))
    out["gather"] = []
    for dim in (0, 1):
        m = w.shape[dim] // n
        part = w.narrow(dim, r * m, m).clone().requires_grad_(True)
        with sharded.bound(mesh):
            whole = sharded.gather_data({"w": part}, {"w": dim})["w"]
        ((xs[r] @ whole) ** 2).sum().backward()
        ref = torch.zeros_like(w)
        for j in range(n):                      # every rank's loss on the whole leaf
            wj = w.clone().requires_grad_(True)
            ((xs[j] @ wj) ** 2).sum().backward()
            ref += wj.grad
        out["gather"].append({"forward_equal": bool(torch.equal(whole.detach(), w)),
                              "grad": part.grad, "want": (ref / n).narrow(dim, r * m, m)})
    return out


def tp_single_grads(spec: dict, flat: dict | None = None) -> dict:
    """The single-rank step's gradients of the first batch (whole leaves),
    its loss and global norm, on spec's device (the CPU by default)."""
    from repro_torch.optim import no_frozen
    from repro_torch.train.train_step import make_grads_fn

    bundle, params, opt, frozen = dp_model(spec, flat)
    fz = frozen if frozen is not None else no_frozen(params)
    batch = {k: v.to(spec.get("device", "cpu")) for k, v in dp_batch(spec, 0).items()}
    loss, _, grads = make_grads_fn(bundle, compute_dtype=torch.float32,
                                   grad_accum=spec.get("accum", 1))(params, fz, batch)
    return {"loss": float(loss), "norm": float(opt.global_norm(grads, fz)),
            "grads": grad_arrays(grads)}


def tp_trainer(mesh, spec: dict, ckdir: str, steps: int) -> dict:
    """The Trainer over a rank's tensor-parallel ZeRO-1 step: `steps` steps
    committing every steps // 2 (rank 0 writes the gathered state); the
    rank's final params and moment shards (its arrays) and the gathered
    state's reference arrays."""
    from repro_torch.distributed.data_parallel import make_data_parallel_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.weights import reference_arrays

    local, params, opt, frozen, layout = tp_rank_state(mesh, spec)
    step = make_data_parallel_step(local, opt, layout, frozen_mask=frozen,
                                   compute_dtype=torch.float32)
    tr = Trainer(step_fn=step, batch_at=lambda i: dp_batch(spec, i),
                 cfg=TrainerConfig(total_steps=steps, ckpt_every=max(1, steps // 2), log_every=0,
                                   ckpt_dir=ckdir), mesh=mesh, layout=layout)
    params, state = tr.fit(params, layout.init_state(opt, params, frozen))
    return {"rank": (mesh.data_rank, mesh.model_rank),
            "own": layer_arrays({"params": params, "opt": state}),
            "whole": reference_arrays(layout.gather_state({"params": params, "opt": state}))}


def layer_arrays(tree) -> dict:
    """{reference path: [host array of each layer's leaf]} of a port-layout
    tree: a rank's shards, whose layers may differ in shape."""
    from repro_torch.weights import reference_leaves, tensor_to_numpy

    return {p: [tensor_to_numpy(t) for t in ls] for p, ls in reference_leaves(tree).items()}


def tp_scales(mesh, cases: list) -> list:
    """Each (role, per_column, int8_dot, table (C, K, M)) case: the rank's
    shard of the table (its M columns for "col", its C codebooks for
    "row"), fake-quantized with the shard's `reduce_absmax`, and its scale."""
    from repro_torch.core import quant
    from repro_torch.core.amm import LUTConfig, Mode
    from repro_torch.models import sharded
    from repro_torch.models.common import SiteCfg

    out = []
    for role, per_column, int8_dot, table in cases:
        t = torch.as_tensor(table)
        c, _, m = t.shape
        r, tp = mesh.model_rank, mesh.model
        part = (t[:, :, r * m // tp:(r + 1) * m // tp] if role == "col"
                else t[r * c // tp:(r + 1) * c // tp])
        lut = LUTConfig(k=t.shape[1], v=4, per_column=per_column, int8_dot=int8_dot)
        site = SiteCfg(d_in=4 * c, d_out=m, mode=Mode.LUT_TRAIN, lut=lut, tp=role)
        red = sharded._absmax_over_model(site, mesh)
        kw = dict(per_column=per_column, m_shared=int8_dot, reduce_absmax=red)
        out.append({"fq": quant.fake_quant(part.clone(), **kw),
                    "scale": quant.table_scale(part, **kw), "reduced": red is not None})
    return out


def tp_route_record(mesh, spec: dict) -> dict:
    """A no-gradient forward of the rank's shard on its rows of the first
    batch, recording each MoE layer's routing decisions (the dispatch of
    the rank's routing groups over all E experts) and its expert
    contraction: the slots its experts received (from every data rank),
    which experts received a token, their outputs, and their ids in the
    whole model (tests/test_torch_tp_train_families.py)."""
    from repro_torch.distributed.data_parallel import local_batch
    from repro_torch.models import moe

    local, params, _, _, layout = tp_rank_state(mesh, spec)
    rec: dict = {"dispatch": [], "experts": []}
    route, contract = moe.route, moe._contract

    def record_route(cfg, p, x):
        out = route(cfg, p, x)
        rec["dispatch"].append(out[2].clone())
        return out

    def record_contract(cfg, p, xin, sent):
        h = contract(cfg, p, xin, sent)
        first = (mesh.model_rank * cfg.ep_data + (mesh.data_rank if cfg.ep_data > 1 else 0)
                 ) * xin.shape[0] if cfg.ep > 1 else 0
        rec["experts"].append({"x": xin.clone(), "sent": sent.clone(), "h": h.clone(),
                               "ids": torch.arange(first, first + xin.shape[0])})
        return h

    moe.route, moe._contract = record_route, record_contract
    mesh.reset_counters()
    try:
        with torch.no_grad():
            local.train_logits(params, local_batch(dp_batch(spec, 0), mesh, layout.rules),
                               compute_dtype=torch.float32, mesh=mesh)
    finally:
        moe.route, moe._contract = route, contract
    rec["rank"] = (mesh.data_rank, mesh.model_rank)
    rec["axis_counters"] = {a: dict(c) for a, c in mesh.axis_counters.items()}
    return rec


# ---------------------------------------------------------------------------
# tensor-parallel serving of the enc-dec and the vision-LM
# (tests/test_torch_tp_encdec_vlm.py)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_MAX, SERVE_PAGE = 2, 32, 8


def serve_model(spec: dict):
    """(LUT_INFER bundle through the kernels' wrappers, the port's params from
    seed spec["seed"], on the CPU) of a small serving run `spec`."""
    import dataclasses

    from repro_torch.configs import build_model
    from repro_torch.core.amm import Mode

    bundle = build_model(dataclasses.replace(spec_arch(spec), lut_use_kernel=True),
                         Mode.LUT_INFER)
    return bundle, bundle.init(torch.Generator().manual_seed(spec["seed"]), device="cpu")


def serve_inputs(spec: dict) -> dict:
    """The prefill's inputs, numpy from a seed: a prompt's tokens and stub
    frames (B, enc_frames, D) for the enc-dec, else embedding rows."""
    import numpy as np

    arch = spec_arch(spec)
    rng = np.random.default_rng(spec["seed"] + 100)
    if arch.takes_embeds:
        return {"embeds": (rng.standard_normal((SERVE_B, 12, arch.d_model)) * 0.5
                           ).astype(np.float32)}
    return {"prompt": rng.integers(0, arch.vocab, (SERVE_B, 6)).astype(np.int32),
            "frames": rng.standard_normal((SERVE_B, arch.enc_frames, arch.d_model)
                                          ).astype(np.float32)}


def greedy_serve(step, bundle, inputs: dict, table: torch.Tensor, steps: int, *,
                 paged: bool = False) -> dict:
    """`inputs`' prefill (with frames, or embeddings) then `steps` greedy
    decode steps through `step(batch, caches) -> (logits, caches)`, on
    `bundle`'s fresh caches (dense, or paged in pages of SERVE_PAGE); a
    model that takes embeddings is fed its tokens' rows of the whole
    `table`. Returns each forward's logits and the tokens (B, 1 + steps)."""
    from repro_torch.models.attention import PagedSpec

    n_tables = SERVE_MAX // SERVE_PAGE
    caches = bundle.init_caches(SERVE_B, SERVE_MAX, dtype=torch.float32, device="cpu",
                                paged=PagedSpec(n_pages=SERVE_B * n_tables + 1,
                                                page_size=SERVE_PAGE) if paged else None)
    batch = {"cache_len": torch.zeros(SERVE_B, dtype=torch.long)}
    if "embeds" in inputs:
        batch["embeds"] = torch.as_tensor(inputs["embeds"])
    else:
        batch.update(tokens=torch.as_tensor(inputs["prompt"]),
                     frames=torch.as_tensor(inputs["frames"]))
    tables = ({"block_tables": torch.arange(1, 1 + SERVE_B * n_tables).view(SERVE_B, n_tables)}
              if paged else {})
    out: dict = {"logits": [], "tokens": []}
    with torch.no_grad():
        for _ in range(1 + steps):
            logits, caches = step({**batch, **tables}, caches)
            nxt = logits[:, -1].argmax(-1)
            out["logits"].append(logits.clone())
            out["tokens"].append(nxt)
            cl = batch["cache_len"] + logits.shape[1]
            batch = ({"cache_len": cl, "embeds": table[nxt][:, None]} if "embeds" in inputs
                     else {"cache_len": cl, "tokens": nxt[:, None].to(torch.int32)})
    out["tokens"] = torch.stack(out["tokens"], 1)
    return out


def tp_serve_family(mesh, spec: dict, steps: int) -> dict:
    """On a rank of the mesh's model axis (each data row serves alone):
    `serve_model(spec)`'s shard (`place` by `ShardingRules(model=tp)`)
    through `ModelBundle.forward_step(mesh=)` on dense and paged caches,
    and through `make_serve_step(mesh=)` on dense ones (`greedy_serve`);
    each row-parallel LUT site call of the dense run against the unsharded
    site on the gathered input and tables (bytewise, and where its codes
    are the ranks' concatenation); the layout's kept differences and the
    rank's cross K/V cache shape."""
    import dataclasses

    from repro_torch.configs import cache_leaves
    from repro_torch.core.amm import Mode
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.distributed.tensor_parallel import place
    from repro_torch.kernels import ref
    from repro_torch.models import common, sharded
    from repro_torch.train.train_step import make_serve_step

    bundle, params = serve_model(spec)
    local, lp, lay = place(bundle, params, ShardingRules(model=mesh.model), mesh)
    inputs, table = serve_inputs(spec), params["embed"]["table"]
    rows, real = [], sharded.linear

    def linear(site, p, x):
        y = real(site, p, x)
        if site.tp == "row" and site.mode == Mode.LUT_INFER:
            rows.append((site, p, x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])))
        return y

    def fwd(b, c):
        return local.forward_step(lp, b, c, mesh=mesh)

    sharded.linear = linear
    try:
        dense = greedy_serve(fwd, local, inputs, table, steps)
    finally:
        sharded.linear = real
    paged = greedy_serve(fwd, local, inputs, table, steps, paged=True)
    serve_step = make_serve_step(local, compute_dtype=torch.float32, mesh=mesh)
    served = greedy_serve(lambda b, c: serve_step(lp, b, c), local, inputs, table, steps)
    held = {"calls": 0, "bytewise": 0, "codes_off": 0}
    for site, p, x, y in rows:
        whole = {k: (mesh.gather_dim(v.to(torch.int32 if k == "table_q" else v.dtype)
                                     .contiguous(), 0, "model").to(v.dtype)
                     if k in ("centroids", "table_q") else v) for k, v in p.items()}
        x_full = mesh.gather_last(x.contiguous(), "model")
        want = common.linear(dataclasses.replace(site, tp=None, d_in=site.d_in * mesh.model),
                             whole, x_full)
        codes = ref.encode_plain(x_full, whole["centroids"])
        ranks = mesh.gather_last(ref.encode_plain(x, p["centroids"]).float().contiguous(),
                                 "model").int()
        same = (codes == ranks).all(dim=1)
        held["calls"] += 1
        held["codes_off"] += int((~same).sum())
        held["bytewise"] += bool(torch.equal(y[same], want[same].to(y.dtype)))
    k = next(t for n, t in cache_leaves(local.init_caches(1, 8, device="cpu")) if n == "k")
    return {"rank": (mesh.data_rank, mesh.model_rank), "dense": dense, "paged": paged,
            "serve_step_bytewise": all(torch.equal(a, b) for a, b in
                                       zip(dense["logits"], served["logits"])),
            "rows": held, "kept": lay.kept, "vocab": lay.vocab,
            "cross_k": tuple(local.init_caches(1, 8, device="cpu")["cross"]["k"].shape)
            if local.kind == "encdec" else None, "k": tuple(k.shape),
            "counters": dict(mesh.axis_counters["model"])}


def tp_jobs(mesh, jobs: list) -> list:
    """Run each (function name, args) of this module on the rank, in order."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def tp_elastic_jobs(rank: int, init: str, n: int, prefer_model: int, jobs: list) -> list:
    """`tp_jobs` on the mesh an `ElasticContext` builds from `n` CPU devices
    with `prefer_model`, then its (data, model) shape and rules."""
    from repro_torch.distributed.elastic import ElasticContext

    ctx = ElasticContext.build(["cpu"] * n, lambda mesh, rules: None, prefer_model=prefer_model,
                               rank=rank, init_method=init)
    try:
        return tp_jobs(ctx.mesh, jobs) + [{"mesh": (ctx.mesh.data, ctx.mesh.model),
                                           "rules": (ctx.rules.data, ctx.rules.model)}]
    finally:
        ctx.mesh.close()
