"""Rank processes of the port's tensor-parallel tests (spawned; imports no JAX).
The ranks run on the CPU (tests/test_torch_tp.py) or share one card
(tests/test_torch_cuda.py).

`run_ranks(fn, tp, *args)` spawns `tp` ranks that join a gloo mesh on the
CPU and call `fn(mesh, *args)`; it returns their results in rank order,
tensors as numpy arrays.
`serve_variant` (`serve_variants`) is the ranks' work in tests/test_torch_tp.py: the same
requests through the unsharded engine (rank 0) and through the dense, paged
and artifact tensor-parallel engines, every linear site's output and every
forward's logits recorded on each rank. The dense and paged engines are
built here from the whole param tree; the artifact engine is the
launcher's (`launch.serve.serve_on_mesh`), each rank reading only its
shards.
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


def _rank_main(rank, devices, init, fn, args, q):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh

    try:
        mesh = make_host_mesh(data=1, model=len(devices), rank=rank, devices=devices,
                              init_method=init, timeout_s=300)
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


def start_ranks(fn, tp: int, *args, devices: list[str] | None = None):
    """Spawn the ranks (on the CPU unless `devices` names each rank's);
    `collect` the handle for their results."""
    devices = devices or ["cpu"] * tp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, devices, init, fn, args, q))
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
              timeout: float = 300) -> list:
    return collect(start_ranks(fn, tp, *args, devices=devices), timeout)


@contextlib.contextmanager
def recording():
    """Record (site name, mode, tp role, output) of every attention and MLP
    site call, and the logits and write lengths (the valid positions of
    each row) of every forward, in call order."""
    from repro_torch.configs import ModelBundle
    from repro_torch.models import attention, mlp

    sites, logits = [], []
    orig = attention.linear, ModelBundle.forward_step

    def linear(site, p, x):
        y = orig[0](site, p, x)
        role = site.tp or ""
        sites.append((site.name, site.mode.value, role, y.detach().cpu()))
        return y

    def forward_step(self, params, batch, caches, **kw):
        out = orig[1](self, params, batch, caches, **kw)
        logits.append((out[0].detach().cpu(), batch["write_len"].clone()))
        return out

    attention.linear = mlp.linear = linear
    ModelBundle.forward_step = forward_step
    try:
        yield sites, logits
    finally:
        attention.linear = mlp.linear = orig[0]
        ModelBundle.forward_step = orig[1]


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
