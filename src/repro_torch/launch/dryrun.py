"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta
device, with no card.

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
on 512 forced host devices. Here rank (0, 0) of the production mesh
(`launch.mesh.make_production_mesh`: (16, 16), or (2, 16, 16) multi-pod)
holds meta tensors of its shards (the layout `distributed.tensor_parallel`
gives it and, training, the `Zero1` / FSDP plan of its moments), which are
never drawn, and runs the port's step once under `roofline.op_cost.
OpCostMode`: a train cell `make_data_parallel_step` (the port's
`make_train_step` on a mesh; `make_train_step` itself on a mesh of one
rank), a serve cell `make_serve_step(mesh=)` on its data rank's rows and
caches. The mesh (a `DryMesh`) counts the collectives instead of running
them. The record carries the reference's keys (`compile_s` becomes
`trace_s`): per-device operations, HBM bytes, collective wire bytes per
kind and per axis at the H100's links, memory and the bottleneck; and the
`Layout.kept` names where the port's layout departs from the spec.

Kept differences: a serving cell's LUT sites run the port's kernels
(`lut_use_kernel`), charged by `roofline.analysis.lut_site_cost` for the
version the autotuner picks on the card, where the reference lowers its
XLA one-hot contraction; an MoE layer on meta counts every expert active
(`models/moe.py`), the work of the reference's GShard einsum; serving takes
no FSDP cut (the port serves a model shard whole over "data").

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--mode ...]
Results are written to results/dryrun_torch/<cell>.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import traceback
from typing import Any

import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    build_model,
    get_arch,
    input_specs,
    shape_applicable,
)
from repro_torch.core.amm import Mode
from repro_torch.distributed.data_parallel import Zero1, local_batch, make_data_parallel_step
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.distributed.tensor_parallel import place
from repro_torch.launch.mesh import DryMesh, make_production_mesh
from repro_torch.optim import SOFT_PQ_RULES, AdamW, lut_frozen_mask
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.roofline.analysis import analyze_trace, memory_stats
from repro_torch.roofline.op_cost import Trace, trace_step, tree_bytes
from repro_torch.train.train_step import make_serve_step, make_train_step
from repro_torch.weights import layer_specs, tree_map_ref

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def meta_params(bundle) -> Any:
    """Empty meta leaves of the bundle's params in the port's layout."""
    return tree_map_ref(lambda _p, s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                        layer_specs(bundle))


def _global_counts(bundle) -> tuple[int, int]:
    """(params, bytes) of the whole model, from the reference's param tree."""
    n = b = 0
    for s in _spec_leaves(bundle.param_specs()):
        k = math.prod(s.shape)
        n += k
        b += k * s.dtype.itemsize
    return n, b


def _spec_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif type(tree) in (list, tuple):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


def trace_cell(arch_name: str, shape: str | ShapeSpec, *, multi_pod: bool = False,
               mode: str | None = None, fsdp: bool | None = None, remat: bool | None = None,
               arch_overrides: dict | None = None, row_parallel: bool = True,
               mesh: DryMesh | None = None) -> tuple[dict, Trace | None]:
    """Trace one cell; returns (record, trace), or ({"skipped": why}, None)
    for a cell the reference skips. `shape` is a `SHAPES` name or a
    `ShapeSpec` of another size; `mesh` replaces the production mesh (a
    `launch.mesh.dry_mesh` of any size)."""
    if not row_parallel:
        raise ValueError("the port's tensor-parallel layout runs column/row site pairs "
                         "(distributed.tensor_parallel.layout): row_parallel=False has no "
                         "layout")
    # the LUT sites serve through the port's kernels unless overridden
    arch = dataclasses.replace(get_arch(arch_name), lut_use_kernel=True,
                               **(arch_overrides or {}))
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(arch, sp.name)
    if not ok:
        return {"arch": arch_name, "shape": sp.name, "skipped": why}, None

    train = sp.kind == "train"
    mode = Mode(mode) if mode is not None else (Mode.LUT_TRAIN if train else Mode.LUT_INFER)
    bundle = build_model(arch, mode)
    if remat is not None and bundle.kind == "lm":
        bundle = dataclasses.replace(bundle, cfg=dataclasses.replace(bundle.cfg, remat=remat))
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    use_fsdp = bool(fsdp)
    rules = ShardingRules.for_mesh(mesh, fsdp=use_fsdp and train)
    n_params, param_bytes = _global_counts(bundle)
    whole = meta_params(bundle)

    kept: tuple[str, ...] = ()
    if rules.model > 1 or rules.fsdp:
        local, params, lay = place(bundle, whole, rules, mesh, train=train)
        kept = lay.kept
    else:
        local, params, lay = bundle, whole, None
    del whole
    if use_fsdp and not train:
        kept += ("serve_without_fsdp",)
    batch = input_specs(arch, sp)

    if train:
        opt = AdamW(lr=cosine_with_warmup(1e-3, total_steps=10_000, warmup_steps=200),
                    rules=SOFT_PQ_RULES,
                    state_dtype=(torch.bfloat16 if arch.param_dtype == "bfloat16"
                                 else torch.float32))
        frozen = lut_frozen_mask(params) if mode == Mode.LUT_TRAIN else None
        if mesh.world > 1:
            zero1 = Zero1.build(mesh, params, frozen, rules, tp=lay)
            opt_state = zero1.init_state(opt, params, frozen)
            step_fn = make_data_parallel_step(local, opt, zero1, frozen_mask=frozen,
                                              grad_accum=arch.grad_accum)
        else:
            opt_state = opt.init(params, frozen)
            step_fn = make_train_step(local, opt, frozen_mask=frozen,
                                      grad_accum=arch.grad_accum)
        per_device = {"param_bytes": tree_bytes(params), "opt_bytes": tree_bytes(opt_state),
                      "batch_bytes": tree_bytes(batch)}
        _, trace = trace_step(step_fn, params, opt_state, batch, mesh=mesh,
                              donated=lambda out: (out[0], out[1].m, out[1].v))
    else:
        batch = local_batch(batch, mesh, rules)
        cache_b = next(iter(batch.values())).shape[0]
        caches = local.init_caches(cache_b, sp.seq_len, dtype=getattr(torch, arch.kv_cache_dtype),
                                   device="meta")
        step_fn = make_serve_step(local, mesh=mesh if rules.model > 1 else None)
        per_device = {"param_bytes": tree_bytes(params), "cache_bytes": tree_bytes(caches),
                      "batch_bytes": tree_bytes(batch)}
        _, trace = trace_step(step_fn, params, batch, caches, mesh=mesh)

    roof = analyze_trace(trace)
    rec = {
        "arch": arch_name,
        "shape": sp.name,
        "mode": mode.value,
        "mesh": list(mesh.grid),
        "mesh_axes": list(mesh.axis_names),
        "multi_pod": multi_pod,
        "fsdp": use_fsdp,
        "n_params": n_params,
        "param_bytes_global": param_bytes,
        "trace_s": trace.trace_s,
        "memory": memory_stats(trace),
        "roofline": roof.as_dict(),
        "tokens_per_step": sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1),
        "t_bound_s": roof.t_bound,
        "per_device": per_device,
        "lut_sites_charged": len(trace.sites),
        "n_ops": trace.n_ops,
        "kept": list(kept),
    }
    return rec, trace


def run_cell(arch_name: str, shape: str, **kw) -> dict:
    tag = kw.pop("tag", "")
    rec, _ = trace_cell(arch_name, shape, **kw)
    RESULTS.mkdir(parents=True, exist_ok=True)
    suffix = "mp" if kw.get("multi_pod") else "sp"
    name = f"{arch_name}__{shape}__{suffix}" + (f"__{tag}" if tag else "")
    (RESULTS / f"{name}.json").write_text(json.dumps(rec, indent=2))
    return rec


def ok_line(rec: dict) -> str:
    """The sweep's `[ok]` line of a record."""
    r = rec["roofline"]
    return (f"[ok] {rec['arch']} x {rec['shape']} ({rec['mode']}, mesh={rec['mesh']}) "
            f"trace={rec['trace_s']:.1f}s "
            f"mem/dev={rec['memory']['total_hbm_bytes'] / 2**30:.2f}GiB "
            f"t_comp={r['t_compute_s']:.4f}s t_mem={r['t_memory_s']:.4f}s "
            f"t_coll={r['t_collective_s']:.4f}s -> {r['bottleneck']}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", choices=[m.value for m in Mode], default=None)
    ap.add_argument("--fsdp", type=int, default=None)
    args = ap.parse_args(argv)

    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch_name, shape in cells:
        try:
            rec = run_cell(arch_name, shape, multi_pod=args.multi_pod, mode=args.mode,
                           fsdp=None if args.fsdp is None else bool(args.fsdp))
            if rec.get("skipped"):
                print(f"[skip] {arch_name} x {shape}: {rec['skipped']}", flush=True)
                continue
            print(ok_line(rec), flush=True)
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failures.append((arch_name, shape, repr(e)))
            print(f"[FAIL] {arch_name} x {shape}: {e!r}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {[(a, s) for a, s, _ in failures]}")


if __name__ == "__main__":
    main()
