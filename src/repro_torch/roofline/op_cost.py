"""The cost of every aten op a step dispatches, counted as it runs on the
`meta` device (no allocation, no kernel).

Counterpart of `repro.roofline.hlo_cost`, which walks XLA's optimized HLO.
Here a `TorchDispatchMode` sees each aten op the step runs (forward,
backward, activation recomputation and optimizer alike, so no loop needs a
trip count) and charges it:

  * mm, addmm, bmm, baddbmm and convolution exactly 2 * prod(out) *
    prod(contracted dims), at the unit of their dtype (bf16/fp16 on the
    tensor cores, fp32 outside them, integers on the int8 path);
  * elementwise ops and reductions 1 flop per element (per input element
    for a reduction: the larger of the input and the output), in fp32;
  * views, metadata, aliasing ops and uninitialized allocations nothing;
  * HBM bytes: every other op's operands plus outputs on the device. In
    eager mode each aten op is its own kernel, so this is the eager
    analogue of hlo_cost's fusion boundaries. It reads higher than XLA's
    fused count (a kept difference; what a later fusion should move).
    As in hlo_cost, a gather (index, index_select, gather, embedding)
    touches only its rows (2 x output bytes) and a scatter (index_put,
    index_copy, ...) only its updates (2 x update bytes): the destination
    is written in place; a copy_ reads its source and writes its
    destination;
  * a LUT site (`kernels/ops.py` on meta tensors) by its kernel's count,
    `analysis.lut_site_cost`, through `charge_site`.

Ops whose tensors all lie on the CPU are the host's (the cache-write plan,
the step counter) and cost the device nothing. The peak of live bytes
counts each storage the trace creates on the device once, from its first
output to its free (a weak reference on the storage says when).

`trace_step` runs a step under the mode and returns a `Trace`, whose
arguments, outputs and aliases feed `analysis.memory_stats`; `hotspots`
groups the ops by the model functions that ran them, as the reference's
groups them by computation.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch.roofline.analysis import HBM_BW, UNIT_RATES, SiteCost

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "convolution", "_int_mm"}
# allocations that write nothing, and ops that only read metadata or alias
_FREE = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
         "detach", "_unsafe_view", "lift_fresh", "alias", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "resize_", "set_"}
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
# scatters: the argument position of their update
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "index_copy": 3,
            "index_copy_": 3, "index_add": 3, "index_add_": 3, "scatter": 3, "scatter_": 3,
            "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3}
# fills: they write their output and read nothing
_FILL = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
         "new_ones", "new_full", "fill", "fill_", "zero_", "arange", "scalar_tensor", "eye"}
# frames of these modules are the tracer's own, not the model's
_OWN = ("repro_torch.roofline", "repro_torch.launch.dryrun", "repro_torch.launch.mesh")


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    """Bytes of the distinct tensors of a tree (each numel x element size)."""
    seen: dict[int, int] = {}
    for t in _tensors(tree):
        seen[id(t)] = _nbytes(t)
    return sum(seen.values())


def _unit(t: torch.Tensor) -> str:
    if t.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if t.dtype.is_floating_point:
        return "fp32"
    return "int8"


def _model_path() -> str:
    """The port's functions on the stack, outermost first, from the first
    one in `repro_torch.models` when the op runs inside the model."""
    names: list[str] = []
    models = None
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and not mod.startswith(_OWN):
            names.append(f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}")
            if mod.startswith("repro_torch.models."):
                models = len(names)
        f = f.f_back
    if models is not None:
        names = names[:models]
    return "/".join(reversed(names))


@dataclasses.dataclass
class Trace:
    """What one traced step costs a device: operations by unit, HBM bytes,
    collective wire bytes by ring kind and by axis with each axis' link, the
    argument, output, alias and peak live bytes, the LUT sites charged,
    per model path its operations by unit, bytes and ops, and per aten op
    (or LUT kernel) its operations."""

    flops: dict[str, float]
    hbm_bytes: float
    coll_by_kind: dict[str, float]
    coll_by_axis: dict[str, float]
    link_by_axis: dict[str, float]
    arg_bytes: int
    out_bytes: int
    alias_bytes: int
    peak_bytes: int
    sites: list[dict]
    by_path: dict[str, dict]
    by_op: dict[str, float]
    n_ops: int
    trace_s: float = 0.0


class OpCostMode(TorchDispatchMode):
    """Charges every aten op dispatched while active (module docstring) on
    meta tensors; `charge_site` charges a LUT kernel call."""

    def __init__(self):
        super().__init__()
        self.flops = {u: 0.0 for u in UNIT_RATES}
        self.hbm_bytes = 0.0
        self.by_path: dict[str, dict] = {}
        self.by_op: dict[str, float] = {}
        self.sites: list[dict] = []
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._live: set[int] = set()

    # ------------------------------------------------------------------
    def _add(self, op: str, flops: dict[str, float], nbytes: float) -> None:
        node = torch._C._current_autograd_node()
        path = _model_path()
        if node is not None:
            path = f"backward/{path or node.name()}"
        rec = self.by_path.setdefault(path or "<step>", {"flops": {}, "bytes": 0.0, "ops": 0})
        for unit, f in flops.items():
            self.flops[unit] += f
            rec["flops"][unit] = rec["flops"].get(unit, 0.0) + f
        self.by_op[op] = self.by_op.get(op, 0.0) + sum(flops.values())
        self.hbm_bytes += nbytes
        rec["bytes"] += nbytes
        rec["ops"] += 1

    def _track(self, outs: list[torch.Tensor]) -> None:
        """Count each new device storage among `outs` live until it is freed."""
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self._live:
                continue
            self._live.add(key)
            n = s.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live -= n

    def track_args(self, tree: Any) -> None:
        """Mark the storages of `tree` (the step's arguments) as not the
        trace's own: they never count toward its live bytes."""
        for t in _tensors(tree):
            self._live.add(id(t.untyped_storage()))

    def charge_site(self, cost: SiteCost, kernel: str, shape: tuple[int, ...]) -> None:
        """Charge one LUT kernel call (`kernels/ops.py` on meta tensors):
        its bytes, the encode's fp32 flops and the lookup at its unit."""
        self.n_ops += 1
        flops = {"fp32": float(cost.encode_flops)}
        flops[cost.lookup_unit] = flops.get(cost.lookup_unit, 0.0) + cost.lookup_ops
        self._add(kernel, flops, cost.bytes)
        self.sites.append({"kernel": kernel, "shape": shape, "cost": cost})

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in _tensors((args, kwargs)) if t.is_meta]
        outs = [t for t in _tensors(out) if t.is_meta]
        if not ins and not outs:
            return out                       # host work
        self.n_ops += 1
        self._track(outs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        out_numel = sum(t.numel() for t in outs)
        out_bytes = sum(_nbytes(t) for t in outs)
        if name in _MATMUL:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            contracted = (args[1].shape[1:].numel() if name == "convolution"
                          else a.shape[-1])
            self._add(name, {_unit(a): 2.0 * out_numel * contracted},
                      sum(_nbytes(t) for t in ins) + out_bytes)
        elif name in _GATHER:
            self._add(name, {"fp32": out_numel}, 2.0 * out_bytes)
        elif name in _SCATTER:
            pos = _SCATTER[name]
            upd = args[pos] if len(args) > pos and isinstance(args[pos], torch.Tensor) else None
            n = upd.numel() if upd is not None else out_numel
            self._add(name, {"fp32": n}, 2.0 * (_nbytes(upd) if upd is not None else out_bytes))
        elif name in _FILL:
            self._add(name, {}, out_bytes)
        elif name == "copy_":                # writes its destination, reads the source
            self._add(name, {"fp32": out_numel}, sum(_nbytes(t) for t in ins[1:]) + out_bytes)
        else:
            self._add(name, {"fp32": max([out_numel] + [t.numel() for t in ins])},
                      sum(_nbytes(t) for t in ins) + out_bytes)
        return out


def active() -> OpCostMode | None:
    """The innermost active `OpCostMode`, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCostMode):
            return mode
    return None


def trace_step(fn: Callable, *args: Any, mesh=None,
               donated: Callable[[Any], Any] | None = None) -> tuple[Any, Trace]:
    """Run `fn(*args)` on meta tensors under an `OpCostMode`; returns (its
    outputs, their `Trace`). `mesh` (a `launch.mesh.DryMesh`) gives the
    collectives' wire bytes; `donated(outputs)` picks the outputs that take
    a donated argument's place (a train step's new params and moments),
    counted as aliases with the outputs written into an argument's
    storage."""
    import time

    arg_storages = {id(t.untyped_storage()) for t in _tensors(args)}
    if mesh is not None:
        mesh.reset_counters()
    t0 = time.perf_counter()
    with OpCostMode() as mode:
        mode.track_args(args)
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    out_t = {id(t): t for t in _tensors(out)}
    aliased = {i for i, t in out_t.items() if id(t.untyped_storage()) in arg_storages}
    if donated is not None:
        aliased |= {id(t) for t in _tensors(donated(out))}
    wire = mesh.wire_summary() if mesh is not None else ({}, {}, {})
    return out, Trace(
        flops={u: f for u, f in mode.flops.items() if f}, hbm_bytes=mode.hbm_bytes,
        coll_by_kind=wire[0], coll_by_axis=wire[1], link_by_axis=wire[2],
        arg_bytes=tree_bytes(args), out_bytes=sum(_nbytes(t) for t in out_t.values()),
        alias_bytes=sum(_nbytes(t) for i, t in out_t.items() if i in aliased),
        peak_bytes=mode.peak, sites=mode.sites, by_path=mode.by_path, by_op=mode.by_op,
        n_ops=mode.n_ops,
        trace_s=trace_s)


def hotspots(trace: Trace, *, top: int = 25, depth: int = 4) -> list[tuple[str, dict]]:
    """The costliest model paths of a trace, each cut to its first `depth`
    functions: [(path, {"flops", "hbm_bytes", "t_s", "ops"})], ranked by
    their time at the units' rates plus their bytes over HBM_BW."""
    sums: dict[str, dict] = {}
    for path, rec in trace.by_path.items():
        head = path.split("/")
        key = "/".join(head[:depth + (head[0] == "backward")])
        agg = sums.setdefault(key, {"flops": 0.0, "hbm_bytes": 0.0, "t_s": 0.0, "ops": 0})
        agg["flops"] += sum(rec["flops"].values())
        agg["hbm_bytes"] += rec["bytes"]
        agg["t_s"] += (sum(f / UNIT_RATES[u] for u, f in rec["flops"].items())
                       + rec["bytes"] / HBM_BW)
        agg["ops"] += rec["ops"]
    return sorted(sums.items(), key=lambda kv: -kv[1]["t_s"])[:top]
