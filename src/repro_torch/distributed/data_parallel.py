"""The data-parallel train step with ZeRO-1 optimizer moments, on a data
mesh or, with a rank's tensor-parallel shard, on a ("data", "model") mesh.

Counterpart of the reference's sharded step, `jax.jit(make_train_step(...),
in_shardings=(params, opt_shardings, batch_shardings))` on a mesh
(tests/test_sharded.py), which GSPMD partitions; here the partition is
written out. On each rank:

  1. take the rank's rows of the global batch (`local_batch`: dim 0 by
     `ShardingRules.batch_dim`, M-RoPE's pos on its second axis; with
     gradient accumulation the rank's rows of each microbatch, so that its
     k-th microbatch is its part of the global k-th; where the batch does
     not divide, every rank takes all of it, as a replicated spec would);
  2. compute the gradients as the single-rank step does (`train_step.
     make_grads_fn`: frozen leaves, grad_accum), on a model mesh through the
     rank's shard of the forward and the vocab-parallel loss
     (`ModelBundle.loss(mesh=)`); sum the replicated leaves, and the
     replicated blocks of leaves, that hold only the shard's part of their
     gradient over "model" (`tensor_parallel.Layout.partial`, one bucket),
     then mean-reduce every gradient in fp32 over "data", all leaves in one
     bucket, but for the expert leaves split over "data" too, each rank's
     own experts' (`Layout.over_data`): their gradient already sums every
     data rank's tokens (the all-to-all's backward), and is scaled by 1 / dp
     instead (`make_sharded_grads_fn`);
  3. take the global norm of the reduced gradients: on a model mesh the
     sum of squares of the leaves split over "model" is summed over it (of
     the expert leaves, over both axes), and each replicated leaf or block
     counted once (`Zero1.global_norm`);
  4. update only the rank's ZeRO-1 shard of `m`, `v` and the matching slice
     of each param (`ShardingRules.opt_spec`'s "data" dim, taken inside the
     rank's model shard: `Zero1`), with that norm (`AdamW.update(gnorm=)`),
     then all-gather the param slices over "data", so that every rank of a
     model shard holds the same params.

An expert leaf split over both axes holds no ZeRO-1 cut: the spec's
"data" dim of its moments is the experts' own, which the rank already
holds alone. The port keeps a layer stack as a list of per-layer leaves. Where the
spec's "data" dim is the stack's layer axis, a rank holds whole layers of
that leaf (the others' placeholders are empty) and the layer's owner
broadcasts it; elsewhere a rank holds a contiguous slice of every layer.
`Zero1.gather_state` gathers a train state into the reference's layout for
a checkpoint (the ZeRO-1 shards over "data", then the model shards over
"model"; rank 0 writes it: `train/trainer.py`), and `Zero1.cuts` tells
`Checkpointer.restore(shardings=)` which part of each whole leaf a rank
reads (its model shard, then its data shard).

FSDP (`ShardingRules(fsdp=True)`, the reference's ZeRO-3 style rules) runs
on the same class. A rank holds only its part of each param that
`param_spec(fsdp=True)` splits over "data" too (the embedding, every 2-D
`w`, a frozen one included), inside its model shard: `tensor_parallel.
place` and `init_rank` cut it (`Layout.fsdp`), on a data mesh too (a
layout with no model axis). The forward gathers a block's data-split
leaves inside the block's recomputed function and reduce-scatters their
gradient in its backward (`models/sharded.py`, `gather_data`), so that in
step 2 those leaves take no part in the data all-mean; the norm of step 3
sums their squares over "data" (and over "model" where they are split
there too); step 4 updates each leaf's part and its moments of the same
shape (`opt_spec` adds no ZeRO-1 cut under fsdp), and no all-gather
follows. `gather_state` gathers the params over "data" as well, and
`cuts` gives each param its data part, so that a commit is the reference's
layout with fsdp on or off, and restores under either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardingRules, is_stacked
from repro_torch.models import sharded
from repro_torch.optim import AdamW, AdamWState, no_frozen
from repro_torch.weights import flat_vector, reference_leaves, tree_map_ref, unflatten_vector

def local_batch(batch: dict[str, torch.Tensor], mesh, rules: ShardingRules | None = None,
                accum: int = 1) -> dict[str, torch.Tensor]:
    """The rows of the global `batch` that `mesh`'s data rank takes, by
    `rules.batch_shardings` (the mesh's own rules by default). With `accum`
    microbatches (`make_grads_fn`'s contiguous splits) that divide over the
    ranks, the rank's rows of each microbatch in turn: its k-th microbatch
    is then its part of the global batch's k-th, so that a value taken
    over a whole microbatch (the MoE's load-balance fractions, averaged
    over "data") is the single rank's."""
    rules = rules or ShardingRules.for_mesh(mesh)
    n, r = rules.data, mesh.data_rank
    out = {}
    for k, spec in rules.batch_shardings(batch).items():
        v = batch[k]
        if "data" in spec:
            d = spec.index("data")
            size = v.shape[d] // n
            if accum > 1 and v.shape[d] % (n * accum) == 0:
                mb = v.shape[d] // accum
                v = torch.cat([v.narrow(d, i * mb + r * (mb // n), mb // n)
                               for i in range(accum)], d)
            else:
                v = v.narrow(d, r * size, size)
        out[k] = v
    return out


class Cut(NamedTuple):
    """The part of one port-layout leaf a rank holds: of a tensor-parallel
    shard, [start, stop) of `model`'s dim (`model` = (dim, start, stop),
    None: the whole leaf; with `blocks`, `model` = (dim, model rank, tp)
    and the shard the rank's part of each split block and every unsplit
    block whole, `tensor_parallel.cut`; with `experts`, [start, stop) is
    the rank's part over both axes, gathered over "data" and then
    "model"); of that, the data part: all of it (`dim` None), [start,
    stop) along `dim`, or, for a layer owned by one rank (`owner`), the
    whole layer where `held`, else nothing."""

    dim: int | None = None
    start: int = 0
    stop: int = 0
    owner: int | None = None
    held: bool = True
    model: tuple[int, int, int] | None = None
    blocks: tuple[tuple[int, bool], ...] | None = None
    experts: bool = False

    def part(self, a):
        """The data part of the rank's model shard `a` (a tensor or a numpy
        array); an empty (0,) one where nothing is held."""
        if not self.held:
            return a.reshape(-1)[:0]
        if self.dim is None:
            return a
        idx = [slice(None)] * a.ndim
        idx[self.dim] = slice(self.start, self.stop)
        return a[tuple(idx)]

    def apply(self, a):
        """The rank's part of the whole leaf `a`: its model shard, then the
        data part of that. A frozen leaf's empty (0,) moment stays empty."""
        if self.model is not None and tuple(a.shape) != (0,):
            d = self.model[0]
            if self.blocks is None:
                ranges = [self.model[1:]]
            else:
                (_, rank, tp), ranges, at = self.model, [], 0
                for n, split in self.blocks:
                    ranges.append((at + rank * (n // tp), at + (rank + 1) * (n // tp)) if split
                                  else (at, at + n))
                    at += n
            parts = []
            for lo, hi in ranges:
                idx = [slice(None)] * a.ndim
                idx[d] = slice(lo, hi)
                parts.append(a[tuple(idx)])
            a = parts[0] if len(parts) == 1 else (
                torch.cat(parts, d) if isinstance(a, torch.Tensor) else np.concatenate(parts, d))
        return self.part(a)


WHOLE = Cut()


@dataclasses.dataclass
class Zero1:
    """One rank's ZeRO-1 or FSDP layout (the one class carries both:
    `rules.fsdp`, the `fsdp` property, says which) of the params `like`
    (port layout, the rank's tensor-parallel shard on a model mesh,
    under FSDP its part of that; only shapes are read) on `mesh`: `plan` is
    the `Cut` of every leaf's moments, by `rules.opt_spec` of its reference
    path and whole stacked shape, taken inside the rank's model shard (`tp`,
    a `tensor_parallel.Layout(train=True)`), and `params_plan` the `Cut` of
    every param: its model shard, and under FSDP its data part of that
    (`tp.fsdp`). Frozen leaves' moments are empty, and frozen leaves are
    never updated. `sharded` marks the leaves split over "model", `experts`
    those split over "data" too, `split` (from `params_plan`) those an FSDP
    rank holds its data part of, and `partial` what of each leaf the step
    sums over "model":
    False (nothing), True (the whole leaf) or (dim, ((start, stop), ...))
    its replicated blocks."""

    mesh: Any
    rules: ShardingRules
    plan: Any
    tp: Any = None
    sharded: Any = None
    partial: Any = None
    experts: Any = None
    params_plan: Any = None

    @classmethod
    def build(cls, mesh, like: Any, frozen: Any | None = None,
              rules: ShardingRules | None = None, tp: Any = None) -> "Zero1":
        rules = rules or ShardingRules.for_mesh(mesh)
        if rules.fsdp and (tp is None or not tp.train or tp.tp != rules.model):
            raise ValueError("FSDP trains a rank's parts: pass tp=, the layout of "
                             "tensor_parallel.place(..., train=True) or init_rank (a data "
                             "mesh's too)")
        if rules.model > 1 and (tp is None or not tp.train or tp.tp != rules.model):
            raise ValueError("a mesh with model > 1 trains a rank's tensor-parallel shard: "
                             "pass tp=, the layout of tensor_parallel.place(..., train=True)")
        frozen = frozen if frozen is not None else no_frozen(like)
        counts = {p: len(leaves) for p, leaves in reference_leaves(like).items()}
        seen: dict[str, int] = {}
        n, rank = rules.data, mesh.data_rank
        m_rank = 0 if tp is None else mesh.model_rank
        cuts = {} if tp is None else tp.cuts
        fsdp = {} if tp is None else tp.fsdp

        def cut(path: str, leaf, fz: bool, of_params: bool) -> Cut:
            model, full, extra = None, list(leaf.shape), {}
            if path in cuts:
                d, blocks = cuts[path]
                size = leaf.shape[d]
                if blocks is not None:
                    full[d] = sum(n for n, _ in blocks)
                    model, extra = (d, m_rank, tp.tp), {"blocks": blocks}
                elif path in tp.over_data:
                    j = m_rank * tp.data + rank
                    full[d] = size * tp.tp * tp.data
                    model, extra = (d, j * size, (j + 1) * size), {"experts": True}
                else:
                    full[d] = size * tp.tp
                    model = (d, m_rank * size, (m_rank + 1) * size)
            if path in fsdp and not (fz and not of_params):   # the rank's data part already
                d, size = fsdp[path], leaf.shape[fsdp[path]]
                return Cut(dim=d, start=rank * size, stop=(rank + 1) * size, model=model,
                           **extra)
            # ZeRO-1's params, a frozen leaf's (empty) moments, an expert's
            # moments (the rank's experts whole) and FSDP's unsplit leaves: whole
            if of_params or fz or extra.get("experts") or rules.fsdp:
                return Cut(model=model, **extra)
            stacked = is_stacked(path)
            shape = (counts[path], *full) if stacked else tuple(full)
            spec = rules.opt_spec(path, shape)
            if "data" not in spec:
                return Cut(model=model, **extra)
            d = spec.index("data")
            if stacked and d == 0:                     # whole layers per rank
                j = seen[path] = seen.get(path, -1) + 1
                owner = j // (counts[path] // n)
                return Cut(owner=owner, held=owner == rank, model=model, **extra)
            d -= stacked            # a dim the spec leaves whole: the shard's is the leaf's
            size = leaf.shape[d] // n
            return Cut(dim=d, start=rank * size, stop=(rank + 1) * size, model=model, **extra)

        partial = {} if tp is None else tp.partial
        over = frozenset() if tp is None else tp.over_data
        return cls(mesh=mesh, rules=rules,
                   plan=tree_map_ref(lambda p, leaf, fz: cut(p, leaf, fz, False), like, frozen),
                   tp=tp,
                   sharded=tree_map_ref(lambda p, _l: p in cuts, like),
                   partial=tree_map_ref(lambda p, _l: (p in partial and (
                       partial[p] if partial[p] is not None else True)), like),
                   experts=tree_map_ref(lambda p, _l: p in over, like),
                   params_plan=tree_map_ref(lambda p, leaf, fz: cut(p, leaf, fz, True), like,
                                            frozen))

    @property
    def fsdp(self) -> bool:
        """Whether a rank holds its data part of the params (FSDP)."""
        return self.rules.fsdp

    @property
    def split(self) -> Any:
        """Whether the rank holds a data part of each param (`params_plan`
        cuts it over "data": FSDP's split leaves, frozen ones too)."""
        return tree_map_ref(lambda _p, _s, c: c.dim is not None, self.sharded, self.params_plan)

    # ------------------------------------------------------------------
    def shard(self, tree: Any) -> Any:
        """The rank's part of each leaf of a tree of its params' layout that
        its moments hold (None leaves, a frozen leaf's gradient, stay None):
        the tree itself under FSDP, where the params are parts already."""
        if self.fsdp:
            return tree
        return tree_map_ref(lambda _p, t, c: None if t is None else c.part(t), tree, self.plan)

    def gather(self, shards: Any, like: Any, plan: Any = None) -> Any:
        """The rank's model shards of the leaves from every data rank's
        `shards` (cut by `plan`, the moments' by default; `like` gives each
        leaf's shape): a slice by all-gather, a layer by its owner's
        broadcast, over "data". Every rank calls it, in the same order."""
        mesh = self.mesh

        def whole(_p, t, c: Cut, ref):
            if t is None:
                return t
            if c.owner is not None:
                buf = t if c.held else t.new_empty(ref.shape)
                return mesh.broadcast(buf.contiguous(), c.owner, "data")
            if c.dim is None:
                return t
            out = mesh.all_gather(t.contiguous(), "data")      # (n, *slice)
            return out.movedim(0, c.dim).flatten(c.dim, c.dim + 1).contiguous()

        return tree_map_ref(whole, shards, self.plan if plan is None else plan, like)

    def model_shards(self, params: Any) -> Any:
        """The rank's model shards of its params (their data parts gathered
        over "data" under FSDP; the params themselves otherwise)."""
        return self.gather(params, params, self.params_plan) if self.fsdp else params

    def gather_model(self, tree: Any) -> Any:
        """The whole leaves from every model rank's shards (the params'
        layout, each leaf the rank's model shard): a concatenation over the
        cut dim by an all_reduce of a zero-padded buffer on "model" (each
        split block's in turn for a block-selected shard; over "data" first
        for an expert leaf split over both axes). A frozen leaf's empty
        moment (or None gradient) stays as it is."""
        mesh = self.mesh

        def whole(_p, t, c: Cut):
            if t is None or c.model is None or tuple(t.shape) == (0,):
                return t
            d = c.model[0]
            if c.blocks is not None:
                parts, at = [], 0
                for n, split in c.blocks:
                    size = n // c.model[2] if split else n
                    piece = t.narrow(d, at, size)
                    parts.append(mesh.gather_dim(piece.contiguous(), d, "model") if split
                                 else piece)
                    at += size
                return torch.cat(parts, d)
            if c.experts:
                t = mesh.gather_dim(t.contiguous(), d, "data")
            return mesh.gather_dim(t.contiguous(), d, "model")

        return tree_map_ref(whole, tree, self.plan)

    def init_state(self, opt: AdamW, params: Any, frozen: Any | None = None) -> AdamWState:
        """The rank's AdamW state: zero moments of its shards."""
        return opt.init(self.shard(params), frozen)

    def gather_state(self, tree: dict[str, Any]) -> dict[str, Any]:
        """{"params", "opt": the rank's AdamWState} -> the same with whole
        leaves in the reference's layout: the moments (and under FSDP the
        params) gathered over "data", then (on a model mesh) params and
        moments over "model". Every rank calls it; rank 0 checkpoints the
        result."""
        params, opt = tree["params"], tree["opt"]
        out = {"params": self.model_shards(params),
               "opt": AdamWState(step=opt.step, m=self.gather(opt.m, params),
                                 v=self.gather(opt.v, params))}
        if self.tp is None:
            return out
        return {"params": self.gather_model(out["params"]),
                "opt": AdamWState(step=opt.step, m=self.gather_model(out["opt"].m),
                                  v=self.gather_model(out["opt"].v))}

    def cuts(self, params_like: Any) -> dict[str, Any]:
        """The `Checkpointer.restore(shardings=)` tree of {"params", "opt"}
        (`params_like` the rank's params): each param the rank's model shard
        (under FSDP its data part of that), each moment cut as its param's
        model shard is, then to its data part."""
        return {"params": tree_map_ref(lambda _p, _l, c: c, params_like, self.params_plan),
                "opt": AdamWState(step=WHOLE, m=self.plan, v=self.plan)}

    def global_norm(self, opt: AdamW, grads: Any, frozen: Any) -> torch.Tensor:
        """The global norm of the whole model's reduced gradients, from the
        rank's shards: the sum of squares of what is split over "model"
        summed over it, of what an FSDP rank holds its data part of over
        "data" (of the expert leaves and of data parts of model shards, over
        both axes), each replicated leaf or block counted once."""
        if self.tp is None:
            return opt.global_norm(grads, frozen)
        sq: dict[str, list[torch.Tensor]] = {"once": [], "model": [], "data": [], "both": []}

        def add(_p, g, fz, sh, pt, ex, ds):
            if fz or g is None:
                return
            rep, cut = ("data", "both") if ds else ("once", "model")
            if ex:
                sq["both"].append((g.float() ** 2).sum())
            elif isinstance(pt, tuple):      # replicated blocks once, the rest split
                dim, ranges = pt
                at = 0
                for lo, hi in ranges:
                    if lo > at:
                        sq[cut].append((g.narrow(dim, at, lo - at).float() ** 2).sum())
                    sq[rep].append((g.narrow(dim, lo, hi - lo).float() ** 2).sum())
                    at = hi
                if g.shape[dim] > at:
                    sq[cut].append((g.narrow(dim, at, g.shape[dim] - at).float() ** 2).sum())
            else:
                sq[cut if sh else rep].append((g.float() ** 2).sum())

        tree_map_ref(add, grads, frozen, self.sharded, self.partial, self.experts, self.split)
        zero = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        split = sum(sq["model"], zero)
        if self.tp.over_data or sq["data"] or sq["both"]:
            parts = torch.stack([split, sum(sq["both"], zero)])
            if self.mesh.size("model") > 1:
                parts = self.mesh.all_reduce(parts, "model")
            split = parts[0] + self.mesh.all_reduce(
                (parts[1] + sum(sq["data"], zero)).reshape(1), "data")[0]
        else:
            split = self.mesh.all_reduce(split.reshape(1), "model")[0]
        return torch.sqrt(split + sum(sq["once"], zero))


def make_sharded_grads_fn(bundle, layout: Zero1, *, compute_dtype=torch.bfloat16,
                          grad_accum: int = 1, loss_fn: Callable | None = None) -> Callable:
    """(params, frozen, global batch) -> (loss, aux, grads) of one rank: the
    gradients of the rank's rows (`local_batch`) through its shard of the
    model (`bundle` the rank's `tensor_parallel.local_bundle` on a model
    mesh), the partial leaves summed over "model", then every gradient
    mean-reduced over "data", as are the loss and aux; each leaf the whole
    model's gradient of the rank's shard of that leaf."""
    from repro_torch.train.train_step import _device_of, make_grads_fn

    mesh, rules = layout.mesh, layout.rules
    experts = layout.experts is not None and any(
        e for es in reference_leaves(layout.experts).values() for e in es)
    split_tree = layout.split
    split = any(e for es in reference_leaves(split_tree).values() for e in es)
    if layout.tp is not None and layout.tp.tp > 1:
        if loss_fn is not None:
            raise NotImplementedError("a tensor-parallel step takes the plain cross-entropy "
                                      "(vocab-parallel); a loss_fn over whole logits does not "
                                      "shard")
        loss_fn = lambda p, b: bundle.loss(p, b, compute_dtype=compute_dtype,   # noqa: E731
                                           mesh=mesh)
    grads_fn = make_grads_fn(bundle, compute_dtype=compute_dtype, grad_accum=grad_accum,
                             loss_fn=loss_fn)

    def fn(params, frozen, batch):
        dev = _device_of(params)
        # the mesh bound for the forward: an MoE layer's load-balance
        # fractions are the data axis' means, the global batch's
        with sharded.bound(mesh):
            loss, aux, grads = grads_fn(
                params, frozen, local_batch({k: v.to(dev) for k, v in batch.items()}, mesh,
                                            rules, accum=grad_accum))
        if layout.tp is not None and layout.tp.partial:
            # one fp32 bucket of the partial leaves and blocks, summed over "model"
            views: list[torch.Tensor] = []

            def add(_p, g, pt):
                if g is None or pt is False:
                    return
                if pt is True:
                    views.append(g)
                else:
                    views.extend(g.narrow(pt[0], lo, hi - lo) for lo, hi in pt[1])

            tree_map_ref(add, grads, layout.partial)
            if views:
                flat = mesh.all_reduce(torch.cat([v.float().reshape(-1) for v in views]),
                                       "model")
                at = 0
                for v in views:
                    v.copy_(flat[at:at + v.numel()].view(v.shape))
                    at += v.numel()
        if experts or split:
            # a rank's own experts: their gradient sums every data rank's
            # tokens already; the data mean's division alone. An FSDP rank's
            # data parts: the data mean already (the gather's backward)
            n = mesh.size("data")
            rest = tree_map_ref(lambda _p, g, e, ds: None if e or ds else g, grads,
                                layout.experts, split_tree)
            rest = unflatten_vector(mesh.all_mean(flat_vector(rest), "data"), rest)
            grads = tree_map_ref(lambda _p, g, r, e, ds: r if not (e or ds) or g is None
                                 else g if ds else g.float().div(n).to(g.dtype),
                                 grads, rest, layout.experts, split_tree)
        else:
            # one fp32 bucket of every gradient, mean-reduced over "data"
            grads = unflatten_vector(mesh.all_mean(flat_vector(grads), "data"), grads)
        scalars = mesh.all_mean(torch.stack([loss.float(), *(v.float() for v in aux.values())]),
                                "data")
        return scalars[0], dict(zip(aux, scalars[1:])), grads

    return fn


def make_data_parallel_step(bundle, opt: AdamW, layout: Zero1, *,
                            frozen_mask: Any | None = None, compute_dtype=torch.bfloat16,
                            grad_accum: int = 1, loss_fn: Callable | None = None) -> Callable:
    """The step (params, opt_state, batch) -> (params, opt_state, metrics) of
    one rank, `make_train_step`'s contract with `opt_state` the rank's
    ZeRO-1 state (`layout.init_state`), `batch` the global batch and, on a
    model mesh or under FSDP, `bundle` and `params` the rank's local bundle
    and its parts (`tensor_parallel.place(..., train=True)`). Every rank of
    `layout.mesh` calls it with the same batch, and every rank of a model
    shard with the same params; the loss and the metrics are the means over
    the data ranks."""
    from repro_torch.train.train_step import step_metrics

    grads_fn = make_sharded_grads_fn(bundle, layout, compute_dtype=compute_dtype,
                                     grad_accum=grad_accum, loss_fn=loss_fn)

    def step(params, opt_state: AdamWState, batch):
        frozen = frozen_mask if frozen_mask is not None else no_frozen(params)
        loss, aux, grads = grads_fn(params, frozen, batch)
        gnorm = layout.global_norm(opt, grads, frozen) if opt.clip_norm is not None else None
        new_sh, new_opt, gnorm = opt.update(layout.shard(grads), opt_state,
                                            layout.shard(params), frozen, gnorm=gnorm)
        # FSDP: the rank's parts are its params; ZeRO-1: every data rank's slices
        new_params = new_sh if layout.fsdp else layout.gather(new_sh, params)
        return new_params, new_opt, step_metrics(loss, gnorm, aux, new_params)

    return step
