"""The data-parallel train step with ZeRO-1 optimizer moments.

Counterpart of the reference's sharded step, `jax.jit(make_train_step(...),
in_shardings=(params, opt_shardings, batch_shardings))` on a data mesh
(tests/test_sharded.py), which GSPMD partitions; here the partition is
written out. On each of the mesh's data ranks:

  1. take the rank's rows of the global batch (`local_batch`: dim 0 by
     `ShardingRules.batch_dim`, M-RoPE's pos on its second axis; where the
     batch does not divide, every rank takes all of it, as a replicated spec
     would);
  2. compute the gradients as the single-rank step does (`train_step.
     make_grads_fn`: frozen leaves, grad_accum) and mean-reduce them in fp32
     over "data", all leaves in one bucket;
  3. take the global norm of the reduced, full gradients;
  4. update only the rank's ZeRO-1 shard of `m`, `v` and the matching slice
     of each param (`ShardingRules.opt_spec`'s "data" dim: `Zero1`), with
     that norm (`AdamW.update(gnorm=)`), then all-gather the param slices,
     so that every rank holds the same params.

The port keeps a layer stack as a list of per-layer leaves. Where the
spec's "data" dim is the stack's layer axis, a rank holds whole layers of
that leaf (the others' placeholders are empty) and the layer's owner
broadcasts it; elsewhere a rank holds a contiguous slice of every layer.
`Zero1.gather_state` gathers a train state into the reference's layout for
a checkpoint (rank 0 writes it: `train/trainer.py`), and `Zero1.cuts`
tells `Checkpointer.restore(shardings=)` which part of each leaf a rank
reads. Tensor-parallel training and FSDP execution (meshes with model > 1,
`fsdp=True`) are not ported yet (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed.sharding import ShardingRules, is_stacked
from repro_torch.optim import AdamW, AdamWState, no_frozen
from repro_torch.weights import flat_vector, reference_leaves, tree_map_ref, unflatten_vector

NEXT_SLICE = ("tensor-parallel training and FSDP execution (a mesh with model > 1, "
              "ShardingRules(fsdp=True)) are not ported yet: ROADMAP Queue A item 5")


def local_batch(batch: dict[str, torch.Tensor], mesh, rules: ShardingRules | None = None
                ) -> dict[str, torch.Tensor]:
    """The rows of the global `batch` that `mesh`'s data rank takes, by
    `rules.batch_shardings` (the mesh's own rules by default)."""
    rules = rules or ShardingRules.for_mesh(mesh)
    n, r = rules.data, mesh.data_rank
    out = {}
    for k, spec in rules.batch_shardings(batch).items():
        v = batch[k]
        if "data" in spec:
            d = spec.index("data")
            size = v.shape[d] // n
            v = v.narrow(d, r * size, size)
        out[k] = v
    return out


class Cut(NamedTuple):
    """The part of one port-layout leaf a data rank holds: the whole leaf
    (`dim` None), [start, stop) along `dim`, or, for a layer owned by one
    rank (`owner`), the whole layer where `held`, else nothing."""

    dim: int | None = None
    start: int = 0
    stop: int = 0
    owner: int | None = None
    held: bool = True

    def apply(self, a):
        """The held part of `a` (a tensor or a numpy array); an empty (0,)
        one where nothing is held."""
        if not self.held:
            return a.reshape(-1)[:0]
        if self.dim is None:
            return a
        idx = [slice(None)] * a.ndim
        idx[self.dim] = slice(self.start, self.stop)
        return a[tuple(idx)]


WHOLE = Cut()


@dataclasses.dataclass
class Zero1:
    """One data rank's ZeRO-1 layout of the params `like` (port layout;
    only shapes are read) on `mesh`: `plan` is the `Cut` of every leaf, by
    `rules.opt_spec` of its reference path and stacked shape. Frozen leaves
    are held whole and never updated."""

    mesh: Any
    rules: ShardingRules
    plan: Any

    @classmethod
    def build(cls, mesh, like: Any, frozen: Any | None = None,
              rules: ShardingRules | None = None) -> "Zero1":
        rules = rules or ShardingRules.for_mesh(mesh)
        if rules.model > 1 or rules.fsdp:
            raise NotImplementedError(NEXT_SLICE)
        frozen = frozen if frozen is not None else no_frozen(like)
        counts = {p: len(leaves) for p, leaves in reference_leaves(like).items()}
        seen: dict[str, int] = {}
        n, rank = rules.data, mesh.data_rank

        def cut(path: str, leaf, fz: bool) -> Cut:
            if fz:
                return WHOLE
            stacked = is_stacked(path)
            shape = (counts[path], *leaf.shape) if stacked else tuple(leaf.shape)
            spec = rules.opt_spec(path, shape)
            if "data" not in spec:
                return WHOLE
            d = spec.index("data")
            if stacked and d == 0:                     # whole layers per rank
                j = seen[path] = seen.get(path, -1) + 1
                owner = j // (counts[path] // n)
                return Cut(owner=owner, held=owner == rank)
            d -= stacked
            size = leaf.shape[d] // n
            return Cut(dim=d, start=rank * size, stop=(rank + 1) * size)

        return cls(mesh=mesh, rules=rules, plan=tree_map_ref(cut, like, frozen))

    # ------------------------------------------------------------------
    def shard(self, tree: Any) -> Any:
        """The rank's part of each leaf of a tree of the params' layout (None
        leaves, a frozen leaf's gradient, stay None)."""
        return tree_map_ref(lambda _p, t, c: None if t is None else c.apply(t), tree, self.plan)

    def gather(self, shards: Any, like: Any) -> Any:
        """The whole leaves from every rank's `shards` (the params' layout;
        `like` gives each leaf's whole shape): a slice by all-gather, a
        layer by its owner's broadcast. Every rank calls it, in the same
        order."""
        mesh = self.mesh

        def whole(_p, t, c: Cut, ref):
            if c.owner is not None:
                buf = t if c.held else t.new_empty(ref.shape)
                return mesh.broadcast(buf.contiguous(), c.owner)
            if c.dim is None:
                return t
            out = mesh.all_gather(t.contiguous())      # (n, *slice)
            return out.movedim(0, c.dim).flatten(c.dim, c.dim + 1).contiguous()

        return tree_map_ref(whole, shards, self.plan, like)

    def init_state(self, opt: AdamW, params: Any, frozen: Any | None = None) -> AdamWState:
        """The rank's AdamW state: zero moments of its shards."""
        return opt.init(self.shard(params), frozen)

    def gather_state(self, tree: dict[str, Any]) -> dict[str, Any]:
        """{"params", "opt": the rank's AdamWState} -> the same with whole
        moments (every rank calls it; rank 0 checkpoints the result)."""
        params, opt = tree["params"], tree["opt"]
        return {"params": params,
                "opt": AdamWState(step=opt.step, m=self.gather(opt.m, params),
                                  v=self.gather(opt.v, params))}

    def cuts(self, params_like: Any) -> dict[str, Any]:
        """The `Checkpointer.restore(shardings=)` tree of {"params", "opt"}:
        the params whole, each moment cut as its param is."""
        return {"params": tree_map_ref(lambda _p, _l: WHOLE, params_like),
                "opt": AdamWState(step=WHOLE, m=self.plan, v=self.plan)}


def make_data_parallel_step(bundle, opt: AdamW, layout: Zero1, *,
                            frozen_mask: Any | None = None, compute_dtype=torch.bfloat16,
                            grad_accum: int = 1, loss_fn: Callable | None = None) -> Callable:
    """The step (params, opt_state, batch) -> (params, opt_state, metrics) of
    one data rank, `make_train_step`'s contract with `opt_state` the rank's
    ZeRO-1 state (`layout.init_state`) and `batch` the global batch. Every
    rank of `layout.mesh` calls it with the same params and batch; the loss
    and the metrics are the means over the ranks."""
    from repro_torch.train.train_step import _device_of, make_grads_fn, step_metrics

    mesh, rules = layout.mesh, layout.rules
    grads_fn = make_grads_fn(bundle, compute_dtype=compute_dtype, grad_accum=grad_accum,
                             loss_fn=loss_fn)

    def step(params, opt_state: AdamWState, batch):
        dev = _device_of(params)
        frozen = frozen_mask if frozen_mask is not None else no_frozen(params)
        loss, aux, grads = grads_fn(
            params, frozen, local_batch({k: v.to(dev) for k, v in batch.items()}, mesh, rules))
        # one fp32 bucket of every gradient, mean-reduced over "data"
        grads = unflatten_vector(mesh.all_mean(flat_vector(grads)), grads)
        scalars = mesh.all_mean(torch.stack([loss.float(), *(v.float() for v in aux.values())]))
        loss, aux = scalars[0], dict(zip(aux, scalars[1:]))
        gnorm = opt.global_norm(grads, frozen) if opt.clip_norm is not None else None
        new_sh, new_opt, gnorm = opt.update(layout.shard(grads), opt_state,
                                            layout.shard(params), frozen, gnorm=gnorm)
        new_params = layout.gather(new_sh, params)
        return new_params, new_opt, step_metrics(loss, gnorm, aux, new_params)

    return step
