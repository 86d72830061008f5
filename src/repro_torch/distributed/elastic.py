"""Elastic scaling: carry a training job onto a different pool of devices.

Counterpart of `repro.distributed.elastic`. When nodes join or leave, the
job checkpoints, a mesh is built anew from the surviving devices, and
training resumes with its state re-cut for the new mesh and a step built
for it. A `torch.distributed` process group cannot shrink in place: a
rescale is a new process group of the surviving ranks (each calls
`ElasticContext.build` with the new device list, its rank and a fresh
rendezvous, after every old rank has left the old group), which restores
the newest checkpoint cut for its mesh (`rescale`: each rank reads only its
ZeRO-1 shards, `data_parallel.Zero1.cuts`: on a mesh with model > 1, its
tensor-parallel shard's data part). The checkpoint holds whole arrays in
the reference's format, so any (data, model) shape reads it, with FSDP
(`build(fsdp=True)`: the rules a step gets, under which each rank reads its
data part of every param the spec splits over "data") or without.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import HostMesh, mesh_from_devices


def best_mesh_shape(n_devices: int, *, prefer_model: int = 1) -> tuple[int, int]:
    """(data, model) factorization for a surviving device count."""
    model = prefer_model
    while model > 1 and (n_devices % model or model > n_devices):
        model //= 2
    return n_devices // model, model


@dataclasses.dataclass
class ElasticContext:
    """Everything that must be rebuilt when the device pool changes."""

    mesh: HostMesh
    rules: ShardingRules
    step_fn: Callable          # built for the new mesh

    @classmethod
    def build(cls, devices: Sequence[str | torch.device],
              make_step: Callable[[HostMesh, ShardingRules], Callable], *,
              prefer_model: int = 1, fsdp: bool = False, rank: int | None = None,
              init_method: str | None = None) -> "ElasticContext":
        """Join the mesh of `devices` (best_mesh_shape's factorization) as
        `rank` at `init_method` (as `launch.mesh.make_host_mesh` takes them)
        and build its step. `make_step(mesh, rules)` builds the step of a
        rank of that mesh (on a model mesh, of its tensor-parallel shard;
        under `fsdp`, of its parts)."""
        data, model = best_mesh_shape(len(devices), prefer_model=prefer_model)
        devs = list(devices)[:data * model]
        mesh = mesh_from_devices([devs[i * model:(i + 1) * model] for i in range(data)],
                                 rank=rank, init_method=init_method)
        rules = ShardingRules.for_mesh(mesh, fsdp=fsdp)
        return cls(mesh=mesh, rules=rules, step_fn=make_step(mesh, rules))


def rescale(ckpt: Checkpointer, like: Any, new_ctx: ElasticContext,
            shardings: Any) -> tuple[int, Any]:
    """Restore the newest checkpoint cut for the new mesh."""
    return ckpt.restore(like, shardings=shardings)
