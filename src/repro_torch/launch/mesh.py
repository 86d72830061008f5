"""The host mesh of a tensor-, data- or (data, model)-parallel run, over
`torch.distributed` ranks.

Counterpart of `repro.launch.mesh.make_host_mesh`, `mesh_from_devices` and
`make_production_mesh`; the reference's `make_mesh`, a version shim over
`jax.sharding.Mesh`, has no counterpart. One process per rank; each rank
calls `make_host_mesh(data=dp, model=tp, rank=r, devices=...)`, which joins the process group and gives the rank its
explicit device, `devices[rank]`. The backend is NCCL when every rank has a
card of its own, and gloo when ranks share a device: on the CPU, or several
ranks on one card (each rank its own process and CUDA context).
`HostMesh.backend` says which. A mesh of one rank joins no process group:
its collectives are the identity. `mesh_of_group` is the mesh of a process
group that the caller initialized (under `torchrun`'s RANK / WORLD_SIZE,
say), all of it on the "data" axis.

Rank r sits at (data_rank, model_rank) = (r // model, r % model). A mesh
with both axes above 1 (tensor-parallel training) makes one process
subgroup per row and per column of that grid, in the same order on every
rank (`dist.new_group` is collective): a "model" collective spans the
ranks of one data row, a "data" collective the ranks of one model column.
Every collective takes its `axis`; on a 1-D mesh `axis=None` (the default)
is the whole mesh, as it always was, and on a 2-D mesh the axis must be
named.

Gloo takes CUDA tensors only for `all_reduce` and `broadcast`, so every
collective of the tensor-parallel path is one of those two: a gather is an
`all_reduce` of a zero-padded buffer (`gather_last`, `gather_dim`), and so
is the max (`all_max`) of a CUDA tensor under gloo. The data axis adds a
mean all-reduce (`all_mean`), an all-to-all (`all_to_all`), an
all-gather (`all_gather`) and a reduce-scatter (`reduce_scatter`, FSDP's
gradient of a gathered weight): NCCL's `all_to_all_single`,
`all_gather_into_tensor` and `reduce_scatter_tensor`, and gloo's on the
CPU; on CUDA tensors under gloo the first two are an `all_reduce` of a
zero-padded buffer, exact since each element has one non-zero
contributor, but n times the bytes, and the reduce-scatter an `all_reduce`
of the whole tensor followed by the rank's slice. The engine's control
messages (the scheduler's token rows, positions, slot masks, page tables)
are int64 host tensors broadcast over a gloo control group of their own
(`broadcast_ints`), beside the default group that carries the forward's
collectives. A follower waits in the control group until the leader's next
message, so that group never times out an idle server
(`CONTROL_TIMEOUT_S`); the other collectives fail within `timeout_s`
(`DATA_TIMEOUT_S`) when a peer stops answering. The mesh counts each
collective, the bytes it was given and the host time spent in it, in all
(`counters`) and per axis (`axis_counters`).

`make_production_mesh` is the dry run's mesh (`launch/dryrun.py`): a
`DryMesh`, rank (0, 0) of the reference's production mesh, (16, 16) over
("data", "model") or, multi-pod, (2, 16, 16) over ("pod", "data",
"model"). It joins no process group: each collective returns a meta tensor
of its result's shape and records the bytes it was given, per axis, and
the wire bytes of the ring model (`roofline.analysis.RING_KIND`). Pods are
pure data parallelism in the reference (`repro.distributed.sharding`), so
the multi-pod mesh folds "pod" into a data axis of 32 and keeps the three
axis names in its record (a kept difference: the port's meshes have two
axes).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.roofline.analysis import link_bw, wire_bytes

# a follower rank waits in the control group's broadcast until the leader's
# next message: an idle server must not time it out
CONTROL_TIMEOUT_S = 7 * 24 * 3600.0
# the forward's collectives: long enough for a peer's first kernel builds
DATA_TIMEOUT_S = 600.0


def backend_for(devices: Sequence[torch.device | str]) -> str:
    """"nccl" when every rank has a card of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({str(d) for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


COLLECTIVES = ("all_reduce", "all_max", "all_mean", "all_to_all", "all_gather",
               "reduce_scatter", "broadcast")
AXES = ("data", "model")


def _zero_counters() -> dict:
    out: dict = {}
    for name in COLLECTIVES:
        out.update({name: 0, f"{name}_s": 0.0, f"{name}_bytes": 0})
    return out


@dataclasses.dataclass
class HostMesh:
    """A ("data", "model") mesh of `data` x `model` ranks; this process is
    `rank` on `device`."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    control_group: Any = None
    counters: dict = dataclasses.field(default_factory=_zero_counters)
    # {"data" | "model": this rank's process subgroup of that axis} on a 2-D mesh
    groups: dict = dataclasses.field(default_factory=dict)
    axis_counters: dict = dataclasses.field(
        default_factory=lambda: {a: _zero_counters() for a in AXES})

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    def reset_counters(self) -> None:
        for c in (self.counters, *self.axis_counters.values()):
            for k in c:
                c[k] = 0 if isinstance(c[k], int) else 0.0

    def _axis(self, axis: str | None) -> str:
        """The axis a collective runs on: `axis`, or on a 1-D mesh (None) the
        one the mesh has."""
        if axis is None:
            if self.data > 1 and self.model > 1:
                raise ValueError("a collective of a (data, model) mesh names its axis")
            return "model" if self.model > 1 else "data"
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return axis

    def size(self, axis: str | None = None) -> int:
        """The ranks a collective on `axis` spans (the whole mesh for None)."""
        return self.world if axis is None else self.shape[self._axis(axis)]

    def index(self, axis: str | None = None) -> int:
        """This rank's index along `axis` (its rank for None)."""
        if axis is None:
            return self.rank
        return self.model_rank if self._axis(axis) == "model" else self.data_rank

    def _group(self, axis: str | None):
        """The process group of a collective on `axis`: None (the default
        group) where the axis spans the whole mesh."""
        if axis is None or self.size(axis) == self.world:
            self._axis(axis)
            return None
        return self.groups[self._axis(axis)]

    def _src(self, axis: str | None, i: int) -> int:
        """The global rank of index `i` along `axis` in this rank's group."""
        if axis is None:
            return i
        if self._axis(axis) == "model":
            return self.data_rank * self.model + i
        return i * self.model + self.model_rank

    def _count(self, name: str, t0: float, nbytes: int, axis: str | None = None) -> None:
        dt = time.perf_counter() - t0
        for c in (self.counters, self.axis_counters[self._axis(axis)]):
            c[f"{name}_s"] += dt
            c[name] += 1
            c[f"{name}_bytes"] += nbytes

    def _emulated(self, t: torch.Tensor) -> bool:
        """Whether this collective goes through a zero-padded all_reduce: gloo
        takes CUDA tensors only for all_reduce and broadcast."""
        return self.backend == "gloo" and t.is_cuda

    # ------------------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """Sum `t` over `axis` (the whole 1-D mesh for None), in place;
        returns it."""
        t0 = time.perf_counter()
        if self.size(axis) > 1:
            dist.all_reduce(t, group=self._group(axis))
        self._count("all_reduce", t0, t.numel() * t.element_size(), axis)
        return t

    def all_max(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The elementwise max of `t` over `axis` (a new tensor): a MAX
        all-reduce, or under gloo on a CUDA tensor the max of every rank's
        `t` gathered by an all_reduce of a zero-padded buffer; exact both
        ways."""
        t0 = time.perf_counter()
        n, r = self.size(axis), self.index(axis)
        if n == 1:
            out = t.clone()
        elif self._emulated(t):
            buf = t.new_zeros((n, *t.shape))
            buf[r] = t
            dist.all_reduce(buf, group=self._group(axis))
            out = buf.amax(dim=0)
        else:
            out = t.clone()
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self._group(axis))
        self._count("all_max", t0, t.numel() * t.element_size(), axis)
        return out

    def all_mean(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """The mean of `t` over the data axis (or `axis`), in place (a sum,
        then / the axis' size); returns it."""
        t0 = time.perf_counter()
        if self.size(axis) > 1:
            dist.all_reduce(t, group=self._group(axis))
            t.div_(self.data if axis is None else self.size(axis))
        self._count("all_mean", t0, t.numel() * t.element_size(), axis)
        return t

    def all_to_all(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """`t` (n, ...), n the ranks of `axis`: row p goes to rank p; returns
        (n, ...) whose row p came from rank p (`jax.lax.all_to_all`, split
        and concat axis 0, tiled)."""
        t0 = time.perf_counter()
        n, r = self.size(axis), self.index(axis)
        if t.shape[0] != n:
            raise ValueError(f"all_to_all: {t.shape[0]} rows for {n} ranks")
        if n == 1:
            out = t.clone()
        elif self._emulated(t):
            buf = t.new_zeros((n, *t.shape))           # [sender, receiver, ...]
            buf[r] = t
            dist.all_reduce(buf, group=self._group(axis))
            out = buf[:, r].contiguous()
        else:
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t.contiguous(), group=self._group(axis))
        self._count("all_to_all", t0, t.numel() * t.element_size(), axis)
        return out

    def all_gather(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """Every rank's `t` along `axis`, stacked in rank order: (n, *t.shape)."""
        t0 = time.perf_counter()
        n, r = self.size(axis), self.index(axis)
        if n == 1:
            out = t.unsqueeze(0).clone()
        elif self._emulated(t):
            out = t.new_zeros((n, *t.shape))
            out[r] = t
            dist.all_reduce(out, group=self._group(axis))
        else:
            out = t.new_empty((n * t.numel(),))
            dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=self._group(axis))
            out = out.view(n, *t.shape)
        self._count("all_gather", t0, t.numel() * t.element_size(), axis)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int, axis: str | None = None) -> torch.Tensor:
        """The sum of every rank's `t` along `axis`, of which this rank keeps
        its part along `dim` (the i-th of n equal parts on index i): a new
        tensor. Under gloo on a CUDA tensor, an all_reduce of the whole
        tensor, then the rank's slice."""
        t0 = time.perf_counter()
        n, r = self.size(axis), self.index(axis)
        dim = dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} over {n} ranks")
        m = t.shape[dim] // n
        if n == 1:
            out = t.clone()
        elif self._emulated(t):
            buf = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(buf, group=self._group(axis))
            # a copy: a dim-0 part would be a view pinning the n-x buffer
            out = buf.narrow(dim, r * m, m).clone(memory_format=torch.contiguous_format)
        else:
            inp = t.movedim(dim, 0).contiguous()         # rank i's part: rows [i m, (i+1) m)
            part = inp.new_empty((m, *inp.shape[1:]))
            dist.reduce_scatter_tensor(part, inp, group=self._group(axis))
            out = part.movedim(0, dim).contiguous()
        self._count("reduce_scatter", t0, t.numel() * t.element_size(), axis)
        return out

    def broadcast(self, t: torch.Tensor, src: int, axis: str | None = None) -> torch.Tensor:
        """The `t` of index `src` along `axis` (rank `src` for None) on
        every rank of it, in place; returns it."""
        t0 = time.perf_counter()
        if self.size(axis) > 1:
            dist.broadcast(t, self._src(axis, src), group=self._group(axis))
        self._count("broadcast", t0, t.numel() * t.element_size(), axis)
        return t

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def gather_dim(self, t: torch.Tensor, dim: int, axis: str | None = None) -> torch.Tensor:
        """Every rank's `t` along `axis` concatenated over `dim` in rank
        order: an all_reduce of a zero-padded buffer, so each value is its
        rank's exactly."""
        n, r = self.size(axis), self.index(axis)
        dim = dim % t.dim()
        m = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * m
        buf = t.new_zeros(shape)
        buf.narrow(dim, r * m, m).copy_(t)
        return self.all_reduce(buf, axis)

    def gather_last(self, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
        """Every rank's `t` (..., m) concatenated over the last axis in rank
        order, (..., model * m) on the model axis (`gather_dim`)."""
        return self.gather_dim(t, -1, axis)

    def broadcast_ints(self, values: np.ndarray | None, n: int) -> np.ndarray:
        """Rank 0's `n` int64 values on every rank, over the control group
        (host tensors); other ranks pass None."""
        buf = (torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64)) if self.rank == 0
               else torch.empty(n, dtype=torch.int64))
        if buf.numel() != n:
            raise ValueError(f"broadcast_ints: {buf.numel()} values, {n} announced")
        dist.broadcast(buf, 0, group=self.control_group)
        return buf.numpy()

    def broadcast_bytes(self, payload: bytes | None) -> bytes:
        """Rank 0's bytes on every rank, over the control group."""
        n = int(self.broadcast_ints(None if self.rank else np.array([len(payload)]), 1)[0])
        buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8) if self.rank == 0
               else torch.empty(n, dtype=torch.uint8))
        dist.broadcast(buf, 0, group=self.control_group)
        return bytes(buf.numpy())

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if self.world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def make_host_mesh(*, data: int = 1, model: int = 1, rank: int | None = None,
                   devices: Sequence[torch.device | str] | None = None,
                   init_method: str | None = None,
                   timeout_s: float = DATA_TIMEOUT_S) -> HostMesh:
    """Join (or reuse) the process group of `data * model` ranks as `rank`
    and return the mesh. `devices[r]` is rank r's device (default: one card
    per rank, cuda:0..); `init_method` the rendezvous (default: the
    MASTER_ADDR / MASTER_PORT environment); `rank` defaults to $RANK. The
    backend follows the devices (`backend_for`); `timeout_s` bounds the
    collectives. A mesh of one rank joins no group; a mesh with both axes
    above 1 makes the subgroups of its rows and columns."""
    world = data * model
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if devices is None:
        devices = [f"cuda:{r}" for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"mesh ({data}, {model}) needs {world} devices, got {len(devices)}")
    device = resolve_device(devices[rank])
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if max(torch.device(d).index or 0 for d in devices) >= n:
            raise ValueError(f"mesh ({data}, {model}) needs the cards {list(devices)}, the "
                             f"host has {n}")
        torch.cuda.set_device(device)
    backend = backend_for(devices)
    if world == 1 and not dist.is_initialized():
        return HostMesh(data=data, model=model, rank=0, device=device, backend=backend)
    if not dist.is_initialized():
        kw: dict[str, Any] = {}
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    elif dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh "
                         f"({data}, {model}) {world}")
    control = dist.new_group(backend="gloo",
                             timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    groups: dict[str, Any] = {}
    if data > 1 and model > 1:
        # every rank makes every group, rows then columns, in one order
        tmo = datetime.timedelta(seconds=timeout_s)
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            g = dist.new_group(ranks, timeout=tmo)
            if rank in ranks:
                groups["model"] = g
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            g = dist.new_group(ranks, timeout=tmo)
            if rank in ranks:
                groups["data"] = g
    return HostMesh(data=data, model=model, rank=rank, device=device, backend=backend,
                    control_group=control, groups=groups)


def mesh_from_devices(devices: Sequence[Sequence[torch.device | str]], *, rank: int | None = None,
                      init_method: str | None = None,
                      timeout_s: float = DATA_TIMEOUT_S) -> HostMesh:
    """The mesh over a hand-picked (data, model) grid of devices, rank r on
    the r-th device in row-major order: the elastic-rescale path, where the
    surviving devices are picked by hand. Counterpart of the reference's
    `mesh_from_devices(devices, ("data", "model"))`."""
    grid = [list(row) for row in devices]
    if not grid or any(len(row) != len(grid[0]) for row in grid):
        raise ValueError(f"devices must be a (data, model) grid, got {devices!r}")
    return make_host_mesh(data=len(grid), model=len(grid[0]), rank=rank,
                          devices=[d for row in grid for d in row], init_method=init_method,
                          timeout_s=timeout_s)


def mesh_of_group(device: str | torch.device | None = None) -> HostMesh:
    """The data mesh of the process group the caller initialized, this
    process on `device` (the card unless the caller asks for the CPU); with no
    group, the mesh of this process's one device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return HostMesh(data=1, model=1, rank=0, device=dev, backend=backend_for([dev]))
    return HostMesh(data=dist.get_world_size(), model=1, rank=dist.get_rank(), device=dev,
                    backend=dist.get_backend())


@dataclasses.dataclass
class DryMesh(HostMesh):
    """Rank (0, 0) of a (data, model) mesh with no process group, for a
    step traced on the meta device: `HostMesh`'s collectives and counters,
    each collective returning a meta tensor of its result's shape (in-place
    ones the tensor itself) and recording its wire bytes per axis and ring
    kind (`wire`). `axis_names` and `grid` are the mesh as the record names
    it (the multi-pod mesh's three axes)."""

    axis_names: tuple[str, ...] = AXES
    grid: tuple[int, ...] = ()
    wire: dict = dataclasses.field(default_factory=dict)

    def reset_counters(self) -> None:
        super().reset_counters()
        self.wire = {}

    def _ranks(self, axis: str) -> list[int]:
        """The global ranks of rank (0, 0)'s group on `axis`."""
        return [self._src(axis, i) for i in range(self.size(axis))]

    def _dry(self, name: str, t: torch.Tensor, out_shape, axis: str | None) -> None:
        ax = self._axis(axis)
        nin = t.numel() * t.element_size()
        kind, nwire = wire_bytes(name, nin, int(np.prod(out_shape)) * t.element_size())
        if name != "gather_dim":
            self._count(name, time.perf_counter(), nin, axis)
        if self.size(axis) > 1:
            per = self.wire.setdefault(ax, {})
            per[kind] = per.get(kind, 0) + nwire

    def wire_summary(self) -> tuple[dict, dict, dict]:
        """({ring kind: wire bytes}, {axis: wire bytes}, {axis: link
        bytes/s}) of the collectives recorded since the last reset."""
        by_kind: dict[str, float] = {}
        for per in self.wire.values():
            for kind, b in per.items():
                by_kind[kind] = by_kind.get(kind, 0) + b
        return (by_kind, {a: sum(per.values()) for a, per in self.wire.items()},
                {a: link_bw(self._ranks(a)) for a in self.wire})

    def all_reduce(self, t, axis=None):
        self._dry("all_reduce", t, t.shape, axis)
        return t

    def all_max(self, t, axis=None):
        self._dry("all_max", t, t.shape, axis)
        return torch.empty_like(t)

    def all_mean(self, t, axis=None):
        self._dry("all_mean", t, t.shape, axis)
        return t

    def all_to_all(self, t, axis=None):
        if t.shape[0] != self.size(axis):
            raise ValueError(f"all_to_all: {t.shape[0]} rows for {self.size(axis)} ranks")
        self._dry("all_to_all", t, t.shape, axis)
        return torch.empty_like(t)

    def all_gather(self, t, axis=None):
        shape = (self.size(axis), *t.shape)
        self._dry("all_gather", t, shape, axis)
        return t.new_empty(shape)

    def reduce_scatter(self, t, dim, axis=None):
        n, dim = self.size(axis), dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} over {n} ranks")
        shape = list(t.shape)
        shape[dim] //= n
        self._dry("reduce_scatter", t, shape, axis)
        return t.new_empty(shape)

    def broadcast(self, t, src, axis=None):
        self._dry("broadcast", t, t.shape, axis)
        return t

    def gather_dim(self, t, dim, axis=None):
        """Counted as the all-gather it stands for (output bytes on the
        wire), and as the all_reduce `HostMesh.gather_dim` runs."""
        dim = dim % t.dim()
        shape = list(t.shape)
        shape[dim] *= self.size(axis)
        self._count("all_reduce", time.perf_counter(), int(np.prod(shape)) * t.element_size(),
                    axis)
        self._dry("gather_dim", t, shape, axis)
        return t.new_empty(shape)


def make_production_mesh(*, multi_pod: bool = False) -> DryMesh:
    """Rank (0, 0) of the reference's production mesh, (16, 16) over
    ("data", "model"), or multi-pod (2, 16, 16) over ("pod", "data",
    "model") with "pod" folded into a data axis of 32, as a `DryMesh`."""
    if multi_pod:
        return dry_mesh(32, 16, axis_names=("pod", "data", "model"), grid=(2, 16, 16))
    return dry_mesh(16, 16)


def dry_mesh(data: int = 1, model: int = 1, **names) -> DryMesh:
    """Rank (0, 0) of a (data, model) `DryMesh` on the meta device (`names`:
    its record's `axis_names` and `grid`, else the two axes')."""
    return DryMesh(data=data, model=model, rank=0, device=torch.device("meta"), backend="dry",
                   **{"grid": (data, model), **names})
