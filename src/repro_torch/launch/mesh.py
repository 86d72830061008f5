"""The host mesh of a tensor- or data-parallel run, over `torch.distributed`
ranks.

Counterpart of `repro.launch.mesh.make_host_mesh` and `mesh_from_devices`.
One process per rank; each rank calls `make_host_mesh(data=dp, model=tp,
rank=r, devices=...)`, which joins the process group and gives the rank its
explicit device, `devices[rank]`. The backend is NCCL when every rank has a
card of its own, and gloo when ranks share a device: on the CPU, or several
ranks on one card (each rank its own process and CUDA context).
`HostMesh.backend` says which. A mesh of one rank joins no process group:
its collectives are the identity. `mesh_of_group` is the mesh of a process
group that the caller initialized (under `torchrun`'s RANK / WORLD_SIZE,
say), all of it on the "data" axis. A mesh has "data" ranks (data-parallel
training) or "model" ranks (tensor-parallel serving), not both yet: the two
together are ROADMAP Queue A item 5's next slice.

Gloo takes CUDA tensors only for `all_reduce` and `broadcast`, so every
collective of the tensor-parallel path is one of those two: a gather is an
`all_reduce` of a zero-padded buffer (`gather_last`). The data axis adds a
mean all-reduce (`all_mean`), an all-to-all (`all_to_all`) and an all-gather
(`all_gather`): NCCL's `all_to_all_single` and `all_gather_into_tensor`, and
gloo's on the CPU; on CUDA tensors under gloo both are an `all_reduce` of a
zero-padded buffer, exact since each element has one non-zero contributor,
but n times the bytes. The engine's control messages (the scheduler's token
rows, positions, slot masks, page tables) are int64 host tensors broadcast
over a gloo control group of their own (`broadcast_ints`), beside the
default group that carries the forward's collectives. A follower waits in
the control group until the leader's next message, so that group never
times out an idle server (`CONTROL_TIMEOUT_S`); the other collectives fail
within `timeout_s` (`DATA_TIMEOUT_S`) when a peer stops answering. The mesh
counts each collective, the bytes it was given and the host time spent in
it (`counters`).
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


COLLECTIVES = ("all_reduce", "all_mean", "all_to_all", "all_gather", "broadcast")


def _zero_counters() -> dict:
    out: dict = {}
    for name in COLLECTIVES:
        out.update({name: 0, f"{name}_s": 0.0, f"{name}_bytes": 0})
    return out


# the next slice of ROADMAP Queue A item 5: a data axis beside the model axis
DATA_AND_MODEL = ("a mesh with both data > 1 and model > 1 (tensor-parallel training, FSDP) "
                  "is not ported yet: ROADMAP Queue A item 5")


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
        for k in self.counters:
            self.counters[k] = 0 if isinstance(self.counters[k], int) else 0.0

    def _count(self, name: str, t0: float, nbytes: int) -> None:
        self.counters[f"{name}_s"] += time.perf_counter() - t0
        self.counters[name] += 1
        self.counters[f"{name}_bytes"] += nbytes

    def _emulated(self, t: torch.Tensor) -> bool:
        """Whether this collective goes through a zero-padded all_reduce: gloo
        takes CUDA tensors only for all_reduce and broadcast."""
        return self.backend == "gloo" and t.is_cuda

    # ------------------------------------------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the mesh, in place; returns it."""
        t0 = time.perf_counter()
        if self.world > 1:
            dist.all_reduce(t)
        self._count("all_reduce", t0, t.numel() * t.element_size())
        return t

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of `t` over the data axis, in place (a sum, then / data);
        returns it."""
        t0 = time.perf_counter()
        if self.world > 1:
            dist.all_reduce(t)
            t.div_(self.data)
        self._count("all_mean", t0, t.numel() * t.element_size())
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """`t` (data, ...): row p goes to data rank p; returns (data, ...)
        whose row p came from data rank p (`jax.lax.all_to_all`, split and
        concat axis 0, tiled)."""
        t0 = time.perf_counter()
        n, r = self.data, self.data_rank
        if t.shape[0] != n:
            raise ValueError(f"all_to_all: {t.shape[0]} rows for {n} ranks")
        if self.world == 1:
            out = t.clone()
        elif self._emulated(t):
            buf = t.new_zeros((n, *t.shape))           # [sender, receiver, ...]
            buf[r] = t
            dist.all_reduce(buf)
            out = buf[:, r].contiguous()
        else:
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t.contiguous())
        self._count("all_to_all", t0, t.numel() * t.element_size())
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's `t`, stacked in rank order: (data, *t.shape)."""
        t0 = time.perf_counter()
        n, r = self.data, self.data_rank
        if self.world == 1:
            out = t.unsqueeze(0).clone()
        elif self._emulated(t):
            out = t.new_zeros((n, *t.shape))
            out[r] = t
            dist.all_reduce(out)
        else:
            out = t.new_empty((n * t.numel(),))
            # all_gather_single is all_gather_into_tensor's newer name
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(out, t.reshape(-1).contiguous())
            out = out.view(n, *t.shape)
        self._count("all_gather", t0, t.numel() * t.element_size())
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place; returns it."""
        t0 = time.perf_counter()
        if self.world > 1:
            dist.broadcast(t, src)
        self._count("broadcast", t0, t.numel() * t.element_size())
        return t

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (..., m) concatenated over the last axis in rank
        order, (..., model * m): an all_reduce of a zero-padded buffer, so
        each value is its rank's exactly."""
        m = t.shape[-1]
        buf = t.new_zeros((*t.shape[:-1], self.model * m))
        buf[..., self.model_rank * m: (self.model_rank + 1) * m] = t
        return self.all_reduce(buf)

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
    collectives. A mesh of one rank joins no group. `data` and `model` may
    not both exceed 1 (`DATA_AND_MODEL`)."""
    if data > 1 and model > 1:
        raise NotImplementedError(DATA_AND_MODEL)
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
    return HostMesh(data=data, model=model, rank=rank, device=device, backend=backend,
                    control_group=control)


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
