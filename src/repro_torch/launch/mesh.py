"""The host mesh of a tensor-parallel run, over `torch.distributed` ranks.

Counterpart of `repro.launch.mesh.make_host_mesh`. One process per rank;
each rank calls `make_host_mesh(data=1, model=tp, rank=r, devices=...)`,
which joins the process group and gives the rank its explicit device,
`devices[rank]`. The backend is NCCL when every rank has a card of its own,
and gloo when ranks share a device: on the CPU, or several ranks on one
card (each rank its own process and CUDA context). `HostMesh.backend` says
which.

Gloo takes CUDA tensors only for `all_reduce` and `broadcast`, so every
collective of the tensor-parallel path is one of those two: a gather is an
`all_reduce` of a zero-padded buffer (`gather_last`). The engine's control
messages (the scheduler's token rows, positions, slot masks, page tables)
are int64 host tensors broadcast over a gloo control group of their own
(`broadcast_ints`), beside the default group that carries the forward's
all-reduces. A follower waits in the control group until the leader's next
message, so that group never times out an idle server (`CONTROL_TIMEOUT_S`);
the forward's collectives fail within `timeout_s` (`DATA_TIMEOUT_S`) when a
peer stops answering. The mesh counts its collectives and the host time
spent in them (`counters`).
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
    counters: dict = dataclasses.field(default_factory=lambda: {
        "all_reduce": 0, "all_reduce_s": 0.0, "all_reduce_bytes": 0})

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def reset_counters(self) -> None:
        for k in self.counters:
            self.counters[k] = 0 if isinstance(self.counters[k], int) else 0.0

    # ------------------------------------------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the model axis, in place; returns it."""
        t0 = time.perf_counter()
        dist.all_reduce(t)
        self.counters["all_reduce_s"] += time.perf_counter() - t0
        self.counters["all_reduce"] += 1
        self.counters["all_reduce_bytes"] += t.numel() * t.element_size()
        return t

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
        if dist.is_initialized():
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
    forward's collectives. Only data = 1 (pure tensor parallelism) is
    served."""
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
