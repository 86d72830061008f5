"""A tensor-parallel rank's pieces of the forward: sharded sites, the
vocab-sharded embedding and the tied logits.

A rank's bundle (`distributed.tensor_parallel.local_bundle`) names each
sharded site's role in its config (`common.SiteCfg.tp`: "col", "col_gather"
or "row") and whether the embedding is vocab-sharded
(`transformer.LMCfg.vocab_sharded`); the configs stay pure data. The mesh
the collectives run on is bound for the length of one forward
(`ModelBundle.forward_step(mesh=)`, `bound`); it needs `model_rank`,
`all_reduce` (a sum over the model axis, in place) and `gather_last` (every
rank's last-axis block, in rank order).

  * a column-parallel site ("col") runs on its M shard of table_q (and of
    an m-shared table_scale and of the bias): its output columns stay on the
    rank; "col_gather" gathers them (an untied head's vocab columns);
  * a row-parallel site ("row": o, down) runs on its C shard of centroids
    and table_q, and takes the rank's columns of the input. A LUT site with
    an m-shared scale runs its kernel with unit scales and no bias, which
    gives float(int32) accumulators exactly (|acc| <= C * 127),
    all_reduces them, and applies the unsharded epilogue (scale, bias fused
    as the kernels fuse it, cast): its output is the unsharded site's
    bytewise. Other scale layouts and dense sites reduce fp32 partials;
  * the embedding is vocab-sharded (masked lookup, then all_reduce) and the
    tied logits vocab-sharded and gathered.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Iterator

import torch

from repro_torch.core import pq
from repro_torch.core.amm import Mode, lut_linear
from repro_torch.kernels.ref import fma_f32

_MESH: contextvars.ContextVar[Any] = contextvars.ContextVar("repro_torch_tp_mesh",
                                                           default=None)


@contextlib.contextmanager
def bound(mesh: Any) -> Iterator[None]:
    """Run the enclosed forward's sharded pieces on `mesh`."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def _mesh() -> Any:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("a tensor-parallel rank's bundle runs under "
                           "ModelBundle.forward_step(mesh=)")
    return mesh


@functools.lru_cache(maxsize=64)
def _unit_scale(m: int, device: str) -> torch.Tensor:
    return torch.ones((1, 1, m), dtype=torch.float32, device=device)


def _row_lut(site, p, x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel LUT_INFER site on the rank's C shard; (N, M) fp32."""
    lut = site.lut
    scale = p["table_scale"]
    b = p.get("b")
    if scale.shape[0] == 1 and (lut.use_kernel or lut.int8_dot):
        # exact integer accumulators, reduced, then the unsharded epilogue
        if lut.use_kernel:
            from repro_torch.kernels import ops

            acc = ops.lut_amm(x.float(), p["centroids"], p["table_q"],
                              _unit_scale(scale.shape[-1], str(x.device)))
        else:
            idx = pq.encode_indices(x, p["centroids"])
            acc = pq.gather_lut(idx, p["table_q"].to(torch.int32)).float()
        mesh.all_reduce(acc)
        s = scale.reshape(1, -1).expand_as(acc)
        if b is None:
            return acc * s
        if lut.use_kernel:                          # the kernels' fused bias add
            return fma_f32(acc, s, b.float().expand_as(acc))
        return acc * s + b.float()
    part = lut_linear(lut, Mode.LUT_INFER, {k: v for k, v in p.items() if k != "b"}, x.float())
    mesh.all_reduce(part)
    return part + b.float() if b is not None else part


def linear(site, p, x: torch.Tensor) -> torch.Tensor:
    """One sharded site on a rank, by its role (`SiteCfg.tp`)."""
    mesh = _mesh()
    if site.tp.startswith("col"):
        y = lut_linear(site.lut, site.mode, p, x)
        return mesh.gather_last(y.float()).to(y.dtype) if site.tp == "col_gather" else y
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if site.mode == Mode.LUT_INFER:
        y = _row_lut(site, p, xf, mesh)
    else:
        y = mesh.all_reduce(xf.float() @ p["w"].float())
        if p.get("b") is not None:
            y = y + p["b"].float()
    return y.reshape(*lead, -1).to(x.dtype)


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    """The embedding lookup from a rank's vocab rows: the other ranks' ids
    give zeros, and the sum over ranks is each row of the unsharded lookup
    exactly."""
    mesh, table = _mesh(), p["table"]
    n = table.shape[0]
    local = ids.long() - mesh.model_rank * n
    ok = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].float()
    x = torch.where(ok[..., None], rows, torch.zeros((), device=rows.device))
    return mesh.all_reduce(x).to(table.dtype)


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits of the tied head from a rank's vocab rows, gathered."""
    return _mesh().gather_last((x @ table.to(x.dtype).T).float()).to(x.dtype)
