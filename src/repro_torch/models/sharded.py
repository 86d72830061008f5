"""A tensor-parallel rank's pieces of the forward: sharded sites, the
vocab-sharded embedding, the tied logits and the vocab-parallel loss, the
MoE combine's reduction and the mamba2 block's gated norm.

A rank's bundle (`distributed.tensor_parallel.local_bundle`) names each
sharded site's role in its config (`common.SiteCfg.tp`: "col", "col_gather"
or "row") and whether the embedding is vocab-sharded
(`transformer.LMCfg.vocab_sharded`); the configs stay pure data. The mesh
the collectives run on is bound for the length of one forward
(`ModelBundle.forward_step(mesh=)`, `ModelBundle.loss(mesh=)`, `bound`); it
needs `model_rank`, `all_reduce` (a sum, in place), `all_max` and
`gather_last`, each on the "model" axis, and for experts over both axes
`data_rank`, `all_to_all` and `all_mean` on the "data" axis.

  * a column-parallel site ("col") runs on its M shard of table_q (and of
    an m-shared table_scale and of the bias), or of a LUT_TRAIN or DENSE
    site's `w` and `b`: its output columns stay on the rank; "col_gather"
    gathers them (an untied head's vocab columns, in serving);
  * a row-parallel site ("row": o, down) runs on its C shard of centroids
    and table_q (or of a LUT_TRAIN site's centroids and `w` rows), and
    takes the rank's columns of the input. A LUT_INFER site with an
    m-shared scale runs its kernel with unit scales and no bias, which
    gives float(int32) accumulators exactly (|acc| <= C * 127),
    all_reduces them, and applies the unsharded epilogue (scale, bias fused
    as the kernels fuse it, cast): its output is the unsharded site's
    bytewise. Other scale layouts, LUT_TRAIN and dense sites reduce fp32
    partials and add the bias once, after the reduce;
  * a LUT_TRAIN shard fake-quantizes with the unsharded table's scale: the
    layouts whose max runs over the split axis (the per-codebook (C, 1, 1)
    scale of a column site, the m-shared (1, 1, M) scale of a row site)
    take the max of every rank's absmax (`all_max`); per-column scales are
    local to either role;
  * the embedding is vocab-sharded (masked lookup, then all_reduce); the
    tied logits are vocab-sharded and gathered in serving, and stay
    vocab-sharded in training, where `vocab_cross_entropy` reduces the row
    max, the sum of exponentials and the target logit over the model axis;
  * an expert-parallel MoE layer's combined output is all-reduced in fp32
    (`reduce`, `model_rank` names the rank's experts; in training on a
    ("data", "model") mesh the column's experts are split over the data
    ranks too, `moe.moe`);
  * a mamba2 rank's gated norm gathers the gated activations of every
    rank's heads and normalizes the whole d_inner row, as the unsharded
    block does, then keeps the rank's columns (`gated_rmsnorm`).

Training differentiates through the model axis with two autograd
functions, as Megatron places them: `copy` (identity forward, model-axis
all-reduce backward) in front of every column-parallel consumer (q/k/v
together, gate/up together, a mamba2 block's in_proj, an expert-parallel
MoE layer, the vocab head), and `reduce` (model-axis all-reduce forward,
identity backward) after every row-parallel site, the MoE combine and the
vocab-sharded lookup. Both are the identity / the plain all_reduce where no
gradient is taken, so a serving forward runs as before. The gated norm's
gather has the reduce-scatter for its backward (`gated_rmsnorm`). On a
("data", "model") mesh the experts are split over both axes: an autograd
all-to-all over "data" (`all_to_all_data`, its own inverse backward) takes
each token to its expert's rank and the expert's output back, and the MoE
load-balance statistics are the data axis' mean (`mean_over_data`, an
identity backward: each data rank's step is then the global step's part,
and the step's data mean of the gradients completes it). Each keeps the
mesh it was built with for its backward, which runs on the autograd
engine's device thread, where `bound`'s context variable is not set; a
recomputed block re-binds the mesh (`transformer._seg_apply`,
`hybrid.hybrid_apply`).

Under FSDP (`ShardingRules(fsdp=True)`) a rank holds only its "data" part
of the leaves the spec splits over "data" too (`tensor_parallel.Layout.
fsdp`; a rank's config names them, `transformer.LMCfg.fsdp`,
`hybrid.HybridCfg.fsdp`). `gather_data` gathers them where they are read:
a block's inside its recomputed function, so that the recomputation
gathers them again and no block's gathered weights are kept for the
backward, the embedding once per forward (the lookup and the tied
logits), the hybrid's shared block once per forward. Its backward is a
reduce-scatter over "data" scaled by 1 / dp: each rank's slice of the data
axis' mean gradient, as the step's data mean gives a replicated leaf.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from repro_torch.core import pq
from repro_torch.core.amm import Mode, lut_linear, lut_train_contract
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


def current() -> Any:
    """The bound mesh, or None."""
    return _MESH.get()


def _mesh() -> Any:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("a tensor-parallel rank's bundle runs under "
                           "ModelBundle.forward_step(mesh=) or ModelBundle.loss(mesh=)")
    return mesh


AXIS = "model"
DATA = "data"


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), AXIS), None


class _Reduce(torch.autograd.Function):
    """The sum over the model axis forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """The all-to-all over the data axis forward, and backward (it is its own
    inverse: row p goes to data rank p, and comes back from it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(x.contiguous(), DATA)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), DATA), None


class _MeanData(torch.autograd.Function):
    """The mean over the data axis forward; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_mean(x.contiguous().clone(), DATA)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """Every model rank's columns gathered forward; backward, the sum over
    the model axis of every rank's gradient of the whole row, then the
    rank's columns (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.m = mesh, x.shape[-1]
        return mesh.gather_last(x.contiguous(), AXIS)

    @staticmethod
    def backward(ctx, g):
        full = ctx.mesh.all_reduce(g.contiguous().clone(), AXIS)
        r, m = ctx.mesh.model_rank, ctx.m
        return full[..., r * m:(r + 1) * m].contiguous(), None


class _GatherData(torch.autograd.Function):
    """Every data rank's part of a weight gathered along `dim` forward;
    backward, the data axis' mean of the whole weight's gradient, the
    rank's part of it (a reduce-scatter in fp32, or float64 for a float64
    gradient, then / dp)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather_dim(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        part = ctx.mesh.reduce_scatter(g.to(torch.promote_types(g.dtype, torch.float32)),
                                       ctx.dim, DATA)
        return part.div_(ctx.mesh.size(DATA)).to(g.dtype), None, None


def _all_gather_dim(mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every data rank's `t` concatenated along `dim` in rank order."""
    out = mesh.all_gather(t.contiguous(), DATA)                 # (n, *t.shape)
    return out.movedim(0, dim).flatten(dim, dim + 1)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times `s`."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _differentiated(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def copy(x: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """`x` in front of column-parallel consumers: its gradient is the sum of
    every rank's (the identity where no gradient is taken)."""
    if not _differentiated(x):
        return x
    return _Copy.apply(x, mesh or _mesh())


def reduce(x: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """The sum of every rank's `x` over the model axis (in place where no
    gradient is taken); the gradient passes through to each rank's part."""
    mesh = mesh or _mesh()
    if not _differentiated(x):
        return mesh.all_reduce(x, AXIS)
    return _Reduce.apply(x, mesh)


def all_to_all_data(x: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """`x` (data, ...): row p to data rank p; returns (data, ...) whose row p
    came from data rank p. Its gradient takes the way back."""
    mesh = mesh or _mesh()
    if not _differentiated(x):
        return mesh.all_to_all(x.contiguous(), DATA)
    return _AllToAll.apply(x, mesh)


def mean_over_data(x: torch.Tensor, mesh: Any = None) -> torch.Tensor:
    """The mean of every data rank's `x`; the gradient reaches each rank's
    own `x` whole (the step's data mean of the gradients divides it)."""
    mesh = mesh or _mesh()
    if not _differentiated(x):
        return mesh.all_mean(x.contiguous().clone(), DATA)
    return _MeanData.apply(x, mesh)


def data_dims(fsdp: tuple | dict, prefix: str) -> dict[str, int]:
    """{path under `prefix`: dim} of the data-split leaves `fsdp` ({reference
    path: dim of the rank's per-layer leaf}) names under `prefix`."""
    return {p[len(prefix):]: d for p, d in dict(fsdp).items() if p.startswith(prefix)}


def gather_data(p, dims: dict[str, int], mesh: Any = None):
    """The tree `p` (nested dicts) with each leaf at a path of `dims`
    gathered over the data axis along its dim (`_GatherData` where a
    gradient is taken); the other leaves as they are."""
    if not dims:
        return p
    mesh = mesh or _mesh()

    def walk(t, path: str):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        d = dims.get(path)
        if d is None or t is None:
            return t
        return _GatherData.apply(t, mesh, d) if _differentiated(t) else \
            _all_gather_dim(mesh, t, d)

    return walk(p, "")


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """`x`, its gradient times `s` (a value every model rank computes whole,
    whose gradient the step sums over the model axis: s = 1 / tp)."""
    if not _differentiated(x) or s == 1:
        return x
    return _ScaleGrad.apply(x, s)


def _absmax_over_model(site, mesh):
    """The `reduce_absmax` of a LUT_TRAIN shard (`quant.table_scale`): the
    max over the model axis where the scale layout's max runs over the
    split axis (M for a column site's per-codebook scale, C for a row
    site's m-shared one), else None."""
    lut, col = site.lut, site.tp.startswith("col")
    # m-shared (1, 1, M) first, as `quant.table_scale` takes it
    over_split = (not col) if lut.int8_dot else (col and not lut.per_column)
    return (lambda a: mesh.all_max(a, AXIS)) if over_split else None


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
        mesh.all_reduce(acc, AXIS)
        s = scale.reshape(1, -1).expand_as(acc)
        if b is None:
            return acc * s
        if lut.use_kernel:                          # the kernels' fused bias add
            return fma_f32(acc, s, b.float().expand_as(acc))
        return acc * s + b.float()
    part = lut_linear(lut, Mode.LUT_INFER, {k: v for k, v in p.items() if k != "b"}, x.float())
    mesh.all_reduce(part, AXIS)
    return part + b.float() if b is not None else part


def linear(site, p, x: torch.Tensor) -> torch.Tensor:
    """One sharded site on a rank, by its role (`SiteCfg.tp`). A column
    site's caller has put `copy` in front of its input."""
    mesh = _mesh()
    if site.tp.startswith("col"):
        if site.mode == Mode.LUT_TRAIN:
            y = lut_linear(site.lut, site.mode, p, x, frozen=p,
                           reduce_absmax=_absmax_over_model(site, mesh))
        else:
            y = lut_linear(site.lut, site.mode, p, x)
        return mesh.gather_last(y.float(), AXIS).to(y.dtype) if site.tp == "col_gather" else y
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if site.mode == Mode.LUT_INFER:
        y = _row_lut(site, p, xf, mesh)
    else:
        if site.mode == Mode.LUT_TRAIN:
            part = lut_train_contract(site.lut, p, p["w"], xf,
                                      reduce_absmax=_absmax_over_model(site, mesh))
        else:
            part = xf.float() @ p["w"].float()
        y = reduce(part, mesh)
        if p.get("b") is not None:
            y = y + p["b"].float()
    return y.reshape(*lead, -1).to(x.dtype)


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    """The embedding lookup from a rank's vocab rows: the other ranks' ids
    give zeros, and the sum over ranks is each row of the unsharded lookup
    exactly. Its gradient reaches only the rank's rows."""
    mesh, table = _mesh(), p["table"]
    n = table.shape[0]
    local = ids.long() - mesh.model_rank * n
    ok = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].float()
    x = torch.where(ok[..., None], rows, torch.zeros((), device=rows.device))
    return reduce(x, mesh).to(table.dtype)


def tied_logits(x: torch.Tensor, table: torch.Tensor, *, gather: bool = True) -> torch.Tensor:
    """Logits of the tied head from a rank's vocab rows: gathered, or (in
    training) the rank's vocab columns."""
    mesh = _mesh()
    logits = copy(x, mesh) @ table.to(x.dtype).T
    if not gather:
        return logits
    return mesh.gather_last(logits.float(), AXIS).to(x.dtype)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`common.cross_entropy` of vocab-sharded logits (..., vocab / tp), the
    rank's columns in rank order: the row max (detached), the sum of
    exponentials and the target logit (nonzero on the rank that holds it)
    summed over the model axis. No rank holds a whole row. Every rank gets
    the same mean loss; the gradient reaches each rank's columns."""
    mesh = _mesh()
    lf = logits.float()
    n = lf.shape[-1]
    with torch.no_grad():
        m = mesh.all_max(lf.amax(dim=-1), AXIS)
    sum_exp = reduce(torch.exp(lf - m[..., None]).sum(dim=-1), mesh)
    local = labels.long() - mesh.model_rank * n
    ok = (local >= 0) & (local < n)
    gold = lf.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce(torch.where(ok, gold, torch.zeros((), device=lf.device)), mesh)
    return (torch.log(sum_exp) + m - gold).mean()


def model_rank() -> int:
    """The rank's index on the model axis of the bound mesh."""
    return _mesh().model_rank


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the model axis of the bound mesh, in place."""
    return _mesh().all_reduce(t, AXIS)


def gated_rmsnorm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """`mamba2._gated_rmsnorm` of a rank's heads: y, z (..., d_inner / tp)
    the rank's columns, `scale` (d_inner,) whole. The gated activations of
    every rank are gathered (fp32, each value its rank's exactly) and the
    whole row normalized as the unsharded block normalizes it; returns the
    rank's columns, the unsharded block's bytewise. In training the
    gather's backward is a reduce-scatter (each rank's output depends on
    the whole row), and `scale` takes a gradient at the rank's columns
    only: a partial leaf, summed over the model axis by the step."""
    mesh = _mesh()
    gated = (y * F.silu(z)).float()
    g = (_GatherModel.apply(gated, mesh) if _differentiated(gated)
         else mesh.gather_last(gated, AXIS))
    var = (g * g).mean(dim=-1, keepdim=True)
    m = y.shape[-1]
    cols = slice(mesh.model_rank * m, (mesh.model_rank + 1) * m)
    return (g[..., cols] * torch.rsqrt(var + eps) * scale[cols].float()).to(y.dtype)
