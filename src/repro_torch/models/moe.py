"""Mixture-of-Experts FFN with GShard-style capacity dispatch, in PyTorch.

Counterpart of `repro.models.moe`: llama4-maverick (128 experts top-1 and a
shared expert) and arctic (128 experts top-2; its dense residual branch
lives in the block, models/transformer.py). The router stays dense and
exact; each expert projection is a LUT site whose per-expert int8 tables
share one set of codebooks per layer.

Routing is the reference's, step for step, so that the same logits drop the
same tokens: routing groups of `group_tokens` (halved until they divide S),
capacity max(k, int(1.25 k S / E) + 1) per expert and group, top-k by argmax
(the lowest index wins a tie) over the fp32 softmax, slots in token order by
a cumsum.

The expert contraction is plain tensor ops, as in the reference (no Pallas
kernel there, no CUDA kernel here). Two departures that leave every value
as the reference computes it: only the experts that received a token run
(an idle expert's output is multiplied by a combine weight of 0, so it adds
nothing to any gradient either), and they run in chunks of experts, so that
neither a dense site's weight converted to the compute dtype nor a LUT
site's gathered table rows are ever materialized for all experts at once
(arctic at full width: 128 x 7168 x 4864 per site). A LUT_INFER site reads
each token's C table rows by its codes and sums them: in int32 and rescaled
once with `int8_dot` (the reference's int8 one-hot dot, exact), else
dequantized in fp32, the reference's one-hot product over the dequantized
table with its zero terms left out.

A LUT_TRAIN site ({"w" frozen, "centroids" shared by the experts, "log_t"})
rebuilds each routed expert's (C, K, F) table from its frozen weight and
fake-quantizes it with one symmetric scale per (expert, codebook), the
straight-through estimator for the encoding, as the reference does. With
gradients on, each chunk is recomputed in the backward pass instead of
keeping its tables (`torch.utils.checkpoint`): a layer's saved state is its
chunks' inputs, not E tables. As in the reference, the expert sites never
record to an activation tape.

Expert parallelism (`distributed/tensor_parallel.py`): a tensor-parallel
rank holds E / ep experts whole (`MoECfg.ep`), routes every token with the
replicated router (so routing and capacity are the same on every rank),
runs the tokens routed to its experts and all-reduces its share of the
combine in fp32, once per layer, before the shared expert or the dense
residual is added. Each expert's output is the unsharded site's on the
same input; the combined sum may round otherwise (at most top-k nonzero
terms per token, summed across ranks instead of in one contraction).

Training on a ("data", "model") mesh splits each model column's E / ep
experts over the data ranks too (`MoECfg.ep_data`): rank (d, m) holds
experts (m ep_data + d) E / (ep ep_data) onwards. Each rank routes its
data rows' tokens (routing groups never span two rows, so the routing and
the capacity drops are the single rank's), builds the dispatch of its
column's experts, sends each data rank the slots of its experts by an
all-to-all over "data", contracts its experts on every data rank's tokens,
sends the outputs back by the inverse all-to-all, combines its column's
share and sums it over "model". The layer's input passes a `sharded.copy`
(the router and the experts take their gradient through the rank's column
only); the load-balance value, which every model rank computes whole,
passes its gradient scaled by 1 / ep, so that the step's model-axis sum of
the router's gradient counts it once; its token and probability fractions
are the data axis' means, the global batch's, as the single rank's."""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import amm, pq, quant
from repro_torch.core.amm import LUTConfig, Mode
from repro_torch.core.temperature import init_log_temperature
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import sharded
from repro_torch.models.common import (
    ParamSpec,
    Params,
    SiteCfg,
    activation,
    linear,
    linear_init,
    linear_specs,
    tape_active,
)

# bytes of the per-chunk working set (a dense chunk's weights in the compute
# dtype, a LUT chunk's gathered rows in fp32) that bounds the experts per chunk
CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class ExpertSiteCfg:
    """Expert-stacked linear site: (E, Cap, d_in) -> (E, Cap, d_out)."""

    n_experts: int
    d_in: int
    d_out: int
    mode: Mode
    lut: LUTConfig


def _scale_shape(s: ExpertSiteCfg) -> tuple[int, ...]:
    """The deployed scale layout per the site's policy (the reference's)."""
    c = s.lut.codebooks(s.d_in)
    if s.lut.int8_dot or s.lut.use_kernel:
        return (s.n_experts, 1, 1, s.d_out)
    if s.lut.per_column:
        return (s.n_experts, c, 1, s.d_out)
    return (s.n_experts, c, 1, 1)


def expert_linear_specs(s: ExpertSiteCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `expert_linear_init`'s params."""
    w = ParamSpec((s.n_experts, s.d_in, s.d_out), dtype)
    if s.mode == Mode.DENSE:
        return {"w": w}
    c = s.lut.codebooks(s.d_in)
    if s.mode == Mode.LUT_TRAIN:
        return {"w": w, "centroids": ParamSpec((c, s.lut.k, s.lut.v), torch.float32),
                "log_t": ParamSpec((), torch.float32)}
    return {"centroids": ParamSpec((c, s.lut.k, s.lut.v), torch.float32),
            "table_q": ParamSpec((s.n_experts, c, s.lut.k, s.d_out), torch.int8),
            "table_scale": ParamSpec(_scale_shape(s), torch.float32)}


_PART: contextvars.ContextVar[tuple[int, int] | None] = contextvars.ContextVar(
    "repro_torch_expert_part", default=None)


@contextlib.contextmanager
def expert_part(j: int, n: int) -> Iterator[None]:
    """While active, `expert_linear_init` keeps the j-th of n equal parts of
    each expert stack (a tensor-parallel training rank's experts,
    `distributed.tensor_parallel.init_rank`), drawing every expert all the
    same: the kept experts are the whole init's."""
    token = _PART.set((j, n))
    try:
        yield
    finally:
        _PART.reset(token)


def expert_linear_init(gen: torch.Generator, s: ExpertSiteCfg, *, dtype=torch.float32,
                       device="cpu") -> Params:
    """DENSE {"w": N(0, 1/d_in) (E, d_in, d_out)}; LUT_TRAIN {"w" (frozen),
    "centroids": N(0, 0.02^2) (C, K, V) shared by the experts, "log_t": 0};
    LUT_INFER {"centroids", "table_q": uniform int8 in [-127, 126] (E, C,
    K, d_out), "table_scale": 0.02}. The weight is drawn one expert at a
    time (no fp32 copy of every expert's weight); under `expert_part` (the
    trained modes) only the part's experts are kept."""
    specs = expert_linear_specs(s, dtype)
    part = _PART.get()
    lo, hi = (0, s.n_experts) if part is None else (
        part[0] * s.n_experts // part[1], (part[0] + 1) * s.n_experts // part[1])
    if s.mode in (Mode.DENSE, Mode.LUT_TRAIN):
        w = torch.empty((hi - lo, *specs["w"].shape[1:]), dtype=dtype, device=device)
        for e in range(s.n_experts):
            draw = torch.randn((s.d_in, s.d_out), generator=gen, device=gen.device)
            if lo <= e < hi:
                w[e - lo] = (draw.to(device) * (1.0 / s.d_in ** 0.5)).to(dtype)
        if s.mode == Mode.DENSE:
            return {"w": w}
        return {"w": w,
                "centroids": torch.randn(specs["centroids"].shape, generator=gen,
                                         device=gen.device).to(device) * 0.02,
                "log_t": init_log_temperature(device=device)}
    return {
        "centroids": torch.randn(specs["centroids"].shape, generator=gen,
                                 device=gen.device).to(device) * 0.02,
        "table_q": torch.randint(-127, 127, specs["table_q"].shape, generator=gen,
                                 device=gen.device, dtype=torch.int8).to(device),
        "table_scale": torch.full(specs["table_scale"].shape, 0.02, device=device),
    }


def _chunks(n: int, per_expert_bytes: int):
    step = max(1, CHUNK_BYTES // max(per_expert_bytes, 1))
    return [(i, min(n, i + step)) for i in range(0, n, step)]


def _expert_tables_train(p: Params, s: ExpertSiteCfg, experts: torch.Tensor) -> torch.Tensor:
    """(A, C, K, F) fake-quantized tables of the experts `experts`, rebuilt
    from their frozen weights (gradient stopped) in the weights' dtype: one
    symmetric scale per (expert, codebook) over (K, F), the reference's
    per-codebook policy whatever the site's deploy layout."""
    t = pq.build_table(p["centroids"], p["w"].detach()[experts], stop_weight_grad=True)
    return quant.fake_quant(t, bits=s.lut.bits)


def _train_chunk(s: ExpertSiteCfg, p: Params, x: torch.Tensor,
                 experts: torch.Tensor) -> torch.Tensor:
    """One chunk of a LUT_TRAIN site: x (A', Cap, d_in) -> (A', Cap, d_out),
    the straight-through encoding at the learned temperature contracted with
    the chunk's tables."""
    a, cap, _ = x.shape
    dists = pq.pairwise_sq_dists(pq.split_subvectors(x.reshape(a * cap, s.d_in), s.lut.v),
                                 p["centroids"])
    enc = pq.ste_encode(dists, amm.temperature(p["log_t"])).reshape(a, cap, -1).to(x.dtype)
    tables = _expert_tables_train(p, s, experts)
    return torch.bmm(enc, tables.reshape(a, -1, s.d_out).to(x.dtype))


def expert_linear(s: ExpertSiteCfg, p: Params, x: torch.Tensor,
                  experts: torch.Tensor | None = None) -> torch.Tensor:
    """x (A, Cap, d_in) -> (A, Cap, d_out) for the experts `experts` (A
    indices into the site's E; all E when None)."""
    a, cap, _ = x.shape
    ids = torch.arange(a, device=x.device) if experts is None else experts
    if s.mode == Mode.DENSE:
        w = p["w"]
        return torch.cat([torch.bmm(x[i:j], w[ids[i:j]].to(x.dtype))
                          for i, j in _chunks(a, s.d_in * s.d_out * x.element_size())])
    c = p["centroids"].shape[0]
    if s.mode == Mode.LUT_TRAIN:
        per = (s.d_in * s.d_out * p["w"].element_size() + 3 * c * s.lut.k * s.d_out * 4
               + 3 * cap * c * s.lut.k * 4)
        # recompute each chunk in backward, where there is one (and no tape)
        remat = torch.is_grad_enabled() and not tape_active()
        out = []
        for i, j in _chunks(a, per):
            args = (s, p, x[i:j], ids[i:j])
            out.append(checkpoint(_train_chunk, *args, use_reentrant=False) if remat
                       else _train_chunk(*args))
        return torch.cat(out)

    cents = p["centroids"]
    xf = x.reshape(a * cap, s.d_in)
    codes = torch.argmin(pq.pairwise_sq_dists(pq.split_subvectors(xf, s.lut.v), cents),
                         dim=-1).reshape(a, cap, c)
    tq, scale = p["table_q"], p["table_scale"]
    cb = torch.arange(c, device=x.device)
    out = []
    for i, j in _chunks(a, cap * c * s.d_out * 4):
        e = ids[i:j]
        # (A', Cap, C, d_out): row codes[a, n, c] of expert e's table c
        rows = tq[e[:, None, None], cb[None, None, :], codes[i:j]]
        if s.lut.int8_dot:
            acc = rows.to(torch.int32).sum(dim=2)
            out.append((acc.float() * scale[e].reshape(j - i, 1, s.d_out)).to(x.dtype))
        else:
            sc = scale[e][:, :, 0, :][:, None]                    # (A', 1, C|1, d_out|1)
            out.append((rows.float() * sc).to(x.dtype).sum(dim=2))
    return torch.cat(out)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    router: SiteCfg                      # always DENSE
    gate: ExpertSiteCfg
    up: ExpertSiteCfg
    down: ExpertSiteCfg
    shared: object | None = None         # an MLPCfg for a shared expert
    act: str = "silu"
    capacity_factor: float = 1.25
    group_tokens: int = 1024
    # expert parallelism: the tensor-parallel degree the experts are split
    # over (the expert sites then hold n_experts / ep experts: the rank's)
    ep: int = 1
    # in training on a ("data", "model") mesh: the data-parallel degree each
    # model column's experts are split over (the sites then hold n_experts /
    # (ep * ep_data)); tokens reach them by an all-to-all over "data"
    ep_data: int = 1


def moe_init(gen: torch.Generator, cfg: MoECfg, *, dtype=torch.float32, device="cpu") -> Params:
    p: Params = {
        "router": linear_init(gen, cfg.router, dtype=torch.float32, device=device),
        "gate": expert_linear_init(gen, cfg.gate, dtype=dtype, device=device),
        "up": expert_linear_init(gen, cfg.up, dtype=dtype, device=device),
        "down": expert_linear_init(gen, cfg.down, dtype=dtype, device=device),
    }
    if cfg.shared is not None:
        p["shared"] = mlp_mod.mlp_init(gen, cfg.shared, dtype=dtype, device=device)
    return p


def moe_specs(cfg: MoECfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `moe_init`'s params (the router fp32 whatever `dtype`)."""
    p: Params = {"router": linear_specs(cfg.router, torch.float32),
                 "gate": expert_linear_specs(cfg.gate, dtype),
                 "up": expert_linear_specs(cfg.up, dtype),
                 "down": expert_linear_specs(cfg.down, dtype)}
    if cfg.shared is not None:
        p["shared"] = mlp_mod.mlp_specs(cfg.shared, dtype)
    return p


def route(cfg: MoECfg, p: Params, x: torch.Tensor):
    """The routing of x (B, S, D): (x in routing groups (G, g, D), the fp32
    router probabilities (G, g, E), dispatch (G, g, E, cap) bool, combine
    weights (G, g, E, cap) in x's dtype, cap). Groups are `group_tokens`
    chunks of the batch-major token stream (halved until they divide S), so
    a group never spans two batch rows; slots fill in token order."""
    b0, s0, d = x.shape
    g_tok = max(1, min(cfg.group_tokens, s0))
    while s0 % g_tok:
        g_tok //= 2
    x = x.reshape(b0 * (s0 // g_tok), g_tok, d)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(k, int(cfg.capacity_factor * k * s / e) + 1)

    logits = linear(cfg.router, p["router"], x.float())              # (B, S, E)
    probs = torch.softmax(logits, dim=-1)

    # top-k routing with per-group capacity (GShard)
    combine = torch.zeros((b, s, e, cap), dtype=x.dtype, device=x.device)
    dispatch = torch.zeros((b, s, e, cap), dtype=torch.bool, device=x.device)
    remaining = probs
    fill = torch.zeros((b, e), dtype=torch.int32, device=x.device)   # slots used
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                         # lowest index on a tie
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot_e = F.one_hot(idx, e).to(torch.int32)                  # (B, S, E)
        pos = fill[:, None, :] + torch.cumsum(onehot_e, dim=1, dtype=torch.int32) - onehot_e
        slot = (onehot_e * pos).sum(dim=-1)                           # (B, S)
        keep = slot < cap
        oh_slot = F.one_hot(slot.clamp_max(cap - 1).long(), cap).to(x.dtype) * keep[..., None]
        d_k = onehot_e.to(x.dtype)[..., None] * oh_slot[:, :, None, :]
        dispatch |= d_k.bool()
        combine = combine + gate.to(x.dtype)[..., None, None] * d_k
        fill = fill + (onehot_e * keep[..., None].to(torch.int32)).sum(dim=1, dtype=torch.int32)
        remaining = remaining * (1.0 - F.one_hot(idx, e).to(probs.dtype))
    return x, probs, dispatch, combine, cap


def _load_balance(cfg: MoECfg, probs: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance value E * sum_e f_e P_e / k; on a mesh with a
    data axis, f and P the data ranks' means (every rank's rows hold the
    same number of routing groups: the global batch's fractions)."""
    frac = torch.stack([dispatch.sum(dim=-1).float().mean(dim=(0, 1)),
                        probs.mean(dim=(0, 1))])
    mesh = sharded.current()
    if mesh is not None and mesh.data > 1:
        frac = sharded.mean_over_data(frac, mesh)
    aux = cfg.n_experts * (frac[0] * frac[1]).sum() / cfg.top_k
    # computed whole on every model rank: its gradient once over the model sum
    return sharded.scale_grad(aux, 1.0 / cfg.ep)


def _contract(cfg: MoECfg, p: Params, xin: torch.Tensor, sent: torch.Tensor) -> torch.Tensor:
    """The expert FFN of the site params' experts on their slots xin (n,
    rows, D): gate, up, act and down of the experts `sent` marks, zero for
    the others (an expert may receive no token). On the meta device (a dry
    run) which experts received a token is unknown: every expert counts as
    active, the work the reference's GShard einsum computes (every expert's
    capacity slots)."""
    active = (torch.arange(sent.shape[0], device=sent.device) if sent.is_meta
              else sent.nonzero()[:, 0])
    h = xin.new_zeros(xin.shape)
    if active.numel():
        xa = xin[active]
        g = activation(cfg.act, expert_linear(cfg.gate, p["gate"], xa, active))
        u = expert_linear(cfg.up, p["up"], xa, active)
        h = h.index_copy(0, active, expert_linear(cfg.down, p["down"], g * u, active))
    return h


def _experts(cfg: MoECfg, p: Params, x: torch.Tensor, disp: torch.Tensor,
             cap: int) -> torch.Tensor:
    """The outputs (n, G*cap, D) of the n experts of `disp` (G, g, n, cap)
    (a column's, or all E) on their slots of x (G, g, D); zero for an expert
    that receives no token. With `ep_data` > 1 the column's experts live on
    its data ranks: the slots go to their expert's rank and back by
    all-to-alls over "data"."""
    b, _, d = x.shape
    n = disp.shape[2]
    xin = torch.einsum("bsec,bsd->ebcd", disp.to(x.dtype), x).reshape(n, b * cap, d)
    sent = disp.any(dim=3).any(dim=1).any(dim=0)
    dd = cfg.ep_data
    if dd > 1:
        mesh = sharded.current()
        n_e = n // dd
        # which of the column's experts any data rank sends a token to
        sent = mesh.all_reduce(sent.to(torch.int32), sharded.DATA) > 0
        sent = sent.reshape(dd, n_e)[mesh.data_rank]
        # (dd, n_e, G*cap, D): row p the slots of data rank p's experts
        xin = sharded.all_to_all_data(xin.reshape(dd, n_e, b * cap, d), mesh)
        xin = xin.transpose(0, 1).reshape(n_e, dd * b * cap, d)
    h = _contract(cfg, p, xin, sent)
    if dd > 1:
        # back to the slots' data ranks: row p the outputs of data rank p's experts
        h = h.reshape(n_e, dd, b * cap, d).transpose(0, 1)
        h = sharded.all_to_all_data(h, mesh).reshape(n, b * cap, d)
    return h


def moe(cfg: MoECfg, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux): routed by `route`; aux is the Switch
    load-balance value E * sum_e f_e P_e / k (training's; serving drops
    it)."""
    b0, s0, d = x.shape
    # an expert-parallel layer's router and experts see the rank's column only
    xs, probs, dispatch, combine, cap = route(cfg, p, sharded.copy(x) if cfg.ep > 1 else x)
    b, e = xs.shape[0], cfg.n_experts
    aux = _load_balance(cfg, probs, dispatch)

    # the experts held here: all E, or a tensor-parallel rank's column of E / ep
    n_col = e // cfg.ep
    lo = 0 if cfg.ep == 1 else sharded.model_rank() * n_col
    disp, comb = dispatch[:, :, lo:lo + n_col], combine[:, :, lo:lo + n_col]
    h = _experts(cfg, p, xs, disp, cap).reshape(n_col, b, cap, d)
    if cfg.ep == 1:
        y = torch.einsum("bsec,ebcd->bsd", comb, h)
    else:
        # the column's share of the combine, summed over the model ranks in fp32
        y = sharded.reduce(torch.einsum("bsec,ebcd->bsd", comb.float(), h.float())).to(x.dtype)

    if cfg.shared is not None:           # its own column/row pair: the layer's input
        y = y + mlp_mod.mlp(cfg.shared, p["shared"], x.reshape(xs.shape))
    return y.reshape(b0, s0, d), aux
