"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block.

Counterpart of `repro.models.hybrid` (arXiv:2411.15242). The shared block
(attention + MLP, one set of weights) runs after every `attn_every` mamba
layers; its input is a learned fusion of the hidden state with the original
embeddings (concat -> the dense `fuse` site), and its output is projected
back into the residual stream (`out`). Each invocation has its own KV cache
and the same weights, so a LUT deployment's shared tables serve every
invocation.

The mamba layers are a list of per-layer dicts ("mamba_stack"; the
reference stacks them on a leading axis, `weights.py` converts). Caches are
{"mamba": {"conv", "ssm"} stacked over the L layers, "attn": {"k", "v"} (or
the paged {"k_pool", "v_pool"}) stacked over the invocations}; a forward
updates them in place: the mamba state of the rows it may write
(`transformer.StateRows`), the K/V where `write_index` says. The shared
block attends as the reference's does, without the deferred slab write.

A training forward (no caches, gradients on) recomputes each mamba layer in
the backward pass, as the reference's scan does with remat. Under an
activation tape the mamba layers record as 'mamba_stack/<j>/<site>' and
every invocation of the shared block under the one prefix 'shared': its
records pool over the invocations, as in the reference.

A tensor-parallel rank (`distributed/tensor_parallel.py`) runs the same
loop on its shard: the mamba layers on its SSD heads, the shared block on
its attention heads and MLP columns (its per-invocation KV caches, dense or
paged, hold its KV heads), the embedding and the tied logits on its vocab
rows (`HybridCfg.vocab_sharded`). A training rank keeps its vocab columns
of the logits (`HybridCfg.gather_logits` off; `sharded.vocab_cross_entropy`),
its recomputed mamba layers re-bind the mesh, and the shared block's heads
and MLP columns take their gradient from every invocation. An FSDP rank
(`HybridCfg.fsdp`) gathers a mamba layer's data-split leaves inside its
recomputed function, and the embedding's and the shared block's once per
forward (`sharded.gather_data`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import sharded
from repro_torch.models.common import (
    ParamSpec,
    Params,
    SiteCfg,
    embed,
    embed_init,
    linear,
    linear_init,
    linear_specs,
    rmsnorm,
    rmsnorm_init,
    set_tape_prefix,
)
from repro_torch.models.transformer import (
    BlockCfg,
    StateRows,
    block_apply,
    block_init,
    block_specs,
    kept,
    _train_block_on,
    remat_active,
    zeros_like_specs,
)


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    vocab: int
    d_model: int
    n_layers: int                     # mamba layers
    attn_every: int                   # the shared block after layers k, 2k, ...
    mamba_block: BlockCfg             # kind == "mamba"
    shared_attn: attn_mod.AttnCfg
    shared_mlp: mlp_mod.MLPCfg
    fuse: SiteCfg                     # 2*d_model -> d_model (dense)
    out: SiteCfg                      # d_model -> d_model
    vocab_sharded: bool = False  # a tensor-parallel rank's vocab rows (models/sharded.py)
    gather_logits: bool = True   # False: a training rank's logits stay vocab-sharded
    # FSDP: ((reference path, dim), ...) of the leaves a rank holds its "data" part of
    fsdp: tuple[tuple[str, int], ...] = ()

    @property
    def invocation_points(self) -> tuple[int, ...]:
        return tuple(range(self.attn_every, self.n_layers + 1, self.attn_every))

    @property
    def segment_bounds(self) -> tuple[tuple[int, int], ...]:
        pts = (0, *self.invocation_points)
        segs = [(pts[i], pts[i + 1]) for i in range(len(pts) - 1)]
        if pts[-1] < self.n_layers:
            segs.append((pts[-1], self.n_layers))
        return tuple(segs)


def hybrid_init(gen: torch.Generator, cfg: HybridCfg, *, dtype=torch.float32,
                device="cpu") -> Params:
    return {
        "embed": kept("embed", embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)),
        "mamba_stack": [kept("mamba_stack", block_init(gen, cfg.mamba_block, dtype=dtype,
                                                       device=device))
                        for _ in range(cfg.n_layers)],
        "shared": kept("shared", {
            "fuse": linear_init(gen, cfg.fuse, dtype=dtype, device=device),
            "norm1": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_mod.attn_init(gen, cfg.shared_attn, dtype=dtype, device=device),
            "norm2": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": mlp_mod.mlp_init(gen, cfg.shared_mlp, dtype=dtype, device=device),
            "out": linear_init(gen, cfg.out, dtype=dtype, device=device),
        }),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }


def _stacked(tree, count: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, count) for k, v in tree.items()}
    return ParamSpec((count, *tree.shape), tree.dtype)


def hybrid_param_specs(cfg: HybridCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `hybrid_init`'s params in the reference's layout (the
    mamba layers stacked on a leading axis)."""
    norm = {"scale": ParamSpec((cfg.d_model,), dtype)}
    return {
        "embed": {"table": ParamSpec((cfg.vocab, cfg.d_model), dtype)},
        "mamba_stack": _stacked(block_specs(cfg.mamba_block, dtype), cfg.n_layers),
        "shared": {
            "fuse": linear_specs(cfg.fuse, dtype),
            "norm1": norm,
            "attn": attn_mod.attn_specs(cfg.shared_attn, dtype),
            "norm2": norm,
            "mlp": mlp_mod.mlp_specs(cfg.shared_mlp, dtype),
            "out": linear_specs(cfg.out, dtype),
        },
        "final_norm": norm,
    }


def hybrid_cache_specs(cfg: HybridCfg, b: int, s_max: int, dtype=torch.bfloat16,
                       paged: attn_mod.PagedSpec | None = None) -> Params:
    """{"mamba": per-row state (L, B, ...), "attn": K/V (n_inv, ...)}."""
    n_inv = len(cfg.invocation_points)
    one_m = mamba_mod.mamba2_cache_specs(b, cfg.mamba_block.mamba, dtype)
    a = cfg.shared_attn
    one_a = (attn_mod.paged_cache_specs(paged, a, dtype) if paged is not None
             else {name: ParamSpec((b, s_max, a.n_kv_heads, a.d_head), dtype)
                   for name in ("k", "v")})
    return {"mamba": {k: ParamSpec((cfg.n_layers, *s.shape), s.dtype) for k, s in one_m.items()},
            "attn": {k: ParamSpec((n_inv, *s.shape), s.dtype) for k, s in one_a.items()}}


def hybrid_caches(cfg: HybridCfg, b: int, s_max: int, dtype=torch.bfloat16, device="cpu",
                  paged: attn_mod.PagedSpec | None = None) -> Params:
    return zeros_like_specs(hybrid_cache_specs(cfg, b, s_max, dtype, paged), device)


def _shared_block(cfg: HybridCfg, p: Params, x: torch.Tensor, x0: torch.Tensor, *,
                  pos, cache, cache_len, write_index, block_tables) -> torch.Tensor:
    h = linear(cfg.fuse, p["fuse"], torch.cat([x, x0], dim=-1))
    a, _ = attn_mod.attention(cfg.shared_attn, p["attn"], rmsnorm(p["norm1"], h), pos=pos,
                              cache=cache, cache_len=cache_len, write_index=write_index,
                              block_tables=block_tables)
    h = h + a
    h = h + mlp_mod.mlp(cfg.shared_mlp, p["mlp"], rmsnorm(p["norm2"], h))
    return x + linear(cfg.out, p["out"], h)


def hybrid_apply(cfg: HybridCfg, params: Params, *, tokens: torch.Tensor, pos: torch.Tensor,
                 caches: Params | None = None, cache_len: torch.Tensor | None = None,
                 compute_dtype=torch.float32, write_index=None,
                 block_tables: torch.Tensor | None = None,
                 state: StateRows | None = None) -> tuple[torch.Tensor, Params | None]:
    """Returns (logits (B, S, vocab), caches updated in place)."""
    emb = sharded.gather_data(params["embed"], sharded.data_dims(cfg.fsdp, "embed/"))
    x = (sharded.embed if cfg.vocab_sharded else embed)(emb, tokens)
    x = x.to(compute_dtype)
    x0 = x
    inv = 0
    remat = remat_active(True, caches)
    fsdp = sharded.data_dims(cfg.fsdp, "mamba_stack/")
    shared = (sharded.gather_data(params["shared"], sharded.data_dims(cfg.fsdp, "shared/"))
              if cfg.invocation_points else params["shared"])
    for lo, hi in cfg.segment_bounds:
        for j in range(lo, hi):
            set_tape_prefix(f"mamba_stack/{j}")
            lp = params["mamba_stack"][j]
            if remat:
                x, _ = checkpoint(_train_block_on, sharded.current(), cfg.mamba_block, lp, x,
                                  pos, fsdp, use_reentrant=False)
                continue
            lp = sharded.gather_data(lp, fsdp)
            cl = None if caches is None else {n: t[j] for n, t in caches["mamba"].items()}
            x, _, _ = block_apply(cfg.mamba_block, lp, x, pos=pos, cache=cl,
                                  cache_len=cache_len, state=state)
        if hi in cfg.invocation_points:
            # weight-shared across the invocations: one registry path
            set_tape_prefix("shared")
            ac = None if caches is None else {n: t[inv] for n, t in caches["attn"].items()}
            x = _shared_block(cfg, shared, x, x0, pos=pos, cache=ac,
                              cache_len=cache_len, write_index=write_index,
                              block_tables=block_tables)
            inv += 1
    x = rmsnorm(params["final_norm"], x)
    if cfg.vocab_sharded:
        return sharded.tied_logits(x, emb["table"], gather=cfg.gather_logits), caches
    return x @ emb["table"].to(x.dtype).T, caches
