"""Decoder-only LM: dense blocks, segments of layers, tied or separate head.

Counterpart of `repro.models.transformer` for the `dense` block kind. Layers
are grouped into segments of identical block config, as in the reference
(the paper's "keep the first layer dense" gives a 1-layer dense segment and
an (L-1)-layer LUT segment). Each segment's params are a list of per-layer
dicts run by a Python loop; its KV cache is one stacked (L, B, S_max, KV, Dh)
tensor per K and V, the reference's layout.

A decode forward (S == 1) attends with deferred cache writes and then writes
every layer's fresh K/V slab into the segment's stacked cache in one scatter,
as the reference does. A prefill forward writes each layer's K/V in place
before attending over the cache. A paged cache is one stacked
(L, n_pages, page_size, KV, Dh) pool per K and V and segment, written the
same two ways through the flat indices of `attention.paged_write_flat`
(masked positions to the garbage page).

Three block kinds, as in the reference: "dense" (attention + MLP), "moe"
(attention + the MoE FFN, plus arctic's dense residual MLP beside it) and
"mamba" (x + mamba2(rmsnorm(x))). A mamba segment's cache is per row, {"conv",
"ssm"} stacked over its layers; a forward updates the rows it may write in
place (`mamba2.mamba2`), and keeps the deferred K/V write off, as the
reference does for mamba segments.

Every forward also returns the MoE load-balance value summed over the MoE
layers (0 without them), the reference's `aux`: the lm family's loss adds
it at LM_AUX_WEIGHT. A training forward (no caches, gradients on)
recomputes each block in the backward pass instead of keeping its
activations (`torch.utils.checkpoint`, the counterpart of the reference's
`remat=True`); the values are the same with and without it. Under an activation tape each layer's records are keyed
'segments/<i>/<j>/<site>', the registry's tape keys.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
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
    tape_active,
)

# MoE load-balance penalty weight of the lm family's loss
LM_AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str                                  # "dense" | "moe" | "mamba"
    d_model: int
    attn: attn_mod.AttnCfg | None = None
    mlp: mlp_mod.MLPCfg | None = None
    moe: moe_mod.MoECfg | None = None
    mamba: mamba_mod.Mamba2Cfg | None = None
    residual_mlp: mlp_mod.MLPCfg | None = None  # arctic's parallel dense branch


@dataclasses.dataclass(frozen=True)
class StateRows:
    """What a serving forward may change in per-row recurrent state: the
    batch rows to write (`rows`, all when None) and each row's valid
    positions (`valid` (B,), all S when None), on the forward's device."""
    rows: torch.Tensor | None = None
    valid: torch.Tensor | None = None


def block_init(gen: torch.Generator, cfg: BlockCfg, *, dtype=torch.float32,
               device="cpu") -> Params:
    if cfg.kind == "mamba":
        return {"norm": rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": mamba_mod.mamba2_init(gen, cfg.mamba, dtype=dtype, device=device)}
    p: Params = {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn_mod.attn_init(gen, cfg.attn, dtype=dtype, device=device),
    }
    if cfg.kind == "dense":
        p["mlp"] = mlp_mod.mlp_init(gen, cfg.mlp, dtype=dtype, device=device)
    elif cfg.kind == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg.moe, dtype=dtype, device=device)
        if cfg.residual_mlp is not None:
            p["residual_mlp"] = mlp_mod.mlp_init(gen, cfg.residual_mlp, dtype=dtype,
                                                 device=device)
    else:
        raise ValueError(cfg.kind)
    return p


def block_specs(cfg: BlockCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `block_init`'s params."""
    norm = {"scale": ParamSpec((cfg.d_model,), dtype)}
    if cfg.kind == "mamba":
        return {"norm": norm, "mamba": mamba_mod.mamba2_specs(cfg.mamba, dtype)}
    p: Params = {"norm1": norm, "norm2": norm, "attn": attn_mod.attn_specs(cfg.attn, dtype)}
    if cfg.kind == "dense":
        p["mlp"] = mlp_mod.mlp_specs(cfg.mlp, dtype)
    elif cfg.kind == "moe":
        p["moe"] = moe_mod.moe_specs(cfg.moe, dtype)
        if cfg.residual_mlp is not None:
            p["residual_mlp"] = mlp_mod.mlp_specs(cfg.residual_mlp, dtype)
    else:
        raise ValueError(cfg.kind)
    return p


def block_cache_specs(cfg: BlockCfg, b: int, s_max: int, dtype=torch.bfloat16,
                      paged: attn_mod.PagedSpec | None = None) -> Params:
    """One layer's cache: mamba state per row (never paged), else K/V."""
    if cfg.kind == "mamba":
        return mamba_mod.mamba2_cache_specs(b, cfg.mamba, dtype)
    if paged is not None:
        return attn_mod.paged_cache_specs(paged, cfg.attn, dtype)
    a = cfg.attn
    return {name: ParamSpec((b, s_max, a.n_kv_heads, a.d_head), dtype) for name in ("k", "v")}


def block_apply(cfg: BlockCfg, p: Params, x: torch.Tensor, *, pos: torch.Tensor,
                cache: Params | None = None, cache_len: torch.Tensor | None = None,
                defer_cache_write: bool = False, write_index=None,
                block_tables: torch.Tensor | None = None,
                state: StateRows | None = None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (x, cache or deferred slabs, aux): aux the MoE block's
    load-balance value, 0 for the other kinds. A mamba block writes its
    state rows in place (`state`)."""
    zero = x.new_zeros((), dtype=torch.float32)
    if cfg.kind == "mamba":
        st = state or StateRows()
        h = mamba_mod.mamba2(cfg.mamba, p["mamba"], rmsnorm(p["norm"], x), cache=cache,
                             cache_len=cache_len, valid=st.valid, rows=st.rows)
        return x + h, cache, zero
    a, new_cache = attn_mod.attention(
        cfg.attn, p["attn"], rmsnorm(p["norm1"], x), pos=pos, cache=cache,
        cache_len=cache_len, defer_cache_write=defer_cache_write, write_index=write_index,
        block_tables=block_tables,
    )
    x = x + a
    h = rmsnorm(p["norm2"], x)
    aux = zero
    if cfg.kind == "dense":
        f = mlp_mod.mlp(cfg.mlp, p["mlp"], h)
    else:
        f, aux = moe_mod.moe(cfg.moe, p["moe"], h)
        if cfg.residual_mlp is not None:
            f = f + mlp_mod.mlp(cfg.residual_mlp, p["residual_mlp"], h)
    return x + f, new_cache, aux


@dataclasses.dataclass(frozen=True)
class LMCfg:
    vocab: int
    d_model: int
    segments: tuple[tuple[int, BlockCfg], ...]   # (n_layers, block cfg) runs
    lm_head: SiteCfg | None = None               # None -> tied to the embedding
    remat: bool = True                           # recompute blocks in training backward
    takes_embeds: bool = False                   # input: embeddings (the vlm stub frontend)
    vocab_sharded: bool = False  # a tensor-parallel rank's vocab rows (models/sharded.py)

    @property
    def n_layers(self) -> int:
        return sum(n for n, _ in self.segments)


def lm_init(gen: torch.Generator, cfg: LMCfg, *, dtype=torch.float32, device="cpu") -> Params:
    p: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "segments": [[block_init(gen, bcfg, dtype=dtype, device=device) for _ in range(count)]
                     for count, bcfg in cfg.segments],
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if cfg.lm_head is not None:
        p["lm_head"] = linear_init(gen, cfg.lm_head, dtype=dtype, device=device)
    return p


def lm_param_specs(cfg: LMCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `lm_init`'s params in the reference's layout: each
    segment one dict whose leaves are stacked over its layers."""
    def stacked(tree, count):
        if isinstance(tree, dict):
            return {k: stacked(v, count) for k, v in tree.items()}
        return ParamSpec((count, *tree.shape), tree.dtype)

    segs = [stacked(block_specs(bcfg, dtype), count) for count, bcfg in cfg.segments]
    p: Params = {
        "embed": {"table": ParamSpec((cfg.vocab, cfg.d_model), dtype)},
        "segments": segs,
        "final_norm": {"scale": ParamSpec((cfg.d_model,), dtype)},
    }
    if cfg.lm_head is not None:
        p["lm_head"] = linear_specs(cfg.lm_head, dtype)
    return p


def cache_specs(cfg: LMCfg, b: int, s_max: int, dtype=torch.bfloat16,
                paged: attn_mod.PagedSpec | None = None) -> list:
    """ParamSpecs of `init_caches`' tensors, one dict per segment, each
    layer's cache (`block_cache_specs`) stacked over the segment's layers:
    {"k", "v"} (L_seg, B, S_max, KV, Dh), or with `paged` {"k_pool",
    "v_pool"} (L_seg, n_pages, page_size, KV, Dh); a mamba segment's
    {"conv", "ssm"} (L_seg, B, ...) whether paged or not."""
    return [{name: ParamSpec((count, *ps.shape), ps.dtype)
             for name, ps in block_cache_specs(bcfg, b, s_max, dtype, paged).items()}
            for count, bcfg in cfg.segments]


def zeros_like_specs(tree, device="cpu"):
    """Zero tensors of a tree of ParamSpecs (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: zeros_like_specs(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [zeros_like_specs(v, device) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def init_caches(cfg: LMCfg, b: int, s_max: int, dtype=torch.bfloat16, device="cpu",
                paged: attn_mod.PagedSpec | None = None) -> list:
    """Zeros of `cache_specs`' shapes, one dict per segment."""
    return zeros_like_specs(cache_specs(cfg, b, s_max, dtype, paged), device)


def train_block(bcfg: BlockCfg, lp: Params, x: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's training forward: (x, aux), what a recomputed block returns."""
    y, _, aux = block_apply(bcfg, lp, x, pos=pos)
    return y, aux


def remat_active(remat: bool, caches) -> bool:
    """Recompute blocks in backward only where there is a backward (and no
    tape, which the recomputation would write to a second time)."""
    return remat and caches is None and torch.is_grad_enabled() and not tape_active()


def _seg_apply(bcfg: BlockCfg, layers: list[Params], x: torch.Tensor, *, pos: torch.Tensor,
               caches: Params | None, cache_len: torch.Tensor | None,
               write_index, block_tables: torch.Tensor | None = None,
               remat: bool = False, prefix: str = "",
               state: StateRows | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run one segment's layers; writes the segment's cache in place.
    Returns (x, the layers' aux summed)."""
    defer = caches is not None and x.shape[1] == 1 and bcfg.kind != "mamba"
    remat = remat_active(remat, caches)
    aux_total = x.new_zeros((), dtype=torch.float32)
    k_slabs, v_slabs = [], []
    for j, lp in enumerate(layers):
        set_tape_prefix(f"{prefix}/{j}")
        if remat:
            x, aux = checkpoint(train_block, bcfg, lp, x, pos, use_reentrant=False)
            aux_total = aux_total + aux
            continue
        cl = None if caches is None else {name: t[j] for name, t in caches.items()}
        x, nc, aux = block_apply(bcfg, lp, x, pos=pos, cache=cl, cache_len=cache_len,
                                 defer_cache_write=defer, write_index=write_index,
                                 block_tables=block_tables, state=state)
        aux_total = aux_total + aux
        if defer:
            k_slabs.append(nc["k_slab"])
            v_slabs.append(nc["v_slab"])
    if defer:
        # one scatter of all layers' slabs replaces per-layer cache writes
        if "k_pool" in caches:
            attn_mod.paged_write(caches["k_pool"], torch.stack(k_slabs), write_index)
            attn_mod.paged_write(caches["v_pool"], torch.stack(v_slabs), write_index)
        else:
            attn_mod.write_at(caches["k"], torch.stack(k_slabs), write_index)
            attn_mod.write_at(caches["v"], torch.stack(v_slabs), write_index)
    return x, aux_total


def lm_apply(cfg: LMCfg, params: Params, *, tokens: torch.Tensor | None = None,
             embeds: torch.Tensor | None = None, pos: torch.Tensor,
             caches: list | None = None, cache_len: torch.Tensor | None = None,
             compute_dtype=torch.float32, write_index=None,
             block_tables: torch.Tensor | None = None,
             state: StateRows | None = None
             ) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """Returns (logits (B, S, vocab), caches, aux), aux the MoE layers'
    load-balance values summed (0 without MoE layers). The input is `tokens` (B, S),
    or `embeds` (B, S, D) when `cfg.takes_embeds` (the embedding table stays
    in the params, as the reference's `lm_init` keeps it, and goes unread);
    pos is (B, S), or (3, B, S) under M-RoPE. The caches are updated in
    place where `write_index` says (attention.cache_write_index, or for paged
    caches, which also take `block_tables`, attention.paged_write_flat), and
    mamba state where `state` says. Without caches this is the training
    forward over whole sequences."""
    if cfg.takes_embeds:
        if embeds is None:
            raise ValueError("this model takes embeddings (embeds=), not token ids")
        x = embeds.to(compute_dtype)
    elif cfg.vocab_sharded:
        x = sharded.embed(params["embed"], tokens).to(compute_dtype)
    else:
        x = embed(params["embed"], tokens).to(compute_dtype)
    aux = x.new_zeros((), dtype=torch.float32)
    for i, (_, bcfg) in enumerate(cfg.segments):
        x, a = _seg_apply(bcfg, params["segments"][i], x, pos=pos,
                       caches=None if caches is None else caches[i],
                       cache_len=cache_len, write_index=write_index,
                       block_tables=block_tables, remat=cfg.remat, prefix=f"segments/{i}",
                       state=state)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x)
    if cfg.lm_head is not None:
        set_tape_prefix("")                     # registry key: bare "lm_head"
        logits = linear(cfg.lm_head, params["lm_head"], x)
    elif cfg.vocab_sharded:
        logits = sharded.tied_logits(x, params["embed"]["table"])
    else:
        # tied head: a plain matmul, left to the library as the reference leaves it to XLA
        logits = x @ params["embed"]["table"].to(x.dtype).T
    return logits, caches, aux
