"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), in PyTorch.

Counterpart of `repro.models.encdec`. The conv audio frontend is a stub, as
in the reference: the caller passes frame embeddings (B, enc_frames,
d_model). The backbone is real: a bidirectional encoder (dense blocks,
causal=False, RoPE at the frame index), then a causal decoder whose layers
attend to themselves, to the encoder output (cross-attention) and run an
MLP. The cross-attention K/V are computed once from the encoder output
(`cross_kv`) and held per row for the whole generation: those projections
are LUT sites whose lookups are amortized over every decoded token.

Encoder and decoder layers are lists of per-layer dicts ("encoder",
"decoder"; the reference stacks them on a leading axis, `weights.py`
converts) run by a Python loop. Caches are {"self": the decoder's K/V
(L, B, S_max, KV, Dh), or the paged {"k_pool", "v_pool"} (L, n_pages,
page_size, KV, Dh), "cross": {"k", "v"} (L, B, enc_frames, KV, Dh) per row,
never paged (a fixed extent written once per request: paging it buys
nothing)}. A forward writes the self K/V in place where `write_index` says,
then attends over the cache, as the reference's decoder does (no deferred
slab write). Under an activation tape the records are keyed
'encoder/<j>/<site>' and 'decoder/<j>/<site>', the registry's tape keys.
The training forward is `encode` then `decode` with `enc_out` over whole
sequences (no caches), each run of autograd; each encoder and decoder
block is recomputed in the backward pass (the reference's `remat=True`),
a decoder block with its layer's cross K/V.

A tensor-parallel rank's config (`distributed.tensor_parallel.
local_bundle`) runs its heads of every attention and its columns of every
MLP; its cross K/V cache holds its KV heads. Its embedding is
vocab-sharded where the spec splits the vocab (`vocab_sharded`: the
masked lookup, and the tied logits gathered in serving or kept
vocab-sharded in training), else whole on every rank with the plain
lookup and logits. An FSDP rank's config names the leaves it holds only
its "data" part of (`fsdp`): each block gathers its own inside its
recomputed function, the embedding once per forward
(`sharded.gather_data`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import sharded
from repro_torch.models.common import (
    ParamSpec,
    Params,
    embed,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    set_tape_prefix,
)
from repro_torch.models.transformer import (
    BlockCfg,
    _train_block_on,
    block_apply,
    block_init,
    block_specs,
    kept,
    remat_active,
    zeros_like_specs,
)


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    vocab: int
    d_model: int
    n_enc_layers: int
    n_dec_layers: int
    enc_frames: int                 # the stub frontend's sequence length
    enc_block: BlockCfg             # dense block, causal=False
    dec_self: attn_mod.AttnCfg      # causal self-attention
    dec_cross: attn_mod.AttnCfg     # cross-attention (causal=False, no RoPE)
    dec_mlp: mlp_mod.MLPCfg
    vocab_sharded: bool = False     # a tensor-parallel rank's vocab rows (models/sharded.py)
    gather_logits: bool = True      # False: a training rank's logits stay vocab-sharded
    # FSDP: ((reference path, dim), ...) of the leaves a rank holds its "data" part of
    fsdp: tuple[tuple[str, int], ...] = ()


def _dec_block_init(gen: torch.Generator, cfg: EncDecCfg, *, dtype, device) -> Params:
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "self": attn_mod.attn_init(gen, cfg.dec_self, dtype=dtype, device=device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "cross": attn_mod.attn_init(gen, cfg.dec_cross, dtype=dtype, device=device),
        "norm3": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_mod.mlp_init(gen, cfg.dec_mlp, dtype=dtype, device=device),
    }


def encdec_init(gen: torch.Generator, cfg: EncDecCfg, *, dtype=torch.float32,
                device="cpu") -> Params:
    return {
        "embed": kept("embed", embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)),
        "encoder": [kept("encoder", block_init(gen, cfg.enc_block, dtype=dtype, device=device))
                    for _ in range(cfg.n_enc_layers)],
        "enc_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "decoder": [kept("decoder", _dec_block_init(gen, cfg, dtype=dtype, device=device))
                    for _ in range(cfg.n_dec_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }


def _stacked(tree, count: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, count) for k, v in tree.items()}
    return ParamSpec((count, *tree.shape), tree.dtype)


def encdec_param_specs(cfg: EncDecCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `encdec_init`'s params in the reference's layout (the
    encoder and decoder layers stacked on a leading axis)."""
    norm = {"scale": ParamSpec((cfg.d_model,), dtype)}
    dec = {"norm1": norm, "self": attn_mod.attn_specs(cfg.dec_self, dtype), "norm2": norm,
           "cross": attn_mod.attn_specs(cfg.dec_cross, dtype), "norm3": norm,
           "mlp": mlp_mod.mlp_specs(cfg.dec_mlp, dtype)}
    return {
        "embed": {"table": ParamSpec((cfg.vocab, cfg.d_model), dtype)},
        "encoder": _stacked(block_specs(cfg.enc_block, dtype), cfg.n_enc_layers),
        "enc_norm": norm,
        "decoder": _stacked(dec, cfg.n_dec_layers),
        "final_norm": norm,
    }


def encdec_cache_specs(cfg: EncDecCfg, b: int, s_max: int, dtype=torch.bfloat16,
                       paged: attn_mod.PagedSpec | None = None) -> Params:
    """{"self": the decoder's K/V or pools, "cross": {"k", "v"} per row},
    each stacked over the decoder layers."""
    a, c = cfg.dec_self, cfg.dec_cross
    one = (attn_mod.paged_cache_specs(paged, a, dtype) if paged is not None
           else {name: ParamSpec((b, s_max, a.n_kv_heads, a.d_head), dtype)
                 for name in ("k", "v")})
    cross = (cfg.n_dec_layers, b, cfg.enc_frames, c.n_kv_heads, c.d_head)
    return {"self": {k: ParamSpec((cfg.n_dec_layers, *s.shape), s.dtype)
                     for k, s in one.items()},
            "cross": {name: ParamSpec(cross, dtype) for name in ("k", "v")}}


def encdec_caches(cfg: EncDecCfg, b: int, s_max: int, dtype=torch.bfloat16, device="cpu",
                  paged: attn_mod.PagedSpec | None = None) -> Params:
    """Zeros of `encdec_cache_specs`' shapes: until a forward with frames
    writes a row's cross K/V, that row attends to zeros, as in the
    reference."""
    return zeros_like_specs(encdec_cache_specs(cfg, b, s_max, dtype, paged), device)


def encode(cfg: EncDecCfg, params: Params, frames: torch.Tensor, *,
           compute_dtype=torch.float32) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder output (B, T, D), RoPE at
    the frame index."""
    b, t, _ = frames.shape
    pos = torch.arange(t, device=frames.device)[None, :].expand(b, t)
    x = frames.to(compute_dtype)
    remat = remat_active(True, None)
    fsdp = sharded.data_dims(cfg.fsdp, "encoder/")
    for j, lp in enumerate(params["encoder"]):
        set_tape_prefix(f"encoder/{j}")
        if remat:
            x, _ = checkpoint(_train_block_on, sharded.current(), cfg.enc_block, lp, x, pos,
                              fsdp, use_reentrant=False)
        else:
            x, _, _ = block_apply(cfg.enc_block, sharded.gather_data(lp, fsdp), x, pos=pos)
    return rmsnorm(params["enc_norm"], x)


def cross_kv(cfg: EncDecCfg, params: Params, enc_out: torch.Tensor) -> Params:
    """Every decoder layer's cross-attention K/V of the encoder output:
    {"k", "v"} (L, B, T, KV, Dh)."""
    per_layer = []
    fsdp = sharded.data_dims(cfg.fsdp, "decoder/cross/")
    for j, lp in enumerate(params["decoder"]):
        set_tape_prefix(f"decoder/{j}")
        per_layer.append(attn_mod.memory_kv(cfg.dec_cross, sharded.gather_data(lp["cross"], fsdp),
                                            enc_out))
    return {name: torch.stack([kv[name] for kv in per_layer]) for name in ("k", "v")}


def _dec_block(cfg: EncDecCfg, lp: Params, x: torch.Tensor, *, pos, self_cache, cache_len,
               cross: Params, write_index, block_tables) -> torch.Tensor:
    a, _ = attn_mod.attention(cfg.dec_self, lp["self"], rmsnorm(lp["norm1"], x), pos=pos,
                              cache=self_cache, cache_len=cache_len, write_index=write_index,
                              block_tables=block_tables)
    x = x + a
    x = x + attn_mod.cross_attention(cfg.dec_cross, lp["cross"], rmsnorm(lp["norm2"], x), cross)
    return x + mlp_mod.mlp(cfg.dec_mlp, lp["mlp"], rmsnorm(lp["norm3"], x))


def _dec_train_block(cfg: EncDecCfg, lp: Params, x: torch.Tensor, pos: torch.Tensor,
                     enc_out: torch.Tensor, mesh=None, fsdp: dict[str, int] | None = None
                     ) -> torch.Tensor:
    """A decoder block's training forward over whole sequences, its cross
    K/V from `enc_out` computed inside it: what a recomputed block runs,
    with a tensor-parallel rank's mesh bound (the recomputation runs on the
    autograd engine's thread) and an FSDP rank's data-split leaves gathered
    first (`fsdp`, {path in the block: dim})."""
    with sharded.bound(mesh) if mesh is not None else contextlib.nullcontext():
        lp = sharded.gather_data(lp, fsdp, mesh)
        kv = attn_mod.memory_kv(cfg.dec_cross, lp["cross"], enc_out)
        return _dec_block(cfg, lp, x, pos=pos, self_cache=None, cache_len=None, cross=kv,
                          write_index=None, block_tables=None)


def decode(cfg: EncDecCfg, params: Params, *, tokens: torch.Tensor, pos: torch.Tensor,
           enc_out: torch.Tensor | None = None, caches: Params | None = None,
           cache_len: torch.Tensor | None = None, compute_dtype=torch.float32,
           write_index=None, block_tables: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, Params | None]:
    """Returns (logits (B, S, vocab), caches). Without caches the decoder
    runs over whole sequences against `enc_out`'s cross K/V; with caches it
    reads each row's cached cross K/V and writes the self K/V in place
    (`attention.attention`'s prefill path, at every S)."""
    emb = sharded.gather_data(params["embed"], sharded.data_dims(cfg.fsdp, "embed/"))
    x = (sharded.embed(emb, tokens) if cfg.vocab_sharded else embed(emb, tokens)
         ).to(compute_dtype)
    fsdp = sharded.data_dims(cfg.fsdp, "decoder/")
    if remat_active(True, caches):
        # each recomputed block computes its layer's cross K/V
        for j, lp in enumerate(params["decoder"]):
            set_tape_prefix(f"decoder/{j}")
            x = checkpoint(_dec_train_block, cfg, lp, x, pos, enc_out, sharded.current(), fsdp,
                           use_reentrant=False)
    else:
        # every layer's cross K/V first (the order a tape records them in, as
        # the reference's), or the cached rows'
        cross = cross_kv(cfg, params, enc_out) if caches is None else caches["cross"]
        for j, lp in enumerate(params["decoder"]):
            set_tape_prefix(f"decoder/{j}")
            sc = None if caches is None else {n: t[j] for n, t in caches["self"].items()}
            x = _dec_block(cfg, sharded.gather_data(lp, fsdp), x, pos=pos, self_cache=sc,
                           cache_len=cache_len, cross={n: t[j] for n, t in cross.items()},
                           write_index=write_index, block_tables=block_tables)
    x = rmsnorm(params["final_norm"], x)
    if cfg.vocab_sharded:
        return sharded.tied_logits(x, emb["table"], gather=cfg.gather_logits), caches
    # tied head: a plain matmul, left to the library as the reference leaves it to XLA
    return x @ emb["table"].to(x.dtype).T, caches
