"""GQA attention with qk-norm, RoPE and a dense KV cache, in PyTorch.

Counterpart of `repro.models.attention` for the dense decoder path. The
Q/K/V/O projections are LUT sites; the score and AV contractions are plain
tensor ops (the reference leaves them to XLA too). Softmax statistics are
fp32 with the reference's mask value, so partials from disjoint KV sources
merge exactly as in flash-decoding.

Two cache paths, as in the reference:
  * prefill: scatter the fresh K/V into the cache at `cache_len`, then attend
    over the cache;
  * decode with a deferred write: attend over the stale cache and the fresh
    slab as two flash partials and return {"k_slab", "v_slab"}; the caller
    writes every layer's slab into the cache once per forward.

Unlike the reference, the cache writes are in place, and only into the rows
the caller lists (`cache_write_index`): the serving engine passes the slots
of the forward, so a padded or idle row never touches another slot's cache.

A paged cache ({"k_pool", "v_pool"}, DESIGN.md §12) is a pool of pages shared
by every row, each row mapping its logical positions through a block table
(B, P) of page ids. The same two paths run over it: the fresh K/V scatter
into the page-flattened pool at indices computed once per forward on the
host (`paged_write_flat`, masked positions routed to the garbage page 0), and
reads gather each row's pages back into the dense logical layout
(`paged_gather`), so the dense masks apply unchanged and the outputs equal
the dense cache's.

Positions are (B, S), or (3, B, S) under M-RoPE (the t, h, w streams of
`common.apply_mrope`); masks and cache writes read the first stream, as in
the reference. Cross-attention (the enc-dec decoder) attends to a memory's
K/V (`memory_kv`, computed once per request and cached per row by the
caller): no RoPE on them (the cross config's `use_rope` is False), no causal
mask, every memory position visible (`cross_attention`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common
from repro_torch.models.common import Params, SiteCfg, linear, linear_init, rmsnorm, rmsnorm_init

MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    q: SiteCfg
    k: SiteCfg
    v: SiteCfg
    o: SiteCfg
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: tuple[int, ...] = ()
    causal: bool = True
    use_rope: bool = True


def attn_init(gen: torch.Generator, cfg: AttnCfg, *, dtype=torch.float32,
              device="cpu") -> Params:
    p: Params = {name: linear_init(gen, getattr(cfg, name), dtype=dtype, device=device)
                 for name in ("q", "k", "v", "o")}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.d_head, dtype, device)
        p["k_norm"] = rmsnorm_init(cfg.d_head, dtype, device)
    return p


def attn_specs(cfg: AttnCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `attn_init`'s params."""
    p: Params = {name: common.linear_specs(getattr(cfg, name), dtype)
                 for name in ("q", "k", "v", "o")}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": common.ParamSpec((cfg.d_head,), dtype)}
        p["k_norm"] = {"scale": common.ParamSpec((cfg.d_head,), dtype)}
    return p


def _rope(cfg: AttnCfg, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if not cfg.use_rope:
        return x
    if cfg.mrope_sections:
        return common.apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    return common.apply_rope(x, pos, cfg.rope_theta)


def _attend_stats(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos, kv_pos,
                  causal: bool, kv_valid) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized flash stats (sum p*V, running max m, denom l), all fp32.

    qc (B, Sq, KV, G, Dh), k/v (B, T, KV, Dh). Operands are upcast to fp32
    before the contractions: products of the compute dtype are exact in fp32,
    which is the reference's `preferred_element_type=float32`."""
    b, sq, kvh, g, dh = qc.shape
    sm = 1.0 / (dh ** 0.5)
    q32 = qc.float()
    k32 = k.to(qc.dtype).float()
    v_c = v.to(qc.dtype)
    sc = torch.einsum("bskgd,btkd->bskgt", q32, k32) * sm          # (B, Sq, KV, G, T)
    mask = torch.ones((b, 1, 1, 1, k.shape[1]), dtype=torch.bool, device=qc.device)
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    sc = sc.masked_fill(~mask, MASK_VALUE)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    pv = torch.einsum("bskgt,btkd->bskgd", p.to(v_c.dtype).float(), v_c.float())
    return pv, m, l


def _merge_stats(parts) -> torch.Tensor:
    """Combine flash partials from disjoint KV sources."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for pv, mi, li in parts:
        corr = torch.exp(mi - m)
        acc = acc + pv * corr[..., None]
        l = l + li * corr
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_pos, kv_pos,
                    causal: bool, kv_valid=None, q_chunk: int = 512) -> torch.Tensor:
    """Grouped-query attention, blocked over the query axis (the score tensor
    peaks at B x q_chunk x H x T). q (B, S, Hq, Dh), k/v (B, T, KV, Dh)."""
    b, s, hq, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, hq // kvh, dh)
    nq = max(1, s // q_chunk)
    while s % nq:
        nq -= 1
    step = s // nq
    outs = []
    for i in range(nq):
        sl = slice(i * step, (i + 1) * step)
        pv, _, l = _attend_stats(qg[:, sl], k, v, q_pos=q_pos[:, sl], kv_pos=kv_pos,
                                 causal=causal, kv_valid=kv_valid)
        outs.append(pv / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.reshape(b, s, hq, dh).to(q.dtype)


def init_cache(b: int, s_max: int, cfg: AttnCfg, dtype=torch.bfloat16, device="cpu") -> Params:
    shape = (b, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_write_index(cache_len: torch.Tensor, rows: torch.Tensor | None, s: int, s_max: int,
                      device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row, cache position, slab position) of every fresh K/V entry a forward
    writes: row b's slab position j lands at cache_len[b] + j, for the listed
    rows (all when None) and only inside the cache (the reference's scatter
    drops positions past S_max). Computed on the host once per forward, so
    the per-layer writes are index_puts that never wait for the device."""
    cl = cache_len.cpu().long()
    rows = torch.arange(len(cl)) if rows is None else rows.cpu().long()
    slab = torch.arange(s)[None, :].expand(len(rows), -1)
    pos = cl[rows][:, None] + slab
    ok = pos < s_max
    return tuple(t.to(device) for t in (rows[:, None].expand(-1, s)[ok], pos[ok], slab[ok]))


def write_at(cache: torch.Tensor, vals: torch.Tensor, index) -> None:
    """In place: cache[..., b, p] = vals[..., b, j] for each (b, p, j) of
    `index` (cache_write_index). cache (..., B, S_max, KV, Dh), vals
    (..., B, s, KV, Dh): a leading layer axis is written in the same scatter."""
    bi, pi, ji = index
    cache[..., bi, pi, :, :] = vals[..., bi, ji, :, :].to(cache.dtype)


# ---------------------------------------------------------------------------
# paged KV cache (DESIGN.md §12)
# ---------------------------------------------------------------------------
#
# Page 0 is the reserved garbage page: masked and out-of-range writes land
# there instead of being dropped, and allocators never hand it out. Pool
# content stays finite (zeros at init, activations after), so gathered and
# then masked garbage contributes exactly 0 to the softmax.

GARBAGE_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Layout of a paged KV pool."""
    n_pages: int
    page_size: int


def paged_cache_specs(spec: PagedSpec, cfg: AttnCfg, dtype=torch.bfloat16) -> Params:
    shape = (spec.n_pages, spec.page_size, cfg.n_kv_heads, cfg.d_head)
    return {"k_pool": common.ParamSpec(shape, dtype), "v_pool": common.ParamSpec(shape, dtype)}


def paged_init_cache(spec: PagedSpec, cfg: AttnCfg, dtype=torch.bfloat16,
                     device="cpu") -> Params:
    return {name: torch.zeros(ps.shape, dtype=dtype, device=device)
            for name, ps in paged_cache_specs(spec, cfg, dtype).items()}


def paged_write_flat(block_tables: torch.Tensor, cache_len: torch.Tensor, s: int,
                     page_size: int, write_len: torch.Tensor) -> torch.Tensor:
    """(B, s) int64 indices into the page-flattened pool axis (n_pages *
    page_size) of the `s` fresh positions of each row, starting at
    cache_len. Offsets at or past write_len and positions past the table's
    width land in GARBAGE_PAGE. Computed where its inputs lie: the model
    step passes host tensors and moves the result to the card once."""
    n_tables = block_tables.shape[1]
    off = torch.arange(s, device=cache_len.device)[None, :]
    write_idx = cache_len.long()[:, None] + off                     # (B, s) logical
    p_idx = write_idx // page_size
    ok = (off < write_len.long()[:, None]) & (p_idx < n_tables)
    pages = torch.gather(block_tables.long(), 1, p_idx.clamp_max(n_tables - 1))
    pages = torch.where(ok, pages, GARBAGE_PAGE)
    return pages * page_size + torch.where(ok, write_idx % page_size, 0)


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each row's logical KV extent, (B, P * page_size, KV, Dh): the dense
    cache's layout when P * page_size == S_max, which is what makes paged
    serving give the dense engine's tokens exactly."""
    b, p = block_tables.shape
    g = pool[block_tables]                                       # (B, P, page_size, KV, Dh)
    return g.reshape(b, p * pool.shape[1], *pool.shape[2:])


def paged_write_sources(flat: torch.Tensor) -> torch.Tensor | None:
    """(B * s,) for `paged_write_flat`'s indices: each fresh position's
    source, the last position (row-major) that writes its pool slot, as
    the reference's scatter keeps the last of duplicate writes; None when
    no slot is written twice. Masked positions all write the garbage
    page's first slot, and an index_put with duplicate indices keeps any
    one of them (threads race for it), so the garbage content, which a
    padded position reads back, would vary from run to run."""
    f = flat.reshape(-1)
    if torch.unique(f).numel() == f.numel():
        return None
    order = torch.arange(f.numel(), device=f.device)
    last = torch.full((int(f.max()) + 1,), -1, dtype=torch.long, device=f.device)
    return last.scatter_reduce_(0, f, order, "amax")[f]


def paged_write(pool: torch.Tensor, vals: torch.Tensor, index) -> None:
    """In place: the page-flattened pool (..., n_pages * page_size, KV, Dh)
    takes vals (..., B, s, KV, Dh) at flat (B, s) (`paged_write_flat`);
    `index` is flat, or (flat, sources) (`paged_write_sources`), where every
    duplicate write carries its slot's last value. A leading layer axis is
    written in the same scatter."""
    flat, src = index if isinstance(index, tuple) else (index, None)
    lead = pool.shape[:-4]
    flat_pool = pool.view(*lead, pool.shape[-4] * pool.shape[-3], *pool.shape[-2:])
    if src is not None:
        vals, flat = vals.flatten(-4, -3).index_select(-3, src), flat.reshape(-1)
    flat_pool[..., flat, :, :] = vals.to(pool.dtype)


def attention(cfg: AttnCfg, p: Params, x: torch.Tensor, *, pos: torch.Tensor,
              cache: Params | None = None, cache_len: torch.Tensor | None = None,
              defer_cache_write: bool = False, write_index=None,
              block_tables: torch.Tensor | None = None) -> tuple[torch.Tensor, Params | None]:
    """Returns (output (B, S, D), cache or {"k_slab", "v_slab"} or None).

    x (B, S, D), pos (B, S) absolute positions ((3, B, S) under M-RoPE),
    cache_len (B,) tokens already in the cache, write_index where the
    prefill path writes the fresh K/V
    (cache_write_index; for a paged cache the flat indices of
    paged_write_flat), block_tables (B, P) the page ids of a paged cache. See
    the module docstring for the cache paths."""
    paged = cache is not None and "k_pool" in cache
    if paged and block_tables is None:
        raise ValueError("a paged cache needs block_tables")
    b, s, _ = x.shape
    q = linear(cfg.q, p["q"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = linear(cfg.k, p["k"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = linear(cfg.v, p["v"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = _rope(cfg, q, pos)
    k = _rope(cfg, k, pos)
    pos = pos if pos.dim() == 2 else pos[0]          # (B, S): the stream masks read

    if cache is None:
        out = flash_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=cfg.causal)
        new_cache = None
    elif defer_cache_write:
        # flash-decoding over (stale cache) + (fresh slab), no cache write here
        if paged:
            ck = paged_gather(cache["k_pool"], block_tables)
            cv = paged_gather(cache["v_pool"], block_tables)
        else:
            ck, cv = cache["k"], cache["v"]
        kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(b, s, kvh, g, cfg.d_head)
        all_pos = torch.arange(ck.shape[1], device=x.device)[None, :].expand(b, -1)
        stale_valid = all_pos < cache_len[:, None]
        part_cache = _attend_stats(qg, ck, cv, q_pos=pos, kv_pos=all_pos,
                                   causal=cfg.causal, kv_valid=stale_valid)
        slab_pos = cache_len[:, None] + torch.arange(s, device=x.device)[None, :]
        part_slab = _attend_stats(qg, k, v, q_pos=pos, kv_pos=slab_pos, causal=cfg.causal,
                                  kv_valid=None)
        out = _merge_stats([part_cache, part_slab]).reshape(b, s, cfg.n_heads, cfg.d_head)
        out = out.to(q.dtype)
        new_cache = {"k_slab": k.to(ck.dtype), "v_slab": v.to(cv.dtype)}
    elif paged:
        # scatter the fresh K/V into the pool (masked positions to the
        # garbage page), then gather the rows' pages and attend over them
        paged_write(cache["k_pool"], k, write_index)
        paged_write(cache["v_pool"], v, write_index)
        ck = paged_gather(cache["k_pool"], block_tables)
        cv = paged_gather(cache["v_pool"], block_tables)
        all_pos = torch.arange(ck.shape[1], device=x.device)[None, :].expand(b, -1)
        valid = all_pos < (cache_len + s)[:, None]
        out = flash_attention(q, ck, cv, q_pos=pos, kv_pos=all_pos, causal=cfg.causal,
                              kv_valid=valid)
        new_cache = cache
    else:
        # write the fresh K/V at each row's cursor, then attend over the cache
        write_at(cache["k"], k, write_index)
        write_at(cache["v"], v, write_index)
        s_max = cache["k"].shape[1]
        all_pos = torch.arange(s_max, device=x.device)[None, :].expand(b, -1)
        valid = all_pos < (cache_len + s)[:, None]
        out = flash_attention(q, cache["k"], cache["v"], q_pos=pos, kv_pos=all_pos,
                              causal=cfg.causal, kv_valid=valid)
        new_cache = cache

    y = linear(cfg.o, p["o"], out.reshape(b, s, cfg.n_heads * cfg.d_head))
    return y, new_cache


def memory_kv(cfg: AttnCfg, p: Params, memory: torch.Tensor) -> Params:
    """K/V of a cross-attention memory (B, T, D): {"k", "v"} (B, T, KV, Dh),
    without RoPE."""
    b, t, _ = memory.shape
    return {name: linear(getattr(cfg, name), p[name], memory).reshape(b, t, cfg.n_kv_heads,
                                                                      cfg.d_head)
            for name in ("k", "v")}


def cross_attention(cfg: AttnCfg, p: Params, x: torch.Tensor, kv: Params) -> torch.Tensor:
    """x (B, S, D) attends to every position of a memory's K/V (`memory_kv`,
    or a cache's rows of them, upcast to x's dtype): non-causal and unmasked,
    as the reference's decoder cross-attention. Returns (B, S, D)."""
    b, s, _ = x.shape
    q = linear(cfg.q, p["q"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    zeros = torch.zeros((b, s), dtype=torch.long, device=x.device)
    out = flash_attention(q, kv["k"].to(x.dtype), kv["v"].to(x.dtype), q_pos=zeros,
                          kv_pos=zeros, causal=False)
    return linear(cfg.o, p["o"], out.reshape(b, s, cfg.n_heads * cfg.d_head))
