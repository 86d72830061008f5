"""Tensor parallelism: how a rank holds its shard of a model, to serve it
or (`train=True`) to train it.

The reference shards with GSPMD (`repro.serving.engine`, mesh=, DESIGN.md
§6.4): it places params on `ShardingRules`' specs and lets XLA insert the
collectives. The port writes the same placement by hand, per rank, and runs
it with the collectives of `launch/mesh.py` (all_reduce only, in the
forward; `models/sharded.py`):

  * column-parallel sites (q, k, v, gate, up) hold their M shard of
    table_q (and of an m-shared table_scale, and of the bias);
  * row-parallel sites (o, down, out_proj; `sharding.site_roles`) hold
    their C shard of centroids and table_q, and take the rank's columns of
    the input;
  * attention runs on the rank's whole heads: q, k and v arrive as M shards
    that cover H / tp query heads and KV / tp KV heads, so GQA groups stay
    together; qk-norm and RoPE are per head. The KV cache holds the rank's
    KV heads, dense or paged. Where a shard would split a head or a GQA
    group, or the specs do not shard a block's sites as column/row pairs,
    the block's sites are replicated (every rank computes them whole);
  * an MoE block (arctic_480b, llama4_maverick_400b) is expert-parallel
    over "model": rank r holds experts [r E/tp, (r+1) E/tp) whole
    (table_q, table_scale, a dense expert's w; the codebooks they share
    replicated), every rank routes every token with the replicated router,
    runs the tokens routed to its experts and all-reduces the combined
    output once (`moe.moe`). Attention, arctic's dense residual MLP and
    maverick's shared expert take the roles above;
  * a mamba2 block (mamba2_370m, zamba2_1p2b's backbone) runs the rank's
    SSD heads. in_proj is one site whose columns are [z | x | B | C | dt]:
    the rank holds a head-aligned selection of them (its heads' z, x and dt
    columns, the B and C columns whole), a column site all the same; the
    conv weights take the same channel selection, dt_bias, A_log and D the
    rank's heads. The gated norm gathers the gated activations and
    normalizes the whole d_inner row (`sharded.gated_rmsnorm`); out_proj is
    row-parallel. The SSM state cache holds the rank's heads, the conv
    window its channels;
  * the hybrid (zamba2_1p2b): its mamba stack as above, its shared
    attention and MLP the attention and MLP roles; fuse and out have no
    column/row partner and stay replicated;
  * the enc-dec (whisper_tiny): the encoder's blocks (bidirectional
    attention, a non-gated MLP) and the decoder's self attention, cross
    attention and MLP take the attention and MLP roles; the cross
    attention's q, k and v are column sites (k and v read the encoder's
    output, q the decoder's stream) and its o a row site, and the per-row
    cross K/V cache holds the rank's KV heads. The vision-LM (qwen2_vl_7b)
    is a decoder LM that takes embedding rows and M-RoPE positions (3, B,
    S): its attention runs the rank's heads on all three streams, its
    untied head is vocab-sharded like any other;
  * the embedding is vocab-sharded and the tied logits vocab-sharded and
    gathered; an untied head's vocab columns are gathered the same way.
    Where the spec does not shard the vocab, they are replicated. Dense
    sites (layer 0 under "all_but_first") follow the same specs with plain
    matmuls.

Kept differences from `ShardingRules` (`Layout.kept` names the ones a
layout takes; ROADMAP lists them):

  "experts_over_model"  the experts over "model" (the spec, at data = 1,
      puts E over "data" and each expert's M over "model"), and the router
      replicated (the spec splits its E columns): the mesh has all_reduce
      only; expert parallelism costs one all-reduce per MoE layer and keeps
      each expert's contraction whole, where the M split would need two
      gathers;
  "ssm_heads"  in_proj's head-aligned column selection (the spec splits M
      contiguously, which cuts through the [z | x | B | C | dt] blocks), the
      conv weights' and conv window's channel selection (the spec
      replicates conv_w/conv_b and splits the window's channels
      contiguously) and the rank's heads of dt_bias, A_log and D (the spec
      replicates them);
  "experts_over_data_and_model"  in training on a ("data", "model") mesh,
      each model column's experts split over the data ranks too: rank (d,
      m) holds E / (dp tp) experts whole, experts (m dp + d) E / (dp tp)
      onwards, and tokens reach them by an all-to-all over "data" (the spec
      puts E over "data" and each expert's M over "model", which would need
      an all-max of each expert's fake-quant scale and two gathers); the
      router replicated as above;
  "heads_whole"  an attention whose heads or GQA groups a shard would
      split (whisper_tiny's 6 heads at tp 4) stays whole on every rank,
      where the specs split its sites: every rank computes it;
  "embed_whole"  an embedding whose vocab does not divide by tp (whisper's
      51865) stays whole on every rank, where the spec splits its d_model:
      the lookup and the tied logits are then the unsharded ones on every
      rank, and a training rank's loss the plain cross-entropy;
  "cross_kv_by_heads"  the enc-dec's cross K/V cache holds the rank's KV
      heads of every row (the spec splits its 1500 frames over "model", as
      it does the self-attention cache's sequence);
  and for every model, the dense KV cache by KV heads (the spec shards its
  sequence).

A rank's bundle (`local_bundle`) names each site's role in its config
(`common.SiteCfg.tp`, `moe.MoECfg.ep`, `mamba2.Mamba2Cfg.tp`,
`transformer.LMCfg.vocab_sharded`, `hybrid.HybridCfg.vocab_sharded`,
`encdec.EncDecCfg.vocab_sharded`); the mesh is bound per forward
(`ModelBundle.forward_step(mesh=)`, `train_step.make_serve_step(mesh=)`).
Every family serves; the engine drives the token-fed ones
(`serving.engine.engine_refusal` keeps refusing the enc-dec and the
vision-LM, which need frames or embeddings per request). Left out of
serving (`tp_refusal`): LUT_TRAIN bundles.

Training (`layout(..., train=True)`, the reference's sharded step under
`ShardingRules(mesh)`, fsdp off or on): every family (the decoder LMs of
every block kind, the hybrid, the enc-dec and the vision-LM), DENSE and
LUT_TRAIN. A LUT_TRAIN column
site holds its M shard of the frozen `w` and `b`, its `centroids` and
`log_t` whole; a row site its C shard of `centroids` and the matching C·V
rows of `w`, `b` and `log_t` whole (the specs' cuts). The vocab head stays
vocab-sharded ("col", never "col_gather"; `LMCfg.gather_logits` off) and
the loss is vocab-parallel (`sharded.vocab_cross_entropy`); under
"embed_whole" the logits and the loss are whole on every rank. A replicated
leaf that a rank uses inside its shard of the forward takes only that
shard's part of the gradient, which the step sums over "model"
(`Layout.partial`): a sharded attention's qk-norm scales, a LUT_TRAIN
column site's centroids and log_t, a row site's log_t, an expert-parallel
layer's router and its expert sites' shared codebooks and log_t, a mamba2
block's gated-norm scale; and blocks of a leaf: the B and C columns of
in_proj and channels of conv_w and conv_b, whole on every rank and used by
its heads. A replicated leaf in front of a `sharded.copy` (the layer norms,
final_norm) has its whole gradient already. An expert leaf held by one
data rank takes its gradient from every data rank's tokens (`Layout.
over_data`): the step scales it by 1 / dp instead of the data mean.
LUT_TRAIN expert, mamba and shared-block sites cut their frozen `w` with
their site. `place` copies only the rank's part of each leaf. Left out of
training (`tp_refusal(train=True)`): LUT_INFER bundles.

FSDP (`ShardingRules(fsdp=True)`): inside its model shard a rank holds its
part over "data" of each leaf the spec splits over "data" too (`Layout.
fsdp`: the embedding, every 2-D `w`, a frozen one too, along the spec's
"data" dim), but an expert leaf the rank already holds alone and a leaf
whose "data" dim is the one its model shard is cut along (experts over
"model": they stay whole over "data"). `place` and `init_rank` cut it; the
local bundle names the leaves (`LMCfg.fsdp`, `HybridCfg.fsdp`,
`EncDecCfg.fsdp`) and the forward gathers them per block (`models/
sharded.py`; each of the enc-dec's encoder and decoder blocks inside its
recomputed function), but a vision-LM's embedding, which a model that
takes embeddings does not read (its zero gradient updates it all the
same). On a data mesh
(model = 1) the training layout has no roles and no model cuts: the data
cuts alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.configs import ModelBundle
from repro_torch.core.amm import Mode
from repro_torch.distributed.sharding import ShardingRules, site_roles
from repro_torch.weights import is_stacked, tree_map_ref

# the expert-stacked sites: contracted in plain tensor ops, never a kernel
EXPERT_KINDS = ("moe/gate", "moe/up", "moe/down")

# how a rank cuts one dim of a leaf: (dim, blocks). blocks None: the dim in
# tp equal parts; else the dim is the concatenation of blocks (length,
# split) and the rank takes its tp-th part of each split block and every
# unsplit block whole
Cut = tuple[int, "tuple[tuple[int, bool], ...] | None"]


def tp_refusal(bundle: ModelBundle, *, train: bool = False) -> str | None:
    """Why tensor parallelism cannot serve (or, with `train`, train) the
    bundle, or None. Every family of the reference is admitted: the
    enc-dec and the vision-LM through `ModelBundle.forward_step(mesh=)` and
    `ModelBundle.loss(mesh=)`, which the serving engine does not drive
    (`serving.engine.engine_refusal`)."""
    if train:
        if bundle.mode == Mode.LUT_INFER:
            return "tensor-parallel training takes DENSE and LUT_TRAIN bundles, not LUT_INFER"
        return None
    if bundle.mode == Mode.LUT_TRAIN:
        return "tensor parallelism serves DENSE and LUT_INFER bundles, not LUT_TRAIN"
    return None


# ---------------------------------------------------------------------------
# layout: which part of each leaf a rank holds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """A model's tensor-parallel layout at degree `tp`: each sharded site's
    role ({site path: "col" | "col_gather" | "row" | "ep"}), whether the
    embedding is vocab-sharded, the cut of each sharded param leaf of a
    layer ({reference path: Cut}) and the kept differences from the specs
    it takes."""

    tp: int
    roles: dict[str, str]
    vocab: bool
    cuts: dict[str, Cut]
    kept: tuple[str, ...] = ()
    train: bool = False
    # the leaves whose gradient a rank holds only its shard's part of, summed
    # over "model" by the step: {reference path: None (the whole leaf) or
    # (dim, ((start, stop), ...)): only these ranges of the rank's leaf}
    partial: dict[str, Any] = dataclasses.field(default_factory=dict)
    # training on a ("data", "model") mesh: the data degree `over_data`'s
    # leaves (the expert sites') are cut over too, rank (d, m) taking part
    # m * data + d of tp * data along their cut dim
    data: int = 1
    over_data: frozenset[str] = frozenset()
    # FSDP (`ShardingRules(fsdp=True)`): {reference path: dim} of the leaves a
    # rank holds only its part of over the `dp` data ranks, along that dim of
    # its per-layer model shard (the spec's "data" dim)
    fsdp: dict[str, int] = dataclasses.field(default_factory=dict)
    dp: int = 1

    def part(self, path: str, a: torch.Tensor, data_rank: int, model_rank: int,
             *, stacked: bool = False) -> torch.Tensor:
        """Rank (data_rank, model_rank)'s part of the whole leaf `a` at the
        reference path `path` (a stacked leaf's layer axis first where
        `stacked`): its model shard, then under FSDP its data part of that."""
        c = self.cuts.get(path)
        if c is not None and stacked:
            c = (c[0] + 1, c[1])
        if path in self.over_data:
            a = cut(a, c, model_rank * self.data + data_rank, self.tp * self.data)
        else:
            a = cut(a, c, model_rank, self.tp)
        if path in self.fsdp:
            a = cut(a, (self.fsdp[path] + stacked, None), data_rank, self.dp)
        return a


def _in_proj_blocks(mc) -> tuple[tuple[int, bool], ...]:
    """in_proj's columns [z | x | B | C | dt]: the heads' blocks split, B and C whole."""
    gn = mc.n_groups * mc.ssm_state
    return ((mc.d_inner, True), (mc.d_inner, True), (gn, False), (gn, False),
            (mc.n_heads, True))


def _conv_blocks(mc) -> tuple[tuple[int, bool], ...]:
    """The conv's channels [x | B | C]: x split by heads, B and C whole."""
    gn = mc.n_groups * mc.ssm_state
    return ((mc.d_inner, True), (gn, False), (gn, False))


def _unsplit_ranges(blocks, tp: int) -> tuple[tuple[int, int], ...]:
    """The ranges of a rank's block-selected part that hold unsplit blocks."""
    out, at = [], 0
    for n, split in blocks:
        size = n // tp if split else n
        if not split:
            out.append((at, at + size))
        at += size
    return tuple(out)


def _blocks(bundle: ModelBundle) -> list[tuple[str, Any]]:
    """(path prefix, block config) of every kind of block the model runs in
    layers (the enc-dec's decoder block, of no block kind, aside)."""
    if bundle.kind == "hybrid":
        return [("mamba_stack", bundle.cfg.mamba_block)]
    if bundle.kind == "encdec":
        return [("encoder", bundle.cfg.enc_block)]
    return [(f"segments/{i}", b) for i, (_, b) in enumerate(bundle.cfg.segments)]


def layout(bundle: ModelBundle, rules: ShardingRules, *, train: bool = False) -> Layout:
    """The layout `rules` gives `bundle` (a `tp_refusal`-free bundle), to
    serve it or (`train`) to train it."""
    why = tp_refusal(bundle, train=train)
    if why is not None:
        raise (NotImplementedError if train else ValueError)(why)
    tp = rules.tp
    # training splits the experts over "data" too, where they divide
    dp = rules.data if train else 1
    # a data mesh's training layout: no model axis, FSDP's data cuts alone
    data_only = train and tp == 1
    specs = flatten_tree(bundle.param_specs())
    reg = site_roles(bundle)
    roles: dict[str, str] = {}
    selected: dict[str, tuple] = {}          # a column site's blocks (in_proj)
    cuts: dict[str, Cut] = {}
    kept: list[str] = []
    partial: dict[str, Any] = {}
    over_data: set[str] = set()
    ep_data = 1

    def axes(path: str, site) -> tuple[bool, bool]:
        """(output dim over "model", input dim over "model") of a site's spec."""
        leaf = "table_q" if site.mode == Mode.LUT_INFER else "w"
        spec = rules.param_spec(f"{path}/{leaf}", tuple(specs[f"{path}/{leaf}"].shape),
                                site_roles=reg)
        eff = spec[len(spec) - (3 if leaf == "table_q" else 2):]
        return eff[-1] == "model", eff[0] == "model"

    def splits(prefix: str, cols: list, row) -> bool:
        """Whether the specs shard the column sites `cols` and the row site
        `row` as a pair."""
        return (all(axes(f"{prefix}/{s.name}", s)[0] for s in cols)
                and axes(f"{prefix}/{row.name}", row)[1])

    def pair(prefix: str, cols: list, row, ok: bool = True) -> bool:
        """The column sites `cols` and the row site `row` take their roles
        where `ok` and the specs shard them as a pair."""
        paths = [f"{prefix}/{s.name}" for s in cols]
        row_path = f"{prefix}/{row.name}"
        if row.mode == Mode.LUT_TRAIN:       # its centroids' C shard aligns with w's rows
            ok = ok and row.lut.codebooks(row.d_in) % tp == 0
        if not (ok and splits(prefix, cols, row)):
            return False
        roles.update(dict.fromkeys(paths, "col"))
        roles[row_path] = "row"
        return True

    def attn(prefix: str, a) -> None:
        heads = a.n_heads % tp == 0 and a.n_kv_heads % tp == 0
        if pair(prefix, [a.q, a.k, a.v], a.o, heads):
            if a.qk_norm:
                base = f"{prefix}/{a.q.name}".rsplit("/", 1)[0]      # the attention's params
                partial.update(dict.fromkeys(f"{base}/{n}/scale" for n in ("q_norm", "k_norm")))
        elif not heads and splits(prefix, [a.q, a.k, a.v], a.o):
            # the specs shard the sites, but a shard would split a head or a
            # GQA group: the block stays whole on every rank
            kept.append("heads_whole")

    def mlp(prefix: str, m) -> None:
        if m is not None:
            pair(prefix, ([m.gate] if m.gated else []) + [m.up], m.down)

    for prefix, b in [] if data_only else _blocks(bundle):
        if b.kind == "mamba":
            mc = b.mamba
            if pair(prefix, [mc.in_proj], mc.out_proj,
                    mc.n_heads % tp == 0 and mc.n_groups == 1):
                path = f"{prefix}/{mc.in_proj.name}"
                selected[path] = _in_proj_blocks(mc)
                leaf = path.rsplit("/", 1)[0]
                cuts.update({f"{leaf}/conv_w": (1, _conv_blocks(mc)),
                             f"{leaf}/conv_b": (0, _conv_blocks(mc))})
                cuts.update({f"{leaf}/{n}": (0, None) for n in ("dt_bias", "A_log", "D")})
                kept.append("ssm_heads")
                # B and C whole on every rank, used by its heads; the norm's
                # scale whole, used at the rank's columns
                for name, (dim, blocks) in (("in_proj/w", (1, selected[path])),
                                            ("in_proj/b", (0, selected[path])),
                                            ("conv_w", (1, _conv_blocks(mc))),
                                            ("conv_b", (0, _conv_blocks(mc)))):
                    if f"{leaf}/{name}" in specs:
                        partial[f"{leaf}/{name}"] = (dim, _unsplit_ranges(blocks, tp))
                partial[f"{leaf}/norm/scale"] = None
            continue
        attn(prefix, b.attn)
        mlp(prefix, b.mlp)
        mlp(prefix, b.residual_mlp)
        if b.kind == "moe":
            mlp(prefix, b.moe.shared)
            split = tp * dp if b.moe.n_experts % (tp * dp) == 0 else tp
            if b.moe.n_experts % split == 0:
                roles.update({f"{prefix}/{k}": "ep" for k in EXPERT_KINDS})
                kept.append("experts_over_model" if split == tp else "experts_over_data_and_model")
                ep_data = split // tp
                if train:                    # the router's gradient: the rank's column's
                    partial.update(dict.fromkeys(
                        p for p in specs if p.startswith(f"{prefix}/moe/router/")))
    if data_only:
        pass
    elif bundle.kind == "hybrid":
        attn("shared", bundle.cfg.shared_attn)
        mlp("shared", bundle.cfg.shared_mlp)
    elif bundle.kind == "encdec":
        cfg = bundle.cfg
        attn("decoder", cfg.dec_self)
        attn("decoder", cfg.dec_cross)
        if f"decoder/{cfg.dec_cross.k.name}" in roles:
            kept.append("cross_kv_by_heads")
        mlp("decoder", cfg.dec_mlp)
    elif bundle.cfg.lm_head is not None and axes("lm_head", bundle.cfg.lm_head)[0]:
        roles["lm_head"] = "col" if train else "col_gather"
    embed_spec = rules.param_spec("embed/table", tuple(specs["embed/table"].shape))
    vocab = not data_only and embed_spec[0] == "model"
    if not data_only and embed_spec[1] == "model":
        kept.append("embed_whole")

    if vocab:
        cuts["embed/table"] = (0, None)
    for path, role in roles.items():
        shape = {p.rsplit("/", 1)[1]: tuple(s.shape)[1 if is_stacked(p) else 0:]
                 for p, s in specs.items() if p.rsplit("/", 1)[0] == path}
        if role == "ep":
            want = {"w": 0, "table_q": 0, "table_scale": 0}
            if ep_data > 1:
                over_data.update(f"{path}/{k}" for k in want if k in shape)
        elif role.startswith("col"):
            want = {"table_q": 2, "w": 1, "b": 0}
            if "table_scale" in shape and shape["table_scale"][2] > 1:
                want["table_scale"] = 2
        else:
            want = {"table_q": 0, "centroids": 0, "w": 0}
            if "table_scale" in shape and shape["table_scale"][0] > 1:
                want["table_scale"] = 0
        cuts.update({f"{path}/{k}": (d, selected.get(path)) for k, d in want.items()
                     if k in shape})
        if "log_t" in shape:                 # LUT_TRAIN: the shared temperature ...
            partial[f"{path}/log_t"] = None
            if role != "row":                # ... and a column or expert site's codebooks
                partial[f"{path}/centroids"] = None
    fsdp: dict[str, int] = {}
    if train and rules.fsdp and rules.data > 1:
        # the spec's "data" dim of every leaf it splits over "data" too, but
        # the experts a rank already holds alone and a dim the rank's model
        # shard is cut along (the experts over "model": they stay whole)
        for path, ps in specs.items():
            if path in over_data:
                continue
            spec = rules.param_spec(path, tuple(ps.shape), site_roles=reg)
            if "data" in spec:
                d = spec.index("data") - is_stacked(path)
                if path not in cuts or cuts[path][0] != d:
                    fsdp[path] = d
    return Layout(tp=tp, roles=roles, vocab=vocab, cuts=cuts, kept=tuple(dict.fromkeys(kept)),
                  train=train, partial=partial, data=ep_data,
                  over_data=frozenset(over_data), fsdp=fsdp, dp=rules.data if fsdp else 1)


def local_bundle(bundle: ModelBundle, lay: Layout) -> ModelBundle:
    """The bundle a rank runs: its sites at shard dims with their roles, its
    attention at its heads, its experts, its SSD heads."""
    tp, roles = lay.tp, lay.roles

    def local(site, path):
        role = roles[path]
        dims = ({"d_out": site.d_out // tp} if role.startswith("col")
                else {"d_in": site.d_in // tp})
        return dataclasses.replace(site, tp=role, **dims)

    def attn(prefix, a):
        if f"{prefix}/{a.q.name}" not in roles:
            return a
        return dataclasses.replace(
            a, n_heads=a.n_heads // tp, n_kv_heads=a.n_kv_heads // tp,
            **{n: local(getattr(a, n), f"{prefix}/{getattr(a, n).name}") for n in "qkvo"})

    def mlp(prefix, m):
        if m is None or f"{prefix}/{m.up.name}" not in roles:
            return m
        names = (("gate",) if m.gated else ()) + ("up", "down")
        return dataclasses.replace(
            m, d_ff=m.d_ff // tp,
            **{n: local(getattr(m, n), f"{prefix}/{getattr(m, n).name}") for n in names})

    def moe(prefix, mo):
        mo = dataclasses.replace(mo, shared=mlp(prefix, mo.shared))
        if f"{prefix}/moe/gate" not in roles:
            return mo
        n = mo.n_experts // (tp * lay.data)
        return dataclasses.replace(
            mo, ep=tp, ep_data=lay.data,
            **{k: dataclasses.replace(getattr(mo, k), n_experts=n) for k in ("gate", "up", "down")})

    def mamba(prefix, mc):
        if f"{prefix}/{mc.in_proj.name}" not in roles:
            return mc
        di, h = mc.d_inner // tp, mc.n_heads // tp
        return dataclasses.replace(
            mc, d_inner=di, n_heads=h, tp=tp,
            in_proj=dataclasses.replace(mc.in_proj, tp="col",
                                        d_out=2 * di + 2 * mc.n_groups * mc.ssm_state + h),
            out_proj=local(mc.out_proj, f"{prefix}/{mc.out_proj.name}"))

    def block(prefix, b):
        if b.kind == "mamba":
            return dataclasses.replace(b, mamba=mamba(prefix, b.mamba))
        b = dataclasses.replace(b, attn=attn(prefix, b.attn), mlp=mlp(prefix, b.mlp),
                                residual_mlp=mlp(prefix, b.residual_mlp))
        return dataclasses.replace(b, moe=moe(prefix, b.moe)) if b.kind == "moe" else b

    cfg = bundle.cfg
    if bundle.kind == "encdec":
        cfg = dataclasses.replace(cfg, enc_block=block("encoder", cfg.enc_block),
                                  dec_self=attn("decoder", cfg.dec_self),
                                  dec_cross=attn("decoder", cfg.dec_cross),
                                  dec_mlp=mlp("decoder", cfg.dec_mlp),
                                  vocab_sharded=lay.vocab, gather_logits=not lay.train,
                                  fsdp=tuple(sorted(lay.fsdp.items())))
    elif bundle.kind == "hybrid":
        cfg = dataclasses.replace(cfg, mamba_block=block("mamba_stack", cfg.mamba_block),
                                  shared_attn=attn("shared", cfg.shared_attn),
                                  shared_mlp=mlp("shared", cfg.shared_mlp),
                                  vocab_sharded=lay.vocab, gather_logits=not lay.train,
                                  fsdp=tuple(sorted(lay.fsdp.items())))
    else:
        segs = tuple((count, block(f"segments/{i}", b))
                     for i, (count, b) in enumerate(cfg.segments))
        head = local(cfg.lm_head, "lm_head") if "lm_head" in roles else cfg.lm_head
        cfg = dataclasses.replace(cfg, segments=segs, lm_head=head, vocab_sharded=lay.vocab,
                                  gather_logits=not lay.train,
                                  fsdp=tuple(sorted(lay.fsdp.items())))
    return dataclasses.replace(bundle, cfg=cfg)


def cut(a: torch.Tensor, c: Cut | None, rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s part of `a` by the cut `c` (all of it when None): a
    view where the part is one block, else the blocks' parts concatenated."""
    if c is None:
        return a
    dim, blocks = c
    if blocks is None:
        n = a.shape[dim] // tp
        return a.narrow(dim, rank * n, n)
    parts, at = [], 0
    for n, split in blocks:
        parts.append(a.narrow(dim, at + rank * (n // tp), n // tp) if split
                     else a.narrow(dim, at, n))
        at += n
    return torch.cat(parts, dim)


def cut_stacked(path: str, a: torch.Tensor, lay: Layout, rank: int,
                data_rank: int = 0) -> torch.Tensor:
    """Rank `rank`'s part (on the model axis; `data_rank` on the data axis)
    of the reference's leaf `path` (a stacked leaf's layer axis first)."""
    return lay.part(path, a, data_rank, rank, stacked=is_stacked(path))


@dataclasses.dataclass(frozen=True)
class RankParams:
    """A rank's shards of a model's params (port layout, on its device), as
    `serving.artifact.load_artifact(..., mesh=)` reads them: the engine
    takes them as they are."""

    tree: Any
    rank: int
    tp: int


def place(bundle: ModelBundle, params: Any, rules: ShardingRules, mesh, *, train: bool = False
          ) -> tuple[ModelBundle, Any, Layout]:
    """(local bundle, the rank's params on its device, layout) of a full
    param tree (port layout, any device), or of `RankParams`, to serve or
    (`train`) to train. A serving rank's part that is one contiguous block
    of a leaf on the mesh's device is a view of it; a training rank's parts
    are copies of its parts alone (never of a whole leaf), so that the whole
    tree, which may be another process's memory (CUDA IPC views), can be
    freed."""
    lay = layout(bundle, rules, train=train)
    local = local_bundle(bundle, lay)
    if isinstance(params, RankParams):
        if (params.rank, params.tp) != (mesh.model_rank, rules.tp):
            raise ValueError(f"params of rank {params.rank} of {params.tp}, the mesh's rank "
                             f"{mesh.model_rank} of {rules.tp}")
        return local, params.tree, lay

    def take(path, leaf):
        part = lay.part(path, leaf, mesh.data_rank, mesh.model_rank).to(mesh.device)
        return part.clone(memory_format=torch.contiguous_format) if train else part.contiguous()

    return local, tree_map_ref(take, params), lay


def init_rank(bundle: ModelBundle, rules: ShardingRules, mesh, gen: torch.Generator, *,
              device: Any = None) -> tuple[ModelBundle, Any, Layout]:
    """(local bundle, the rank's params, layout) of `bundle.init(gen)` to
    train on `mesh`, `place(train=True)`'s of the whole init: every value
    drawn in the init's order, the rank keeping its parts. An expert stack
    keeps the rank's experts as it is drawn (`moe.expert_part`), so that no
    rank holds a whole stack (arctic_480b: 26.8 GB a layer); the other
    leaves are drawn whole, one layer (or the embedding, the head, the
    shared block) at a time, and cut at once (`transformer.init_keeping`):
    under FSDP too, a rank holds no more than one whole layer."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_keeping

    lay = layout(bundle, rules, train=True)
    d, m = mesh.data_rank, mesh.model_rank
    ep = {p for p, r in lay.roles.items() if r == "ep"}
    j, n = (m * lay.data + d, lay.tp * lay.data) if lay.over_data else (m, lay.tp)

    def keep(path, leaf):
        if path.rsplit("/", 1)[0] in ep:             # already the rank's experts
            return leaf
        return lay.part(path, leaf, d, m).clone(memory_format=torch.contiguous_format)

    def keep_group(prefix, tree):
        return tree_map_ref(lambda rel, leaf: keep(f"{prefix}/{rel}", leaf), tree)

    with moe.expert_part(j, n) if ep else contextlib.nullcontext(), init_keeping(keep_group):
        params = bundle.init(gen, device=device or mesh.device)
    return local_bundle(bundle, lay), params, lay


def kernel_signatures(local: ModelBundle, lay: Layout,
                      dtype: str) -> list[tuple[int, int, int, int, str]]:
    """The distinct (M, C, K, V, dtype) at which a rank's LUT kernel sites
    launch: column sites at their M shard (in_proj at its selection) in the
    compute dtype, row sites at C / tp in float32 (their unit-scale
    accumulators), replicated sites whole. The expert sites launch no
    kernel."""
    sigs: dict[tuple, None] = {}
    for site in local.sites():
        lut = site.lut
        if (site.mode != Mode.LUT_INFER or lut is None or not lut.use_kernel
                or site.kind in EXPERT_KINDS):
            continue
        row = lay.roles.get(site.path) == "row"
        sigs[(site.d_out, site.d_in // lut.v, lut.k, lut.v, "float32" if row else dtype)] = None
    return list(sigs)
