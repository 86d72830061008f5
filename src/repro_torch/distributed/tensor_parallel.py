"""Tensor-parallel serving: how a rank holds its shard of a model.

The reference shards with GSPMD (`repro.serving.engine`, mesh=, DESIGN.md
§6.4): it places params on `ShardingRules`' specs and lets XLA insert the
collectives. The port writes the same placement by hand, per rank, and runs
it with the collectives of `launch/mesh.py` (all_reduce only, in the
forward; `models/sharded.py`):

  * column-parallel sites (q, k, v, gate, up) hold their M shard of
    table_q (and of an m-shared table_scale, and of the bias);
  * row-parallel sites (o, down; `sharding.site_roles`) hold their C shard
    of centroids and table_q, and take the rank's columns of the input;
  * attention runs on the rank's whole heads: q, k and v arrive as M shards
    that cover H / tp query heads and KV / tp KV heads, so GQA groups stay
    together; qk-norm and RoPE are per head. The KV cache holds the rank's
    KV heads, dense or paged. The paged pool is the reference's spec (KV
    heads over "model"); the reference shards the dense cache's sequence
    instead, a kept difference. Where a shard would split a head or a GQA
    group, or the specs do not shard a block's sites as column/row pairs,
    the block's sites are replicated (every rank computes them whole);
  * the embedding is vocab-sharded and the tied logits vocab-sharded and
    gathered; an untied head's vocab columns are gathered the same way.
    Where the spec does not shard the vocab, they are replicated. Dense
    sites (layer 0 under "all_but_first") follow the same specs with plain
    matmuls.

A rank's bundle (`local_bundle`) names each site's role in its config
(`common.SiteCfg.tp`, `transformer.LMCfg.vocab_sharded`); the mesh is bound
per forward (`ModelBundle.forward_step(mesh=)`). Families this slice leaves
out (`tp_refusal`): MoE (expert-parallel over the data axes), SSM, hybrid,
enc-dec and the vision-LM, ROADMAP Queue A item 5. The lm kind with dense
blocks is served: qwen3_1p7b, llama3_8b, minitron_8b, command_r_35b and
bert_base.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.configs import ModelBundle
from repro_torch.core.amm import Mode
from repro_torch.distributed.sharding import ShardingRules, site_roles
from repro_torch.weights import tree_map_ref


def tp_refusal(bundle: ModelBundle) -> str | None:
    """Why this slice's tensor parallelism cannot serve the bundle, or None."""
    arch = bundle.arch
    if bundle.kind == "lm" and not arch.takes_embeds and not arch.mrope_sections and all(
            b.kind == "dense" for _, b in bundle.cfg.segments):
        if bundle.mode == Mode.LUT_TRAIN:
            return "tensor parallelism serves DENSE and LUT_INFER bundles, not LUT_TRAIN"
        return None
    return (f"tensor-parallel serving of {arch.name} ({arch.family}) is not ported: this slice "
            f"serves the lm kind with dense blocks; MoE (expert-parallel over the data axes), "
            f"SSM, hybrid, enc-dec and vision-LM wait for ROADMAP Queue A item 5")


# ---------------------------------------------------------------------------
# layout: which dim of each leaf a rank holds a shard of
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """A model's tensor-parallel layout at degree `tp`: each sharded site's
    role ({site path: "col" | "col_gather" | "row"}), whether the embedding
    is vocab-sharded, and the sharded dim of each param leaf of a layer
    ({reference path: dim})."""

    tp: int
    roles: dict[str, str]
    vocab: bool
    dims: dict[str, int]


def _site_axes(rules: ShardingRules, path: str, specs: dict, site, roles) -> tuple[bool, bool]:
    """(output dim over "model", input dim over "model") of a site's spec."""
    leaf = "table_q" if site.mode == Mode.LUT_INFER else "w"
    spec = rules.param_spec(f"{path}/{leaf}", tuple(specs[f"{path}/{leaf}"].shape),
                            site_roles=roles)
    eff = spec[len(spec) - (3 if leaf == "table_q" else 2):]
    return eff[-1] == "model", eff[0] == "model"


def layout(bundle: ModelBundle, rules: ShardingRules) -> Layout:
    """The layout `rules` gives `bundle` (a `tp_refusal`-free bundle)."""
    why = tp_refusal(bundle)
    if why is not None:
        raise ValueError(why)
    tp = rules.tp
    specs = flatten_tree(bundle.param_specs())
    roles_reg = site_roles(bundle)
    roles: dict[str, str] = {}
    for i, (_, bcfg) in enumerate(bundle.cfg.segments):
        a, m = bcfg.attn, bcfg.mlp
        att = [(f"segments/{i}/attn/{n}", getattr(a, n)) for n in ("q", "k", "v", "o")]
        axes = [_site_axes(rules, p, specs, s, roles_reg) for p, s in att]
        if (all(out for out, _ in axes[:3]) and axes[3][1]
                and a.n_heads % tp == 0 and a.n_kv_heads % tp == 0):
            roles.update({p: ("row" if n == 3 else "col") for n, (p, _) in enumerate(att)})
        mlp = [(f"segments/{i}/{s.name}", s)
               for s in ([m.gate] if m.gated else []) + [m.up, m.down]]
        axes = [_site_axes(rules, p, specs, s, roles_reg) for p, s in mlp]
        if all(out for out, _ in axes[:-1]) and axes[-1][1]:
            roles.update({p: ("row" if p.endswith("/down") else "col") for p, _ in mlp})
    if bundle.cfg.lm_head is not None and _site_axes(rules, "lm_head", specs,
                                                     bundle.cfg.lm_head, roles_reg)[0]:
        roles["lm_head"] = "col_gather"
    vocab = rules.param_spec("embed/table", tuple(specs["embed/table"].shape))[0] == "model"

    dims: dict[str, int] = {"embed/table": 0} if vocab else {}
    for path, role in roles.items():
        stacked = path.startswith("segments/")
        shape = {p.rsplit("/", 1)[1]: tuple(s.shape)[1 if stacked else 0:]
                 for p, s in specs.items() if p.rsplit("/", 1)[0] == path}
        if role.startswith("col"):
            want = {"table_q": 2, "w": 1, "b": 0}
            if "table_scale" in shape and shape["table_scale"][2] > 1:
                want["table_scale"] = 2
        else:
            want = {"table_q": 0, "centroids": 0, "w": 0}
            if "table_scale" in shape and shape["table_scale"][0] > 1:
                want["table_scale"] = 0
        dims.update({f"{path}/{k}": d for k, d in want.items() if k in shape})
    return Layout(tp=tp, roles=roles, vocab=vocab, dims=dims)


def local_bundle(bundle: ModelBundle, lay: Layout) -> ModelBundle:
    """The bundle a rank runs: its sites at shard dims with their roles, its
    attention at its heads."""
    tp = lay.tp

    def local(site, path):
        role = lay.roles[path]
        dims = ({"d_out": site.d_out // tp} if role.startswith("col")
                else {"d_in": site.d_in // tp})
        return dataclasses.replace(site, tp=role, **dims)

    segs = []
    for i, (count, bcfg) in enumerate(bundle.cfg.segments):
        a, m = bcfg.attn, bcfg.mlp
        if f"segments/{i}/attn/q" in lay.roles:
            a = dataclasses.replace(
                a, n_heads=a.n_heads // tp, n_kv_heads=a.n_kv_heads // tp,
                **{n: local(getattr(a, n), f"segments/{i}/attn/{n}") for n in "qkvo"})
        if f"segments/{i}/mlp/up" in lay.roles:
            names = (("gate",) if m.gated else ()) + ("up", "down")
            m = dataclasses.replace(m, d_ff=m.d_ff // tp,
                                    **{n: local(getattr(m, n), f"segments/{i}/mlp/{n}")
                                       for n in names})
        segs.append((count, dataclasses.replace(bcfg, attn=a, mlp=m)))
    cfg = bundle.cfg
    head = local(cfg.lm_head, "lm_head") if "lm_head" in lay.roles else cfg.lm_head
    cfg = dataclasses.replace(cfg, segments=tuple(segs), lm_head=head,
                              vocab_sharded=lay.vocab)
    return dataclasses.replace(bundle, cfg=cfg)


def shard_of(a: torch.Tensor, dim: int | None, rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s part of `a` along `dim` (all of it when None)."""
    if dim is None:
        return a
    n = a.shape[dim] // tp
    return a.narrow(dim, rank * n, n)


def shard_arrays(flat: dict[str, torch.Tensor], lay: Layout, rank: int) -> dict[str, Any]:
    """{reference path: rank's part} of the reference's stacked leaves (a
    stacked leaf's layer axis comes first)."""
    out = {}
    for p, a in flat.items():
        d = lay.dims.get(p)
        if d is not None and p.startswith("segments/"):
            d += 1
        out[p] = shard_of(a, d, rank, lay.tp)
    return out


@dataclasses.dataclass(frozen=True)
class RankParams:
    """A rank's shards of a model's params (port layout, on its device), as
    `serving.artifact.load_artifact(..., mesh=)` reads them: the engine
    takes them as they are."""

    tree: Any
    rank: int
    tp: int


def place(bundle: ModelBundle, params: Any, rules: ShardingRules, mesh
          ) -> tuple[ModelBundle, Any, Layout]:
    """(local bundle, the rank's params on its device, layout) of a full
    param tree (port layout, any device), or of `RankParams`."""
    lay = layout(bundle, rules)
    local = local_bundle(bundle, lay)
    if isinstance(params, RankParams):
        if (params.rank, params.tp) != (mesh.model_rank, rules.tp):
            raise ValueError(f"params of rank {params.rank} of {params.tp}, the mesh's rank "
                             f"{mesh.model_rank} of {rules.tp}")
        return local, params.tree, lay

    def take(path, leaf):
        part = shard_of(leaf, lay.dims.get(path), mesh.model_rank, lay.tp)
        return part.to(mesh.device).contiguous()

    return local, tree_map_ref(take, params), lay


def kernel_signatures(local: ModelBundle, lay: Layout,
                      dtype: str) -> list[tuple[int, int, int, int, str]]:
    """The distinct (M, C, K, V, dtype) at which a rank's LUT kernel sites
    launch: column sites at M / tp in the compute dtype, row sites at C / tp
    in float32 (their unit-scale accumulators)."""
    sigs: dict[tuple, None] = {}
    for site in local.sites():
        lut = site.lut
        if site.mode != Mode.LUT_INFER or lut is None or not lut.use_kernel:
            continue
        row = lay.roles.get(site.path) == "row"
        sigs[(site.d_out, site.d_in // lut.v, lut.k, lut.v, "float32" if row else dtype)] = None
    return list(sigs)
