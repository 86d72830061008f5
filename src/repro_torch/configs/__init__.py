"""Architecture registry and model assembly, in PyTorch.

Counterpart of `repro.configs`: each `configs/<id>.py` defines `ARCH:
ArchSpec` with the published dims, and `build_model(arch, mode)` assembles
the model with every linear site resolved to dense or LUT by the arch's
replacement plan. Every arch of the reference: the dense family
(qwen3_1p7b, llama3_8b, minitron_8b, command_r_35b, and the paper's
bert_base), moe (arctic_480b, llama4_maverick_400b), ssm (mamba2_370m),
hybrid (zamba2_1p2b), the audio enc-dec (whisper_tiny: stub frames, encoder,
cross-attention; bundle kind "encdec") and the vision-LM backbone
(qwen2_vl_7b: M-RoPE over embedding inputs; kind "lm").
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.core.amm import LUTConfig, Mode
from repro_torch.core.plan import (  # noqa: F401  (re-exported: the plan API surface)
    PAPER_DEFAULT,
    LUTPlan,
    PlanRule,
    SitePolicy,
    SiteSelector,
    SiteSpec,
    rule,
)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharded
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import SiteCfg, cross_entropy


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Every field of `repro.configs.ArchSpec`, so that configs and (later)
    artifact manifests carry over unchanged."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    act: str = "silu"
    mlp_gated: bool = True
    qk_norm: bool = False
    use_bias: bool = False
    causal: bool = True
    rope_theta: float = 500_000.0
    mrope_sections: tuple[int, ...] = ()
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_shared_expert: bool = False
    moe_dense_residual: bool = False
    moe_group_tokens: int = 1024
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256
    # hybrid
    attn_every: int = 0
    # enc-dec (audio)
    n_enc_layers: int = 0
    enc_frames: int = 0
    takes_embeds: bool = False
    # LUT-NN settings (paper defaults: K=16, V aligned to site width, INT8)
    lut_k: int = 16
    lut_v: int = 32
    lut_bits: int = 8
    lut_int8_dot: bool = False
    lut_use_kernel: bool = False        # the CUDA LUT kernels at LUT sites
    lut_policy: str = "all_but_first"   # or "last_n:<n>", "all"
    lut_plan: LUTPlan | None = None     # when set, subsumes lut_policy and the lut_* flags
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"
    sub_quadratic: bool = False
    grad_accum: int = 1
    notes: str = ""

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model


# the reference's ARCH_IDS, in its order
ARCH_IDS = (
    "mamba2_370m",
    "llama3_8b",
    "minitron_8b",
    "qwen3_1p7b",
    "command_r_35b",
    "llama4_maverick_400b",
    "arctic_480b",
    "qwen2_vl_7b",
    "whisper_tiny",
    "zamba2_1p2b",
)
EXTRA_IDS = ("bert_base",)           # the paper's own model


def get_arch(name: str) -> ArchSpec:
    if name not in ARCH_IDS + EXTRA_IDS:
        raise ValueError(f"unknown arch {name!r} (known: {ARCH_IDS + EXTRA_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}").ARCH


def arch_to_dict(arch: ArchSpec) -> dict[str, Any]:
    """JSON-safe dict of every ArchSpec field (tuples become lists), the
    plan through its own schema: `repro.configs.arch_to_dict`'s format."""
    out = dataclasses.asdict(dataclasses.replace(arch, lut_plan=None))
    for k, v in out.items():
        if isinstance(v, tuple):
            out[k] = list(v)
    out["lut_plan"] = arch.lut_plan.to_dict() if arch.lut_plan is not None else None
    return out


def arch_from_dict(d: dict[str, Any]) -> ArchSpec:
    """Rebuild an ArchSpec from `arch_to_dict` output (the port's or the
    reference's). Unknown keys are ignored; lists become tuples; a missing
    required field raises ValueError."""
    fields = {f.name: f for f in dataclasses.fields(ArchSpec)}
    kw: dict[str, Any] = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if k == "lut_plan":
            kw[k] = LUTPlan.from_dict(v) if v else None
            continue
        kw[k] = tuple(v) if isinstance(v, list) else v
    missing = [n for n, f in fields.items()
               if n not in kw and f.default is dataclasses.MISSING
               and f.default_factory is dataclasses.MISSING]
    if missing:
        raise ValueError(f"arch dict missing required fields: {missing}")
    return ArchSpec(**kw)


def reduce_arch(arch: ArchSpec, **overrides: Any) -> ArchSpec:
    """Shrink an arch to a CPU-testable config of the same family, exactly as
    `repro.configs.reduce_arch` does (same defaults, same overrides)."""
    small: dict[str, Any] = dict(
        n_layers=min(arch.n_layers, 4),
        d_model=128,
        d_ff=0 if arch.d_ff == 0 else 256,
        vocab=512,
        param_dtype="float32",
        grad_accum=1,
    )
    if arch.n_heads:
        small.update(n_heads=4, d_head=32,
                     n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_kv_heads < arch.n_heads else 4)
    if arch.n_experts:
        small.update(n_experts=4, top_k=arch.top_k)
    if arch.ssm_state:
        small.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=8)
    if arch.attn_every:
        small.update(attn_every=2)
    if arch.n_enc_layers:
        small.update(n_enc_layers=2, enc_frames=8)
    if arch.mrope_sections:
        small.update(mrope_sections=(4, 6, 6))
    small.update(lut_v=16)
    small.update(overrides)
    out = dataclasses.replace(arch, **small)
    # a depth cut can strand a last_n policy past the new layer count: clamp
    if out.lut_plan is not None:
        clamped = tuple(
            dataclasses.replace(
                r, select=dataclasses.replace(
                    r.select, n=min(r.select.n, out.n_layers),
                    layer_set=tuple(sorted({
                        min(i, out.n_layers - 1) for i in r.select.layer_set
                    })),
                )
            ) if r.select.layers in ("last_n", "set") else r
            for r in out.lut_plan.rules
        )
        out = dataclasses.replace(out, lut_plan=dataclasses.replace(out.lut_plan, rules=clamped))
    elif out.lut_policy.startswith("last_n:"):
        n = int(out.lut_policy.split(":", 1)[1])
        if n > out.n_layers:
            out = dataclasses.replace(out, lut_policy=f"last_n:{out.n_layers}")
    return out


def effective_plan(arch: ArchSpec) -> LUTPlan:
    """`lut_plan` when set, else the single-rule plan parsed from `lut_policy`
    and the flat `lut_*` flags."""
    if arch.lut_plan is not None:
        return arch.lut_plan
    return LUTPlan.from_policy_string(
        arch.lut_policy,
        default=SitePolicy(
            k=arch.lut_k, v=arch.lut_v, bits=arch.lut_bits, per_column=False,
            int8_dot=arch.lut_int8_dot, use_kernel=arch.lut_use_kernel,
        ),
    )


class _PlanResolver:
    """Resolves every linear site of one build to (mode, LUTConfig): the
    bundle's mode where the plan replaces the site's (layer, kind), DENSE
    otherwise (dense sites carry the plan default's config as metadata)."""

    def __init__(self, arch: ArchSpec, mode: Mode):
        self.arch = arch
        self.mode = mode
        self.plan = effective_plan(arch).validate(arch.n_layers)

    def _resolve(self, layer: int | None, kind: str, d_in: int,
                 lut_site: bool) -> tuple[Mode, LUTConfig]:
        cfg = None
        if lut_site and self.mode != Mode.DENSE:
            cfg = self.plan.lut_config(layer, kind, d_in, self.arch.n_layers)
        if cfg is None:
            return Mode.DENSE, self.plan.default.lut_config(d_in)
        return self.mode, cfg

    def site(self, d_in: int, d_out: int, kind: str, *, layer: int | None = None,
             lut_site: bool = True) -> SiteCfg:
        mode, cfg = self._resolve(layer, kind, d_in, lut_site)
        return SiteCfg(d_in=d_in, d_out=d_out, mode=mode, lut=cfg,
                       bias=self.arch.use_bias, name=kind)

    def expert_site(self, d_in: int, d_out: int, kind: str, *,
                    layer: int | None = None) -> moe_mod.ExpertSiteCfg:
        mode, cfg = self._resolve(layer, kind, d_in, lut_site=True)
        return moe_mod.ExpertSiteCfg(n_experts=self.arch.n_experts, d_in=d_in, d_out=d_out,
                                     mode=mode, lut=cfg)


def _attn_cfg(res: _PlanResolver, *, layer: int | None = None, causal: bool | None = None,
              cross: bool = False, prefix: str = "attn") -> attn_mod.AttnCfg:
    arch = res.arch
    d, h, kv, dh = arch.d_model, arch.n_heads, arch.n_kv_heads, arch.d_head
    return attn_mod.AttnCfg(
        d_model=d, n_heads=h, n_kv_heads=kv, d_head=dh,
        q=res.site(d, h * dh, f"{prefix}/q", layer=layer),
        k=res.site(d, kv * dh, f"{prefix}/k", layer=layer),
        v=res.site(d, kv * dh, f"{prefix}/v", layer=layer),
        o=res.site(h * dh, d, f"{prefix}/o", layer=layer),
        qk_norm=arch.qk_norm,
        rope_theta=arch.rope_theta,
        mrope_sections=arch.mrope_sections,
        causal=arch.causal if causal is None else causal,
        use_rope=not cross,
    )


def _mlp_cfg(res: _PlanResolver, *, layer: int | None = None,
             prefix: str = "mlp") -> mlp_mod.MLPCfg:
    arch = res.arch
    d, f = arch.d_model, arch.d_ff
    return mlp_mod.MLPCfg(
        d_model=d, d_ff=f,
        gate=res.site(d, f, f"{prefix}/gate", layer=layer),
        up=res.site(d, f, f"{prefix}/up", layer=layer),
        down=res.site(f, d, f"{prefix}/down", layer=layer),
        act=arch.act,
        gated=arch.mlp_gated,
    )


def _moe_cfg(res: _PlanResolver, *, layer: int | None = None) -> moe_mod.MoECfg:
    arch = res.arch
    d, f, e = arch.d_model, arch.d_ff, arch.n_experts
    return moe_mod.MoECfg(
        d_model=d, d_ff=f, n_experts=e, top_k=arch.top_k,
        # the router stays exact: approximate routing logits destabilize top-k
        router=res.site(d, e, "moe/router", layer=layer, lut_site=False),
        gate=res.expert_site(d, f, "moe/gate", layer=layer),
        up=res.expert_site(d, f, "moe/up", layer=layer),
        down=res.expert_site(f, d, "moe/down", layer=layer),
        shared=_mlp_cfg(res, layer=layer, prefix="moe/shared") if arch.moe_shared_expert else None,
        act=arch.act,
        group_tokens=arch.moe_group_tokens,
    )


def _mamba_block(res: _PlanResolver, *, layer: int | None = None) -> tf_mod.BlockCfg:
    arch = res.arch
    di = arch.d_inner
    h = di // arch.ssm_head_dim
    mcfg = mamba_mod.Mamba2Cfg(
        d_model=arch.d_model, d_inner=di, n_heads=h, head_dim=arch.ssm_head_dim,
        ssm_state=arch.ssm_state, n_groups=arch.ssm_groups,
        conv_width=arch.conv_width, chunk=arch.ssd_chunk,
        in_proj=res.site(arch.d_model, 2 * di + 2 * arch.ssm_groups * arch.ssm_state + h,
                         "mamba/in_proj", layer=layer),
        out_proj=res.site(di, arch.d_model, "mamba/out_proj", layer=layer),
    )
    return tf_mod.BlockCfg(kind="mamba", d_model=arch.d_model, mamba=mcfg)


def _block(res: _PlanResolver, *, layer: int | None = None) -> tf_mod.BlockCfg:
    arch = res.arch
    if arch.family == "ssm":
        return _mamba_block(res, layer=layer)
    if arch.family == "moe":
        return tf_mod.BlockCfg(
            kind="moe", d_model=arch.d_model, attn=_attn_cfg(res, layer=layer),
            moe=_moe_cfg(res, layer=layer),
            residual_mlp=(_mlp_cfg(res, layer=layer, prefix="residual_mlp")
                          if arch.moe_dense_residual else None),
        )
    return tf_mod.BlockCfg(kind="dense", d_model=arch.d_model,
                           attn=_attn_cfg(res, layer=layer), mlp=_mlp_cfg(res, layer=layer))


def _segments(res: _PlanResolver) -> tuple[tuple[int, tf_mod.BlockCfg], ...]:
    """Per-layer blocks grouped into runs of identical config."""
    n_layers = res.arch.n_layers
    if res.mode == Mode.DENSE:
        return ((n_layers, _block(res)),)
    segs: list[list[Any]] = []
    for j in range(n_layers):
        b = _block(res, layer=j)
        if segs and segs[-1][1] == b:
            segs[-1][0] += 1
        else:
            segs.append([1, b])
    return tuple((n, b) for n, b in segs)


def _mlp_site_list(m: mlp_mod.MLPCfg) -> list[tuple[str, Any, bool]]:
    return [(s.name, s, True) for s in ([m.gate] if m.gated else []) + [m.up, m.down]]


def _attn_site_list(a: attn_mod.AttnCfg) -> list[tuple[str, Any, bool]]:
    return [(s.name, s, True) for s in (a.q, a.k, a.v, a.o)]


def _block_site_list(bcfg: tf_mod.BlockCfg) -> list[tuple[str, Any, bool]]:
    """(rel path, site config, goes through common.linear) per site of a
    block; the rel path is the site kind and its param sub-tree path. MoE
    expert sites are expert-stacked and never taped."""
    if bcfg.kind == "mamba":
        m = bcfg.mamba
        out = [(m.in_proj.name, m.in_proj, True), (m.out_proj.name, m.out_proj, True)]
    elif bcfg.kind == "dense":
        out = _attn_site_list(bcfg.attn) + _mlp_site_list(bcfg.mlp)
    elif bcfg.kind == "moe":
        mo = bcfg.moe
        out = _attn_site_list(bcfg.attn) + [(mo.router.name, mo.router, True)]
        out += [("moe/gate", mo.gate, False), ("moe/up", mo.up, False),
                ("moe/down", mo.down, False)]
        if mo.shared is not None:
            out += _mlp_site_list(mo.shared)
    else:
        raise ValueError(bcfg.kind)
    if bcfg.residual_mlp is not None:
        out += _mlp_site_list(bcfg.residual_mlp)
    return out


def _site_spec(path: str, layer, stack_index, kind: str, sc, tape_key) -> SiteSpec:
    return SiteSpec(path=path, layer=layer, stack_index=stack_index, kind=kind,
                    d_in=sc.d_in, d_out=sc.d_out, bias=getattr(sc, "bias", False), mode=sc.mode,
                    lut=sc.lut, tape_key=tape_key)


def cache_leaves(tree):
    """(name, leaf) of every tensor or ParamSpec of a cache tree."""
    if isinstance(tree, dict):
        for name, v in tree.items():
            if isinstance(v, (dict, list)):
                yield from cache_leaves(v)
            else:
                yield name, v
    elif isinstance(tree, list):
        for v in tree:
            yield from cache_leaves(v)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    arch: ArchSpec
    mode: Mode
    kind: str                    # "lm" | "hybrid" | "encdec"
    cfg: Any

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.arch.param_dtype == "bfloat16" else torch.float32

    def init(self, generator: torch.Generator | None = None, *,
             device: str | torch.device | None = None):
        """Random params drawn from `generator` (seed 0 on the CPU when None)
        and placed on `device`, which defaults to the card."""
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        if self.kind == "hybrid":
            return hybrid_mod.hybrid_init(gen, self.cfg, dtype=self.param_dtype, device=device)
        if self.kind == "encdec":
            return encdec_mod.encdec_init(gen, self.cfg, dtype=self.param_dtype, device=device)
        return tf_mod.lm_init(gen, self.cfg, dtype=self.param_dtype, device=device)

    def param_specs(self) -> dict[str, Any]:
        """The reference's param tree of this bundle (segments, the hybrid's
        mamba stack, or the encoder and decoder, stacked over their layers),
        each leaf a ParamSpec(shape, dtype): what an artifact must hold,
        computed from the configs without allocating params."""
        if self.kind == "hybrid":
            return hybrid_mod.hybrid_param_specs(self.cfg, self.param_dtype)
        if self.kind == "encdec":
            return encdec_mod.encdec_param_specs(self.cfg, self.param_dtype)
        return tf_mod.lm_param_specs(self.cfg, self.param_dtype)

    def sites(self) -> list[SiteSpec]:
        """One SiteSpec per (site, layer), paths as in the reference registry.
        An enc-dec's encoder layers number 0..E-1 and its decoder's E..E+D-1,
        so that (layer, kind) is unique model-wide."""
        out: list[SiteSpec] = []
        if self.kind == "encdec":
            cfg = self.cfg
            for j in range(cfg.n_enc_layers):
                for rel, sc, taped in _block_site_list(cfg.enc_block):
                    out.append(_site_spec(f"encoder/{rel}", j, j, rel, sc,
                                          f"encoder/{j}/{rel}" if taped else None))
            dec = (_attn_site_list(cfg.dec_self) + _attn_site_list(cfg.dec_cross)
                   + _mlp_site_list(cfg.dec_mlp))
            for j in range(cfg.n_dec_layers):
                for rel, sc, taped in dec:
                    out.append(_site_spec(f"decoder/{rel}", cfg.n_enc_layers + j, j, rel, sc,
                                          f"decoder/{j}/{rel}" if taped else None))
            return out
        if self.kind == "hybrid":
            cfg = self.cfg
            rels = _block_site_list(cfg.mamba_block)
            for j in range(cfg.n_layers):
                for rel, sc, taped in rels:
                    out.append(_site_spec(f"mamba_stack/{rel}", j, j, rel, sc,
                                          f"mamba_stack/{j}/{rel}" if taped else None))
            shared = ([(cfg.fuse.name, cfg.fuse, True)] + _attn_site_list(cfg.shared_attn)
                      + _mlp_site_list(cfg.shared_mlp) + [(cfg.out.name, cfg.out, True)])
            for rel, sc, taped in shared:
                out.append(_site_spec(f"shared/{rel}", None, None, rel, sc,
                                      f"shared/{rel}" if taped else None))
            return out
        g = 0
        for i, (count, bcfg) in enumerate(self.cfg.segments):
            rels = _block_site_list(bcfg)
            for j in range(count):
                for rel, sc, taped in rels:
                    out.append(_site_spec(f"segments/{i}/{rel}", g + j, j, rel, sc,
                                          f"segments/{i}/{j}/{rel}" if taped else None))
            g += count
        if self.cfg.lm_head is not None:
            out.append(_site_spec("lm_head", None, None, "lm_head", self.cfg.lm_head, "lm_head"))
        return out

    def lut_sites(self) -> list[SiteSpec]:
        return [s for s in self.sites() if s.mode != Mode.DENSE]

    def train_logits(self, params, batch, *, compute_dtype=torch.bfloat16):
        """The training forward over whole sequences: (logits (B, S, vocab),
        aux). The shared forward of `loss` and of both halves of the
        distillation loss; aux is the MoE load-balance value of the lm family,
        0 elsewhere. An lm batch carries "tokens", or "embeds" (B, S, D) for a
        model that takes embeddings, and optionally "pos" ((3, B, S) under
        M-RoPE); without it the positions are 0..S-1 (in all three streams
        under M-RoPE). An enc-dec batch carries "frames" (B, enc_frames, D)
        beside the decoder's "tokens"."""
        b, s = batch["labels"].shape[:2]
        dev = batch["labels"].device
        pos = torch.arange(s, device=dev)[None, :].expand(b, s)
        if self.kind == "lm":
            if "pos" in batch:
                pos = batch["pos"]
            elif self.arch.mrope_sections:
                pos = pos[None].expand(3, b, s)
            logits, _, aux = tf_mod.lm_apply(self.cfg, params, tokens=batch.get("tokens"),
                                             embeds=batch.get("embeds"), pos=pos,
                                             compute_dtype=compute_dtype)
            return logits, aux
        if self.kind == "hybrid":
            logits, _ = hybrid_mod.hybrid_apply(self.cfg, params, tokens=batch["tokens"],
                                                pos=pos, compute_dtype=compute_dtype)
        else:
            enc_out = encdec_mod.encode(self.cfg, params, batch["frames"],
                                        compute_dtype=compute_dtype)
            logits, _ = encdec_mod.decode(self.cfg, params, tokens=batch["tokens"], pos=pos,
                                          enc_out=enc_out, compute_dtype=compute_dtype)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss_from_logits(self, logits, aux, labels):
        """Cross-entropy, plus the aux penalty for the lm family: the one
        place its weight is applied."""
        ce = cross_entropy(logits, labels)
        return ce + tf_mod.LM_AUX_WEIGHT * aux if self.kind == "lm" else ce

    def loss(self, params, batch, *, compute_dtype=torch.bfloat16):
        logits, aux = self.train_logits(params, batch, compute_dtype=compute_dtype)
        return self.loss_from_logits(logits, aux, batch["labels"])

    def cache_specs(self, b: int, s_max: int, *, dtype=torch.bfloat16,
                    paged: attn_mod.PagedSpec | None = None):
        """ParamSpecs of `init_caches`' tensors, without allocating them."""
        if self.kind == "hybrid":
            return hybrid_mod.hybrid_cache_specs(self.cfg, b, s_max, dtype, paged)
        if self.kind == "encdec":
            return encdec_mod.encdec_cache_specs(self.cfg, b, s_max, dtype, paged)
        return tf_mod.cache_specs(self.cfg, b, s_max, dtype, paged)

    def init_caches(self, b: int, s_max: int, *, dtype=torch.bfloat16,
                    device: str | torch.device | None = None,
                    paged: attn_mod.PagedSpec | None = None):
        """Zeroed caches. lm: one dict per segment, {"k", "v"} (L, B, S_max,
        KV, Dh), or with `paged` (an attention.PagedSpec) pools {"k_pool",
        "v_pool"} (L, n_pages, page_size, KV, Dh) shared by the whole batch;
        a mamba segment's {"conv", "ssm"} (L, B, ...) per row either way.
        hybrid: {"mamba": {"conv", "ssm"}, "attn": K/V or pools stacked over
        the shared block's invocations}. encdec: {"self": the decoder's K/V
        or pools, "cross": {"k", "v"} (L, B, enc_frames, KV, Dh) per row}."""
        if self.kind == "hybrid":
            return hybrid_mod.hybrid_caches(self.cfg, b, s_max, dtype, resolve_device(device),
                                            paged)
        if self.kind == "encdec":
            return encdec_mod.encdec_caches(self.cfg, b, s_max, dtype, resolve_device(device),
                                            paged)
        return tf_mod.init_caches(self.cfg, b, s_max, dtype, resolve_device(device), paged)

    def forward_step(self, params, batch, caches, *, compute_dtype=torch.float32, mesh=None):
        """One serving step (prefill if S > 1, decode if S == 1).

        batch: "tokens" (B, S) (or "embeds" (B, S, D) for a model that takes
        embeddings), "cache_len" (B,), and optionally "write_rows" (the batch
        rows whose dense cache and per-row state may change; all when absent)
        and "write_len" (B,) (each row's valid positions; all S when absent:
        a padded row's recurrent state stops at its last valid token). Paged
        caches take "block_tables" (B, P) and "write_len" instead (fresh
        positions at or past write_len land in the garbage page; rows with
        write_len 0 keep their state). An enc-dec step may carry "frames"
        (B, enc_frames, D): the encoder runs on the written rows' frames and
        their cross K/V are replaced. Under M-RoPE the position is broadcast
        to the three streams, as in the reference. Returns (logits for the
        new positions, caches), the caches updated in place. cache_len,
        write_rows, block_tables and write_len are read on the host: pass CPU
        tensors to keep the forward free of device-to-host waits. A tensor-
        parallel rank's bundle (`distributed.tensor_parallel.local_bundle`)
        runs its shard of the forward with its collectives on `mesh`; every
        rank must run the same forwards."""
        if mesh is not None:
            with sharded.bound(mesh):
                return self._forward_step(params, batch, caches, compute_dtype=compute_dtype)
        return self._forward_step(params, batch, caches, compute_dtype=compute_dtype)

    def _forward_step(self, params, batch, caches, *, compute_dtype):
        inp = batch["tokens"] if "tokens" in batch else batch["embeds"]
        dev = inp.device
        b, s = inp.shape[:2]
        leaves = {} if caches is None else dict(cache_leaves(
            caches["self"] if self.kind == "encdec" else caches))
        paged = "k_pool" in leaves
        # a model without attention (the ssm family) has nothing to page: an
        # engine's block tables pass through unread
        if paged != ("block_tables" in batch) and (paged or "k" in leaves):
            raise ValueError("block_tables go with paged caches, and only with them")
        wl = batch.get("write_len")
        wl = None if wl is None else wl.cpu().long()
        block_tables = write_index = None
        if paged:
            bt = batch["block_tables"].cpu().long()
            cl = batch["cache_len"].cpu().long()
            wl = torch.full((b,), s) if wl is None else wl
            flat = attn_mod.paged_write_flat(bt, cl, s, leaves["k_pool"].shape[2], wl)
            src = attn_mod.paged_write_sources(flat)
            # one host-to-device copy carries the cursors, tables and write indices
            packed = torch.cat([cl, bt.flatten(), flat.flatten()]
                               + ([] if src is None else [src])).to(dev)
            cache_len = packed[:b]
            block_tables = packed[b: b + bt.numel()].view(bt.shape)
            write_index = packed[b + bt.numel(): b + bt.numel() + flat.numel()].view(b, s)
            if src is not None:
                write_index = (write_index, packed[b + bt.numel() + flat.numel():])
            rows = torch.nonzero(wl).flatten()
        else:
            cache_len = batch["cache_len"].long().to(dev)
            rows = batch.get("write_rows")
            if rows is None and wl is not None:
                rows = torch.nonzero(wl).flatten()
            if "k" in leaves:
                write_index = attn_mod.cache_write_index(batch["cache_len"], rows, s,
                                                         leaves["k"].shape[2], dev)
        pos = cache_len[:, None] + torch.arange(s, device=dev)[None, :]
        kw = dict(pos=pos, caches=caches, cache_len=cache_len, compute_dtype=compute_dtype,
                  write_index=write_index, block_tables=block_tables)
        if self.kind == "encdec":
            if "frames" in batch:
                self._write_cross(params, batch["frames"], caches["cross"], rows,
                                  compute_dtype)
            return encdec_mod.decode(self.cfg, params, tokens=batch["tokens"], **kw)
        state = None
        if caches is not None and ("ssm" in leaves):
            state = tf_mod.StateRows(rows=None if rows is None else rows.to(dev).long(),
                                     valid=None if wl is None else wl.to(dev))
        if self.kind == "hybrid":
            return hybrid_mod.hybrid_apply(self.cfg, params, tokens=batch["tokens"], state=state,
                                           **kw)
        if self.arch.mrope_sections:
            kw["pos"] = pos[None].expand(3, b, s)
        logits, caches, _ = tf_mod.lm_apply(self.cfg, params, tokens=batch.get("tokens"),
                                            embeds=batch.get("embeds"), state=state, **kw)
        return logits, caches

    def _write_cross(self, params, frames: torch.Tensor, cross: dict,
                     rows: torch.Tensor | None, compute_dtype) -> None:
        """Encode the frames of `rows` (all when None) and write those rows'
        cross K/V in place: a row of another request keeps its own."""
        rows = torch.arange(frames.shape[0]) if rows is None else rows
        rows = rows.to(frames.device).long()
        enc_out = encdec_mod.encode(self.cfg, params, frames[rows], compute_dtype=compute_dtype)
        for name, kv in encdec_mod.cross_kv(self.cfg, params, enc_out).items():
            cross[name][:, rows] = kv.to(cross[name].dtype)


def build_model(arch: ArchSpec | str, mode: Mode | str = Mode.DENSE) -> ModelBundle:
    if isinstance(arch, str):
        arch = get_arch(arch)
    if isinstance(mode, str):
        mode = Mode(mode)
    res = _PlanResolver(arch, mode)
    d = arch.d_model
    if arch.family == "hybrid":
        # the mamba layers share one config and the attention block is one
        # weight-shared module: sites resolve per kind (layer=None)
        cfg = hybrid_mod.HybridCfg(
            vocab=arch.vocab, d_model=d, n_layers=arch.n_layers, attn_every=arch.attn_every,
            mamba_block=_mamba_block(res), shared_attn=_attn_cfg(res), shared_mlp=_mlp_cfg(res),
            fuse=res.site(2 * d, d, "fuse", lut_site=False), out=res.site(d, d, "out"),
        )
        return ModelBundle(arch=arch, mode=mode, kind="hybrid", cfg=cfg)
    if arch.family == "audio":
        # encoder and decoder layers each share one config: sites resolve per
        # kind (layer=None), as the reference's stacked layers do
        cfg = encdec_mod.EncDecCfg(
            vocab=arch.vocab, d_model=d, n_enc_layers=arch.n_enc_layers,
            n_dec_layers=arch.n_layers, enc_frames=arch.enc_frames,
            enc_block=tf_mod.BlockCfg(kind="dense", d_model=d,
                                      attn=_attn_cfg(res, causal=False), mlp=_mlp_cfg(res)),
            dec_self=_attn_cfg(res, causal=True, prefix="self"),
            dec_cross=_attn_cfg(res, causal=False, cross=True, prefix="cross"),
            dec_mlp=_mlp_cfg(res),
        )
        return ModelBundle(arch=arch, mode=mode, kind="encdec", cfg=cfg)
    cfg = tf_mod.LMCfg(
        vocab=arch.vocab, d_model=d, segments=_segments(res),
        lm_head=None if arch.tie_embeddings else res.site(d, arch.vocab, "lm_head",
                                                          lut_site=False),
        takes_embeds=arch.takes_embeds,
    )
    return ModelBundle(arch=arch, mode=mode, kind="lm", cfg=cfg)
