"""LUTPlan: first-class per-site replacement policy (DESIGN.md §9).

A copy of `repro.core.plan` (pure Python) bound to the port's `amm`; the
port imports nothing of `repro`, so it keeps its own.

The paper's accuracy story is *per-layer* (Fig. 13 sweeps how many layers
are replaced; §6.1 tunes centroid counts per operator), so the replacement
policy is a structured plan rather than a parsed string:

  * `SitePolicy`   — a partial override of the LUT hyper-parameters
                     (k, v, bits, per_column, int8_dot, use_kernel); `None`
                     fields inherit from the plan default.
  * `SiteSelector` — which sites a rule applies to: a layer range
                     ("all" / "all_but_first" / "last_n" / an explicit
                     "set" of indices) crossed with fnmatch patterns over
                     site *kinds* ("mlp/*", "attn/q", "moe/down", ...).
  * `PlanRule`     — selector + replace/keep-dense decision + policy.
  * `LUTPlan`      — an ordered rule cascade over a fully-populated default
                     policy. Rules apply in order; the LAST matching rule
                     decides replacement, and matching rules' policy fields
                     accumulate (later rules override earlier ones).

`LUTPlan.from_policy_string` is the back-compat shim for the old
`ArchSpec.lut_policy` strings ("all", "all_but_first", "last_n:<n>") — it
produces a single-rule plan whose default policy carries the old flat
`lut_*` flags, so pre-plan configs and v1 artifacts build identical models.

Layer selectors only constrain sites that *have* a layer index. Sites whose
weights are shared across layers (the hybrid model's shared attention
block) or stacked uniformly with one config (hybrid mamba stack, enc-dec
blocks) resolve with `layer=None` and match every layer selector — exactly
the pre-plan behavior where those families ignored the policy string. Kind
patterns always apply.

`SiteSpec` is the site-registry record: `ModelBundle.sites()`
(repro_torch.configs) enumerates one per linear site per layer across all model
families, and conversion / sharding / autotune-warmup / artifact snapshots
walk it instead of doing per-family path-string surgery.
"""

from __future__ import annotations

import dataclasses
from fnmatch import fnmatchcase
from typing import Any

from repro_torch.core.amm import LUTConfig, Mode

_LAYER_SELECTORS = ("all", "all_but_first", "last_n", "set")

# the per-site hyper-parameter fields a policy can override
_POLICY_FIELDS = ("k", "v", "bits", "per_column", "int8_dot", "use_kernel")


@dataclasses.dataclass(frozen=True)
class SitePolicy:
    """Partial LUT hyper-parameter override; None fields inherit."""

    k: int | None = None
    v: int | None = None
    bits: int | None = None
    per_column: bool | None = None
    int8_dot: bool | None = None
    use_kernel: bool | None = None

    def merged_over(self, base: "SitePolicy") -> "SitePolicy":
        """self's non-None fields override base's."""
        return SitePolicy(**{
            f: getattr(self, f) if getattr(self, f) is not None else getattr(base, f)
            for f in _POLICY_FIELDS
        })

    @property
    def complete(self) -> bool:
        return all(getattr(self, f) is not None for f in _POLICY_FIELDS)

    def lut_config(self, d_in: int) -> LUTConfig:
        """Concrete per-site LUTConfig; V is halved until it divides d_in
        (same alignment rule the flat-flag path always applied)."""
        if not self.complete:
            raise ValueError(f"policy {self} not fully resolved — merge over a "
                             f"complete default first")
        v = self.v
        while d_in % v:
            v //= 2
        return LUTConfig(k=self.k, v=v, bits=self.bits, per_column=self.per_column,
                         int8_dot=self.int8_dot, use_kernel=self.use_kernel)


#: the paper's defaults (K=16, V=32, INT8) — the base of every plan cascade
PAPER_DEFAULT = SitePolicy(k=16, v=32, bits=8, per_column=False,
                           int8_dot=False, use_kernel=False)


@dataclasses.dataclass(frozen=True)
class SiteSelector:
    """Which (layer, kind) sites a rule applies to."""

    layers: str = "all"                  # one of _LAYER_SELECTORS
    n: int = 0                           # for "last_n"
    layer_set: tuple[int, ...] = ()      # for "set"
    kinds: tuple[str, ...] = ("*",)      # fnmatch patterns over site kind

    def selects(self, layer: int | None, kind: str, n_layers: int) -> bool:
        if not any(fnmatchcase(kind, pat) for pat in self.kinds):
            return False
        if layer is None:
            # weight-shared / uniformly-stacked site: layer selectors are
            # inapplicable and match (kind patterns still constrain)
            return True
        if self.layers == "all":
            return True
        if self.layers == "all_but_first":
            return layer >= 1
        if self.layers == "last_n":
            return layer >= n_layers - self.n
        if self.layers == "set":
            return layer in self.layer_set
        raise ValueError(f"unknown layer selector {self.layers!r}")

    def validate(self, n_layers: int) -> None:
        if self.layers not in _LAYER_SELECTORS:
            raise ValueError(
                f"unknown layer selector {self.layers!r} — "
                f"expected one of {_LAYER_SELECTORS}"
            )
        if self.layers == "last_n" and not 0 <= self.n <= n_layers:
            raise ValueError(
                f"last_n selects the final {self.n} layers but the model has "
                f"only {n_layers} — pick n in [0, {n_layers}] (n={n_layers} "
                f"replaces every layer; the paper keeps at least the first "
                f"layer dense)"
            )
        if self.layers == "set":
            bad = [i for i in self.layer_set if not 0 <= i < n_layers]
            if bad:
                raise ValueError(
                    f"layer set {self.layer_set} references layers {bad} "
                    f"outside the model's range [0, {n_layers})"
                )
        if not self.kinds:
            raise ValueError("selector needs at least one kind pattern "
                             "(use ('*',) for all kinds)")


@dataclasses.dataclass(frozen=True)
class PlanRule:
    select: SiteSelector = SiteSelector()
    replace: bool = True                 # False: force the site dense
    policy: SitePolicy = SitePolicy()


def rule(
    *,
    layers: str = "all",
    n: int = 0,
    layer_set: tuple[int, ...] | list[int] = (),
    kinds: tuple[str, ...] | list[str] = ("*",),
    replace: bool = True,
    **policy: Any,
) -> PlanRule:
    """Convenience PlanRule constructor: selector fields + policy kwargs."""
    bad = sorted(set(policy) - set(_POLICY_FIELDS))
    if bad:
        raise TypeError(f"unknown policy fields {bad} — valid: {_POLICY_FIELDS}")
    return PlanRule(
        select=SiteSelector(layers=layers, n=n, layer_set=tuple(layer_set),
                            kinds=tuple(kinds)),
        replace=replace,
        policy=SitePolicy(**policy),
    )


@dataclasses.dataclass(frozen=True)
class LUTPlan:
    """Ordered rule cascade resolving every site to dense or a LUTConfig."""

    rules: tuple[PlanRule, ...] = ()
    default: SitePolicy = PAPER_DEFAULT

    # ---------------- constructors ----------------
    @classmethod
    def all(cls, **policy: Any) -> "LUTPlan":
        return cls(rules=(rule(),), default=SitePolicy(**policy).merged_over(PAPER_DEFAULT))

    @classmethod
    def all_but_first(cls, **policy: Any) -> "LUTPlan":
        return cls(rules=(rule(layers="all_but_first"),),
                   default=SitePolicy(**policy).merged_over(PAPER_DEFAULT))

    @classmethod
    def last_n(cls, n: int, **policy: Any) -> "LUTPlan":
        return cls(rules=(rule(layers="last_n", n=n),),
                   default=SitePolicy(**policy).merged_over(PAPER_DEFAULT))

    @classmethod
    def none(cls, **policy: Any) -> "LUTPlan":
        """No replacement anywhere (dense model regardless of mode)."""
        return cls(rules=(), default=SitePolicy(**policy).merged_over(PAPER_DEFAULT))

    @classmethod
    def from_policy_string(
        cls, policy: str, default: SitePolicy = PAPER_DEFAULT
    ) -> "LUTPlan":
        """Back-compat shim for the old `ArchSpec.lut_policy` strings."""
        if not default.complete:
            default = default.merged_over(PAPER_DEFAULT)
        if policy == "all":
            sel = SiteSelector(layers="all")
        elif policy == "all_but_first":
            sel = SiteSelector(layers="all_but_first")
        elif policy.startswith("last_n:"):
            try:
                n = int(policy.split(":", 1)[1])
            except ValueError:
                raise ValueError(f"malformed lut_policy {policy!r} — "
                                 f"expected last_n:<int>") from None
            sel = SiteSelector(layers="last_n", n=n)
        else:
            raise ValueError(
                f"unknown lut_policy {policy!r} — expected 'all', "
                f"'all_but_first', 'last_n:<n>', or set ArchSpec.lut_plan"
            )
        return cls(rules=(PlanRule(select=sel),), default=default)

    # ---------------- resolution ----------------
    def resolve(self, layer: int | None, kind: str, n_layers: int) -> SitePolicy | None:
        """None = the site stays dense; else the fully-merged policy."""
        pol = self.default
        replaced = False
        for r in self.rules:
            if r.select.selects(layer, kind, n_layers):
                replaced = r.replace
                pol = r.policy.merged_over(pol)
        return pol if replaced else None

    def replaces(self, layer: int | None, kind: str, n_layers: int) -> bool:
        return self.resolve(layer, kind, n_layers) is not None

    def lut_config(
        self, layer: int | None, kind: str, d_in: int, n_layers: int
    ) -> LUTConfig | None:
        pol = self.resolve(layer, kind, n_layers)
        return None if pol is None else pol.lut_config(d_in)

    def validate(self, n_layers: int) -> "LUTPlan":
        if not self.default.complete:
            raise ValueError(f"plan default {self.default} must be fully "
                             f"populated (merge over plan.PAPER_DEFAULT)")
        for r in self.rules:
            r.select.validate(n_layers)
        return self

    def keeping_dense(self, *kinds: str) -> "LUTPlan":
        """This plan plus a final keep-dense rule over `kinds` (fnmatch
        patterns) — the mechanical way to derive a higher-fidelity SUB-plan
        from a trained plan. Every site the result replaces, self also
        replaces, so both deploy from one LUT_TRAIN checkpoint and share
        their tables byte-for-byte (the spec-decode target/draft pairing,
        DESIGN.md §14.1)."""
        if not kinds:
            raise ValueError("keeping_dense needs at least one kind pattern")
        return dataclasses.replace(
            self,
            rules=self.rules + (PlanRule(
                select=SiteSelector(kinds=tuple(kinds)), replace=False,
            ),),
        )

    def describe(self) -> str:
        """One-line human summary (launch logs / benchmark rows)."""
        if not self.rules:
            return "dense (no replacement)"
        parts = []
        for r in self.rules:
            s = r.select
            where = {"all": "all", "all_but_first": "all_but_first",
                     "last_n": f"last_{s.n}", "set": f"layers{list(s.layer_set)}"}[s.layers]
            if s.kinds != ("*",):
                where += f" kinds={list(s.kinds)}"
            ov = {f: getattr(r.policy, f) for f in _POLICY_FIELDS
                  if getattr(r.policy, f) is not None}
            parts.append(f"{'lut' if r.replace else 'dense'}@{where}"
                         + (f"{ov}" if ov else ""))
        d = self.default
        return f"[{'; '.join(parts)}] default K={d.k} V={d.v} b{d.bits}"

    # ---------------- serialization ----------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "version": 1,
            "default": {f: getattr(self.default, f) for f in _POLICY_FIELDS},
            "rules": [
                {
                    "layers": r.select.layers,
                    "n": r.select.n,
                    "layer_set": list(r.select.layer_set),
                    "kinds": list(r.select.kinds),
                    "replace": r.replace,
                    "policy": {f: getattr(r.policy, f) for f in _POLICY_FIELDS
                               if getattr(r.policy, f) is not None},
                }
                for r in self.rules
            ],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LUTPlan":
        if d.get("version") != 1:
            raise ValueError(f"unsupported LUTPlan dict version {d.get('version')!r}")
        rules = tuple(
            PlanRule(
                select=SiteSelector(
                    layers=r.get("layers", "all"),
                    n=int(r.get("n", 0)),
                    layer_set=tuple(r.get("layer_set", ())),
                    kinds=tuple(r.get("kinds", ("*",))),
                ),
                replace=bool(r.get("replace", True)),
                policy=SitePolicy(**r.get("policy", {})),
            )
            for r in d.get("rules", ())
        )
        return cls(rules=rules, default=SitePolicy(**d.get("default", {})))


# ---------------------------------------------------------------------------
# site registry record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One linear site of a built model, as enumerated by ModelBundle.sites().

    path        param-tree prefix of the site's param dict
                (e.g. "segments/1/attn/q", "shared/out", "lm_head")
    layer       global layer index, or None for weight-shared sites
                (enc-dec models number encoder layers first, then decoder)
    stack_index index into the leading layer-stacked dim of the site's
                leaves, or None when the site's leaves are unstacked
    kind        plan-facing site kind ("attn/q", "mlp/down", "moe/gate",
                "self/q", "mamba/in_proj", "lm_head", ...)
    d_in/d_out  logical matmul dims of the site
    bias        whether the site carries a bias leaf
    mode        resolved Mode of the site in this bundle
    lut         the site's LUTConfig — always populated: dense-resolved and
                never-LUT sites (router, fuse, lm_head) carry the plan's
                default config as metadata, so filter LUT sites on `mode`,
                not on `lut`
    tape_key    activation-capture record key `tape_capture` sees for this
                site under an unrolled forward, or None for sites that do
                not pass through `models.common.linear` (MoE expert sites)
    """

    path: str
    layer: int | None
    stack_index: int | None
    kind: str
    d_in: int
    d_out: int
    bias: bool
    mode: Mode
    lut: LUTConfig | None
    tape_key: str | None
