"""AdamW with path-based parameter groups, as a plain function over the
port's param trees.

Counterpart of `repro.optim.adamw`, with its update order. Soft-PQ training
has three groups (paper Table 3):
  * centroids      the centroid learning rate
  * log_t          the temperature learning rate (100x), no weight decay
  * frozen weights the dense weight of a replaced site: no optimizer state
                   (an empty (0,) tensor stands for its moments, as in the
                   reference) and no update

Rules match a regex over a leaf's path in the reference's stacked tree
(`weights.tree_map_ref`: "segments/1/attn/q/log_t", "embed/table"), so
`log_t$` and `(embed|lm_head)` select the same leaves in both packages.
Frozen-ness is structural: a "w"/"b" leaf is frozen iff its dict also holds
"centroids".
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.checkpoint.paths import register_node
from repro_torch.weights import tree_map_ref


@dataclasses.dataclass(frozen=True)
class GroupRule:
    """First matching rule wins. `pattern` is a regex over the 'a/b/c' path."""

    pattern: str
    lr_scale: float = 1.0
    weight_decay: float | None = None       # None -> the optimizer's default


# paper Table 3: temperature lr 1e-1 against centroid lr 1e-3 (100x), no
# weight decay on the temperature and the norm scales
SOFT_PQ_RULES = (
    GroupRule(pattern=r"log_t$", lr_scale=100.0, weight_decay=0.0),
    GroupRule(pattern=r"(scale|norm|bias|_b|/b)$", weight_decay=0.0),
)

# distillation fine-tune: the embedding and the output head move at 0.1x,
# so the student's logit scale does not drift from the teacher's
DISTILL_RULES = SOFT_PQ_RULES + (
    GroupRule(pattern=r"(embed|lm_head)", lr_scale=0.1, weight_decay=0.0),
)


def lut_frozen_mask(params: Any) -> Any:
    """True for the dense weights that live beside centroids (LUT_TRAIN)."""

    def walk(node, frozen: bool):
        if isinstance(node, dict):
            has_c = "centroids" in node
            return {k: walk(v, frozen or (has_c and k in ("w", "b"))) for k, v in node.items()}
        if type(node) in (list, tuple):           # a ParamSpec (NamedTuple) is a leaf
            return [walk(v, frozen) for v in node]
        return frozen

    return walk(params, False)


@register_node
class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32 on the host
    m: Any
    v: Any


def no_frozen(params: Any) -> Any:
    """A frozen mask of `params` with nothing frozen."""
    return tree_map_ref(lambda _p, _leaf: False, params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    rules: tuple[GroupRule, ...] = ()
    clip_norm: float | None = 1.0
    state_dtype: torch.dtype = torch.float32

    def _rule(self, path: str) -> GroupRule:
        for r in self.rules:
            if re.search(r.pattern, path):
                return r
        return GroupRule(pattern="")

    def init(self, params: Any, frozen: Any | None = None) -> AdamWState:
        frozen = no_frozen(params) if frozen is None else frozen

        def mk(_path, p, fz):
            if fz:
                return torch.zeros((0,), dtype=self.state_dtype, device=p.device)
            return torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map_ref(mk, params, frozen), v=tree_map_ref(mk, params, frozen))

    @torch.no_grad()
    def global_norm(self, grads: Any, frozen: Any | None = None) -> torch.Tensor:
        """The L2 norm of every non-frozen gradient leaf together (fp32)."""
        frozen = no_frozen(grads) if frozen is None else frozen
        sq: list[torch.Tensor] = []
        tree_map_ref(lambda _p, g, fz: None if fz else sq.append((g.float() ** 2).sum()),
                     grads, frozen)
        total = sq[0]
        for t in sq[1:]:
            total = total + t
        return torch.sqrt(total)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any, frozen: Any | None = None, *,
               gnorm: torch.Tensor | None = None):
        """(grads, state, params) -> (new params, new state, global grad norm).
        Functional: no input is changed in place. `grads` holds None at
        frozen leaves. Every leaf's update is elementwise, so the leaves may
        be any matching parts of the params, their gradients and moments (a
        data rank's ZeRO-1 shards, `distributed/data_parallel.py`), with
        `gnorm` the global norm of the whole gradients, computed outside."""
        frozen = no_frozen(params) if frozen is None else frozen
        step = state.step + 1
        stepf = step.float()
        lr_t = self.lr(step) if callable(self.lr) else torch.tensor(self.lr, dtype=torch.float32)

        if self.clip_norm is not None:
            if gnorm is None:
                gnorm = self.global_norm(grads, frozen)
            scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
        else:
            gnorm = torch.zeros((), dtype=torch.float32)
            scale = torch.ones((), dtype=torch.float32)

        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** stepf
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** stepf

        def upd(path, p, g, m, v, fz):
            if fz:
                return p, m, v
            rule = self._rule(path)
            g32 = g.float() * scale
            m_new = self.b1 * m.float() + (1 - self.b1) * g32
            v_new = self.b2 * v.float() + (1 - self.b2) * g32 * g32
            mh = m_new / bc1.to(p.device)
            vh = v_new / bc2.to(p.device)
            wd = self.weight_decay if rule.weight_decay is None else rule.weight_decay
            delta = mh / (torch.sqrt(vh) + self.eps) + wd * p.float()
            p_new = p.float() - (lr_t * rule.lr_scale).to(p.device) * delta
            return (p_new.to(p.dtype), m_new.to(self.state_dtype), v_new.to(self.state_dtype))

        out = tree_map_ref(upd, params, grads, state.m, state.v, frozen)
        pick = lambda i: tree_map_ref(lambda _p, _leaf, t: t[i], params, out)   # noqa: E731
        return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), gnorm
