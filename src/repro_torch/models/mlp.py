"""Gated-linear-unit FFN (SwiGLU family); gate/up/down are LUT sites.

Counterpart of `repro.models.mlp`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import sharded
from repro_torch.models.common import (
    Params,
    SiteCfg,
    activation,
    linear,
    linear_init,
    linear_specs,
)


@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    gate: SiteCfg
    up: SiteCfg
    down: SiteCfg
    act: str = "silu"
    gated: bool = True


def mlp_init(gen: torch.Generator, cfg: MLPCfg, *, dtype=torch.float32, device="cpu") -> Params:
    p: Params = {}
    if cfg.gated:
        p["gate"] = linear_init(gen, cfg.gate, dtype=dtype, device=device)
    p["up"] = linear_init(gen, cfg.up, dtype=dtype, device=device)
    p["down"] = linear_init(gen, cfg.down, dtype=dtype, device=device)
    return p


def mlp_specs(cfg: MLPCfg, dtype=torch.float32) -> Params:
    """ParamSpecs of `mlp_init`'s params."""
    p: Params = {"gate": linear_specs(cfg.gate, dtype)} if cfg.gated else {}
    p["up"] = linear_specs(cfg.up, dtype)
    p["down"] = linear_specs(cfg.down, dtype)
    return p


def mlp(cfg: MLPCfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.up.tp is not None:             # a tensor-parallel rank's gate/up: one copy
        x = sharded.copy(x)
    up = linear(cfg.up, p["up"], x)
    if cfg.gated:
        h = activation(cfg.act, linear(cfg.gate, p["gate"], x)) * up
    else:
        h = activation(cfg.act, up)
    return linear(cfg.down, p["down"], h)
