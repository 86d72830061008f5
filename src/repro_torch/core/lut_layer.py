"""Shapes of the deployed LUT params of one linear site.

Counterpart of `repro.core.lut_layer.deploy_param_specs`; the initializers
and converters of the training lifecycle come with the training port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.amm import LUTConfig


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype


def deploy_param_specs(d: int, m: int, cfg: LUTConfig, *,
                       bias: bool = False) -> dict[str, ParamSpec]:
    """Deployed params of a (d -> m) site. Kernel and int8_dot sites take the
    m-shared (1, 1, M) scale: it factors out of the codebook sum, so the
    lookup is exact int32 arithmetic dequantized once per output."""
    c = cfg.codebooks(d)
    if cfg.int8_dot or cfg.use_kernel:
        s_shape = (1, 1, m)
    elif cfg.per_column:
        s_shape = (c, 1, m)
    else:
        s_shape = (c, 1, 1)
    specs = {
        "centroids": ParamSpec((c, cfg.k, cfg.v), torch.float32),
        "table_q": ParamSpec((c, cfg.k, m), torch.int8),
        "table_scale": ParamSpec(s_shape, torch.float32),
    }
    if bias:
        specs["b"] = ParamSpec((m,), torch.float32)
    return specs
