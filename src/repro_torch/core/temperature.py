"""Learned softmax temperature (paper section 3.2), in PyTorch.

Counterpart of `repro.core.temperature`: t = exp(log_t) is kept positive by
its log-space parameter, initialized at t = 1 (log_t = 0), one scalar per
replaced layer, trained at its own learning rate (optim.SOFT_PQ_RULES).
"""

from __future__ import annotations

import math

import torch

TEMP_PARAM = "log_t"


def init_log_temperature(init_t: float = 1.0, *, device="cpu") -> torch.Tensor:
    return torch.tensor(math.log(init_t), dtype=torch.float32, device=device)


def temperature(log_t: torch.Tensor, *, min_t: float = 1e-4) -> torch.Tensor:
    """exp(log_t), floored for numeric safety as t -> 0 (the argmax limit)."""
    return torch.clamp_min(torch.exp(log_t.float()), min_t)
