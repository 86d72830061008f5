"""Learning-rate schedules (paper Table 3: cosine annealing; BERT: constant).

Counterpart of `repro.optim.schedule`: each schedule maps the step (a 0-d
tensor) to a 0-d float32 learning rate, computed in float32 as the
reference computes it.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def cosine_with_warmup(base_lr: float, *, total_steps: int, warmup_steps: int = 0,
                       min_lr: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = torch.clamp_max(s / max(1.0, float(warmup_steps)), 1.0)
        prog = torch.clamp((s - warmup_steps) / max(1.0, float(total_steps - warmup_steps)),
                           0.0, 1.0)
        cos = min_lr + 0.5 * (base_lr - min_lr) * (1.0 + torch.cos(math.pi * prog))
        return warm * cos

    return fn


def constant(base_lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
