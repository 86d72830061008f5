from repro_torch.optim.adamw import (
    DISTILL_RULES,
    SOFT_PQ_RULES,
    AdamW,
    AdamWState,
    GroupRule,
    lut_frozen_mask,
    no_frozen,
)
from repro_torch.optim.schedule import constant, cosine_with_warmup

__all__ = [
    "AdamW",
    "AdamWState",
    "GroupRule",
    "DISTILL_RULES",
    "SOFT_PQ_RULES",
    "lut_frozen_mask",
    "no_frozen",
    "cosine_with_warmup",
    "constant",
]
