"""Token sampling for the serving engine: the greedy path.

Counterpart of `repro.serving.sampling`. `SamplingParams` is the same
dataclass. Sampling at temperature > 0 is not ported: the reference draws
with JAX's threefry `fold_in(PRNGKey(seed), n)` and `categorical`
(`repro/serving/sampling.py:89-94`), and substituting torch.Generator bits
would break replay parity with it (ROADMAP Queue C). The engine refuses such
requests at submit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy; temperature <= 0 is greedy argmax."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not -(2**31) <= self.seed < 2**31:
            object.__setattr__(self, "seed", self.seed & 0x7FFFFFFF)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()

