"""Token sampling for the serving engine: greedy, temperature, top-k, top-p.

Counterpart of `repro.serving.sampling`: `SamplingParams` is the same
dataclass and `sample_tokens` the same batched function, one logits row per
slot. The draw reproduces JAX's bits exactly rather than substituting
torch.Generator bits, so a request samples the same tokens in the port as in
the reference: each token uses `fold_in(PRNGKey(seed), n)` and
`categorical(key, filtered_logits)`, keyed only on the request's seed and its
own token index. That is, as in jax 0.9.0 (`jax/_src/prng.py`,
`jax/_src/random.py`) with its default `jax_threefry_partitionable=True`:

  PRNGKey(seed)      key = (0, seed mod 2^32)                  (int32 seed)
  fold_in(key, n)    key' = threefry2x32(key, (0, n))
  random_bits(key)   b[i] = y0 ^ y1 with (y0, y1) = threefry2x32(key, (0, i))
  uniform            f = bitcast_f32(b >> 9 | 0x3F800000) - 1, max(tiny, f + tiny)
  gumbel ("low")     -log(-log(uniform))
  categorical        argmax(gumbel + logits), lowest index on a tie

The uint32 arithmetic runs in int64 with masks. The gumbel noise goes
through torch's fp32 `log`, which may differ from XLA's in the last ulp: a
drawn token can then differ only where two entries of gumbel + logit tie to
within that ulp.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy.

    temperature <= 0 selects greedy argmax (top_k/top_p are then ignored);
    top_k == 0 and top_p == 1.0 disable the respective filters.
    """

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


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of JAX, on int64 tensors holding
    uint32 values; key and counts broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_keys(seeds: torch.Tensor) -> torch.Tensor:
    """(B,) int32 seeds -> (B, 2) keys, as `jax.random.PRNGKey` of each."""
    lo = seeds.to(torch.int64) & _MASK
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(B, 2) keys, (B,) integers -> (B, 2): `jax.random.fold_in` of each."""
    d = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2) keys -> (B, n) uint32 values in int64: `jax.random.bits(key, (n,))`."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return y0 ^ y1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2) keys -> (B, n) float32 `jax.random.gumbel` samples (mode "low")."""
    mant = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(floats * 1.0 + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def decision_values(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                    top_ps: torch.Tensor, seeds: torch.Tensor,
                    counters: torch.Tensor) -> torch.Tensor:
    """(B, V) float32 values whose row argmax is `sample_tokens`' token: the
    raw logits of a greedy row (temperature <= 0), the Gumbel noise plus the
    filtered scaled logits of a sampled one. Per-row parameters are (B,)
    tensors on the logits' device. A row's top-2 gap says how near its draw
    sits to a tie."""
    b, v = logits.shape
    logits = logits.float()
    greedy = temps <= 0.0

    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values

    # top-k: mask everything strictly below the k-th largest value (ties at
    # the threshold survive)
    k_eff = torch.where(top_ks > 0, top_ks.clamp(1, v), torch.full_like(top_ks, v))
    kth = sorted_desc.gather(-1, (k_eff - 1).long()[:, None])
    filtered = torch.where(scaled < kth, -torch.inf, scaled)

    # top-p: keep the smallest sorted prefix whose mass reaches top_p; "mass
    # before this token < p" always keeps the top-1 token
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs_desc = e / e.sum(dim=-1, keepdim=True)
    mass_before = torch.cumsum(probs_desc, dim=-1) - probs_desc
    n_keep = (mass_before < top_ps[:, None]).sum(dim=-1)
    cutoff = sorted_desc.gather(-1, (n_keep - 1)[:, None])
    filtered = torch.where(scaled < cutoff, -torch.inf, filtered)

    keys = fold_in(prng_keys(seeds), counters)
    return torch.where(greedy[:, None], logits, gumbel(keys, v) + filtered)


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: torch.Tensor, seeds: torch.Tensor,
                  counters: torch.Tensor) -> torch.Tensor:
    """One token per row of (B, V) logits; per-row parameters as (B,) tensors
    on the logits' device. Greedy rows (temperature <= 0) take argmax of the
    raw logits, so a greedy request through the sampler equals argmax."""
    return torch.argmax(decision_values(logits, temps, top_ks, top_ps, seeds, counters),
                        dim=-1).to(torch.int32)


def batch_arrays(params: list[SamplingParams], counters: list[int],
                 device: torch.device | str = "cpu") -> tuple[torch.Tensor, ...]:
    """Pack per-slot SamplingParams into the tensors `sample_tokens` takes."""
    return (
        torch.tensor([p.temperature for p in params], dtype=torch.float32, device=device),
        torch.tensor([p.top_k for p in params], dtype=torch.int32, device=device),
        torch.tensor([p.top_p for p in params], dtype=torch.float32, device=device),
        torch.tensor([p.seed for p in params], dtype=torch.int32, device=device),
        torch.tensor(counters, dtype=torch.int32, device=device),
    )
