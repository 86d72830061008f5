"""Deterministic synthetic data: `MarkovLM`, `ClusteredTask`, `host_shard`.

Counterpart of `repro.data.synthetic`. `MarkovLM` gives the reference's
batches bit for bit: token streams walk a random sparse Markov chain (a real
next-token task whose loss can drop well below the uniform entropy).
`ClusteredTask` is the paper's small-task data: mixture-of-Gaussians
features pushed through a frozen random teacher MLP (labels, or a scalar
target), so features cluster the way PQ assumes. Every batch is keyed by
(seed, step), so a resumed run replays its data from the step counter alone.

The reference draws with JAX's threefry PRNG; this module reproduces the
draws it uses on the port's threefry (`serving.sampling`), as in jax 0.9.0
with `jax_threefry_partitionable=True`:

  PRNGKey(seed)          (0, seed mod 2^32)
  split(key, n)[i]       threefry2x32(key, (0, i))
  bits(key, shape)[i]    y0 ^ y1 of threefry2x32(key, (0, i)), i the flat index
  randint(key, shape, lo, hi)
                         k1, k2 = split(key); h, l = bits(k1), bits(k2);
                         span = hi - lo, mult = (2^16 mod span)^2 mod span in
                         uint32; lo + ((h mod span) * mult + l mod span) mod span
  uniform(key, shape, lo, hi)
                         f = bitcast_f32(bits >> 9 | 0x3F800000) - 1;
                         max(lo, f * (hi - lo) + lo)
  normal(key, shape)     sqrt(2) * erf_inv(uniform(key, shape, -1 + 2^-24, 1)),
                         erf_inv as XLA computes it in float32 (Giles'
                         polynomial in w = -log1p(-u^2), each step a fused
                         multiply-add)

The integer draws and the uniform bits are the reference's bytewise. A
normal is too for about 99 in 100 draws on the CPU; the rest differ where
torch's float32 `log1p` and XLA's differ in their last bit, and lie within 3
float32 ulp of the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import fma_f32
from repro_torch.serving.sampling import fold_in, prng_keys, random_bits

_MASK = 0xFFFFFFFF


def prng_key(seed: int) -> torch.Tensor:
    """(2,) int64 key holding uint32 words: `jax.random.PRNGKey(seed)`."""
    return prng_keys(torch.tensor([seed]))[0]


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """(2,) key -> (n, 2) keys: `jax.random.split(key, n)`."""
    return fold_in(key[None, :].expand(n, 2), torch.arange(n))


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int) -> torch.Tensor:
    """int32 draws in [minval, maxval): `jax.random.randint(key, shape, minval,
    maxval)` for 0 <= minval < maxval < 2^31."""
    k1, k2 = split(key)
    n = 1
    for d in shape:
        n *= d
    hi = random_bits(k1[None, :], n)[0]
    lo = random_bits(k2[None, :], n)[0]
    span = maxval - minval
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(torch.int32).reshape(shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0, *, device: str | torch.device = "cpu") -> torch.Tensor:
    """float32 draws in [minval, maxval): `jax.random.uniform(key, shape,
    float32, minval, maxval)`, computed on `device`."""
    n = 1
    for d in shape:
        n *= d
    bits = random_bits(key.to(device)[None, :], n)[0]
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo).reshape(shape)


# Giles' erf_inv coefficients as XLA's float32 erf_inv holds them (w < 5, w >= 5)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it (not torch.erfinv,
    which differs from it by up to ~90 ulp in the tails)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i: int) -> torch.Tensor:
        return torch.where(small, torch.tensor(_ERFINV_SMALL[i], dtype=torch.float32),
                           torch.tensor(_ERFINV_LARGE[i], dtype=torch.float32)).to(x.device)

    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = fma_f32(p, w, coef(i))
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, p * x)


def normal(key: torch.Tensor, shape: tuple[int, ...], *,
           device: str | torch.device = "cpu") -> torch.Tensor:
    """float32 standard normals: `jax.random.normal(key, shape)` (see the
    module docstring for how close), computed on `device`."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device)
    return torch.tensor(2.0 ** 0.5, dtype=torch.float32, device=device) * erf_inv(u)


@functools.lru_cache(maxsize=4)
def _transitions(seed: int, vocab: int, branching: int) -> torch.Tensor:
    return randint(prng_key(seed), (vocab, branching), 0, vocab).long()


@dataclasses.dataclass(frozen=True)
class MarkovLM:
    """Batches {"tokens", "labels"} of int32 (batch, seq_len) CPU tensors. Its
    repr is the reference's dataclass repr, which the recipe's run manifest
    fingerprints."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 8          # successors per token: lower = more learnable

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        succ = _transitions(self.seed, self.vocab, self.branching)
        key = fold_in(prng_key(self.seed + 1)[None, :], torch.tensor([step]))[0]
        k0, k1 = split(key)
        tok = randint(k0, (self.batch,), 0, self.vocab).long()
        choice = randint(k1, (self.batch, self.seq_len), 0, self.branching).long()
        start = tok
        seq = []
        for t in range(self.seq_len):
            tok = succ[tok, choice[:, t]]
            seq.append(tok)
        seq = torch.stack(seq, dim=1)                                 # (B, S)
        tokens = torch.cat([start[:, None], seq[:, :-1]], dim=1)
        return {"tokens": tokens.to(torch.int32), "labels": seq.to(torch.int32)}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class ClusteredTask:
    """Mixture-of-Gaussians features -> frozen teacher MLP -> labels (or a
    scalar target with `regression`): `repro.data.synthetic.ClusteredTask`'s
    draws, on the port's threefry."""

    d_in: int = 64
    n_classes: int = 10
    n_clusters: int = 40
    cluster_std: float = 0.35
    teacher_width: int = 128
    seed: int = 0
    regression: bool = False

    def _teacher(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        k1, k2, k3, _ = split(prng_key(self.seed), 4)
        centers = normal(k1, (self.n_clusters, self.d_in), device=device)
        w1 = normal(k2, (self.d_in, self.teacher_width), device=device) / self.d_in ** 0.5
        out_dim = 1 if self.regression else self.n_classes
        w2 = normal(k3, (self.teacher_width, out_dim), device=device) / self.teacher_width ** 0.5
        return centers, w1, w2

    def sample(self, step: int, batch: int, *,
               device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
        """{"x": (batch, d_in) float32, "y": int32 labels (batch,) or float32
        targets} of step `step`, on `device` (the card unless the caller
        asks for the CPU)."""
        device = resolve_device(device)
        centers, w1, w2 = self._teacher(device)
        key = fold_in(prng_key(self.seed + 7)[None, :], torch.tensor([step]))[0]
        kc, kn = split(key)
        cid = randint(kc, (batch,), 0, self.n_clusters).long().to(device)
        x = centers[cid] + self.cluster_std * normal(kn, (batch, self.d_in), device=device)
        h = torch.tanh(x @ w1) @ w2
        if self.regression:
            return {"x": x, "y": h[:, 0]}
        return {"x": x, "y": torch.argmax(h, dim=-1).to(torch.int32)}


def host_shard(batch: dict, process_index: int, process_count: int) -> dict:
    """This process's rows of a global batch (a dict of tensors, nested
    dicts too): each leading axis cut into `process_count` equal parts, a
    0-d leaf kept whole."""
    def cut(a):
        if isinstance(a, dict):
            return {k: cut(v) for k, v in a.items()}
        if a.dim() == 0:
            return a
        per = a.shape[0] // process_count
        return a[process_index * per: (process_index + 1) * per]

    return cut(batch)
