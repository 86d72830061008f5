"""Deterministic synthetic language-model data: `MarkovLM`.

Counterpart of `repro.data.synthetic.MarkovLM`, giving its batches bit for
bit: token streams walk a random sparse Markov chain (a real next-token task
whose loss can drop well below the uniform entropy). Every batch is keyed by
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

`ClusteredTask` and `host_shard` are not ported yet (ROADMAP Queue A item 4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import torch

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
