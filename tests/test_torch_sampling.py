"""The port's sampler against the reference's: JAX's threefry bits
reproduced in torch, and `sample_tokens` over temperature / top-k / top-p.

The bits are compared exactly. Tokens are expected byte-equal; the gumbel
noise goes through torch's fp32 log, which may differ from XLA's in the last
ulp, so a differing token must sit on a near-tie of gumbel + logit (the
reference's own noise, recomputed here from its bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as jsampling
from repro_torch.serving import sampling

SEEDS = [0, 1, 5, -1, -7, 2**31 - 1, -(2**31), 123456789]
COUNTERS = [0, 1, 17, 1000, 2**31 - 1]
TIE_ULPS = 8          # gumbel + logit gap, in fp32 ulps of its size, that explains a flip


def _port_key(seed: int, counter: int) -> torch.Tensor:
    return sampling.fold_in(sampling.prng_keys(torch.tensor([seed], dtype=torch.int32)),
                            torch.tensor([counter]))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), sampling.prng_keys(
        torch.tensor([seed], dtype=torch.int32))[0].numpy().astype(np.uint32))
    for n in COUNTERS:
        want = np.asarray(jax.random.fold_in(key, n))
        assert np.array_equal(want, _port_key(seed, n)[0].numpy().astype(np.uint32)), n


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax_bits(seed):
    for n in COUNTERS:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), n)
        want = np.asarray(jax.random.bits(k, (1031,)))
        got = sampling.random_bits(_port_key(seed, n), 1031)[0].numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_gumbel_within_an_ulp_of_jax():
    for seed in SEEDS[:4]:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jax.random.gumbel(k, (4096,)))
        got = sampling.gumbel(_port_key(seed, 3), 4096)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float32).eps, atol=1e-6)


def _grid_case(rng, b, v):
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[0, :3] = logits[0, 3]            # ties in the logits themselves
    temps = rng.choice(np.array([0.0, 0.3, 0.8, 1.0, 1.7], np.float32), b)
    top_ks = rng.choice(np.array([0, 1, 5, 50, v], np.int32), b)
    top_ps = rng.choice(np.array([1.0, 0.95, 0.9, 0.5, 0.1], np.float32), b)
    seeds = rng.integers(-(2**31), 2**31, b).astype(np.int32)
    counters = rng.integers(0, 64, b).astype(np.int32)
    return logits, temps, top_ks, top_ps, seeds, counters


def _explained(case, row, got, want) -> bool:
    """Whether the two tokens of `row` tie on gumbel + filtered logit within
    TIE_ULPS ulps (the reference's noise, from its own bits)."""
    logits, temps, top_ks, top_ps, seeds, counters = case
    key = jax.random.fold_in(jax.random.PRNGKey(int(seeds[row])), int(counters[row]))
    g = np.asarray(jax.random.gumbel(key, (logits.shape[1],)))
    scaled = logits[row] / max(float(temps[row]), 1e-6)
    a, b = g[got] + scaled[got], g[want] + scaled[want]
    return abs(a - b) <= TIE_ULPS * np.finfo(np.float32).eps * max(abs(a), abs(b), 1.0)


@pytest.mark.parametrize("trial", range(6))
def test_sample_tokens_match_reference_over_grid(trial):
    rng = np.random.default_rng(trial)
    b, v = 16, 301
    case = _grid_case(rng, b, v)
    want = np.asarray(jsampling.sample_tokens(*(jnp.asarray(a) for a in case)))
    got = sampling.sample_tokens(*(torch.from_numpy(a) for a in case)).numpy()
    assert got.dtype == np.int32 and got.shape == (b,)
    for row in np.flatnonzero(got != want):
        assert _explained(case, row, got[row], want[row]), (trial, row)
    greedy = case[1] <= 0
    np.testing.assert_array_equal(got[greedy], np.argmax(case[0][greedy], axis=-1))


def test_sampling_is_keyed_by_seed_and_counter_only():
    """The same (seed, counter) draws the same token in any row of any batch."""
    rng = np.random.default_rng(7)
    row = (rng.standard_normal(64) * 2).astype(np.float32)
    t = torch.from_numpy(np.stack([row, row[::-1].copy(), row]))
    args = (torch.tensor([0.9, 0.9, 0.9]), torch.tensor([0, 0, 0], dtype=torch.int32),
            torch.tensor([1.0, 1.0, 1.0]), torch.tensor([42, 42, 42], dtype=torch.int32),
            torch.tensor([5, 5, 5], dtype=torch.int32))
    toks = sampling.sample_tokens(t, *args)
    assert toks[0] == toks[2]
    one = sampling.sample_tokens(t[2:], *(a[2:] for a in args))
    assert one[0] == toks[2]


def test_sampling_params_validate_and_fold_seed():
    with pytest.raises(ValueError):
        sampling.SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        sampling.SamplingParams(top_p=0.0)
    assert sampling.SamplingParams(seed=2**40 + 3).seed == (2**40 + 3) & 0x7FFFFFFF
    assert sampling.GREEDY.greedy and not sampling.SamplingParams(temperature=0.5).greedy
