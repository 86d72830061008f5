"""The port's `ClusteredTask`, `host_shard`, threefry `uniform`/`normal`
and MADDNESS (`core/maddness.py`) against the reference's.

Bounds: the integer draws and the uniform bits are bytewise; a normal is
within NORMAL_ULP float32 ulp (bytewise wherever torch's float32 log1p
agrees with XLA's: at least MIN_EQUAL of the draws); the features within
X_ATOL; the labels equal except where the reference's teacher logits have a
top-2 gap under LABEL_GAP; MADDNESS' trees, codes and prototypes bytewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import maddness as jmad
from repro.data import synthetic as jsyn
from repro_torch.core import maddness
from repro_torch.data import synthetic

NORMAL_ULP = 3
MIN_EQUAL = 0.98
X_ATOL = 1e-6
LABEL_GAP = 1e-5


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_and_normal_match_jax(seed):
    key = synthetic.prng_key(seed)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    want_u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4096, 8), jnp.float32,
                                           lo, 1.0))
    got_u = synthetic.uniform(key, (4096, 8), lo, 1.0).numpy()
    assert got_u.tobytes() == want_u.tobytes()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (4096, 8)))
    got = synthetic.normal(key, (4096, 8)).numpy()
    d = _ulps(got, want)
    assert d.max() <= NORMAL_ULP
    assert (d == 0).mean() >= MIN_EQUAL


@pytest.mark.parametrize("regression", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_clustered_task_matches_the_reference(seed, regression):
    kw = dict(seed=seed, regression=regression)
    for step in (0, 5):
        want = jsyn.ClusteredTask(**kw).sample(step, 512)
        got = synthetic.ClusteredTask(**kw).sample(step, 512, device="cpu")
        assert got["x"].dtype == torch.float32 and got["x"].shape == (512, 64)
        np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=0,
                                   atol=X_ATOL)
        if regression:
            np.testing.assert_allclose(got["y"].numpy(), np.asarray(want["y"]), rtol=1e-5,
                                       atol=1e-6)
            continue
        assert got["y"].dtype == torch.int32
        _, w1, w2 = jsyn.ClusteredTask(**kw)._teacher()
        logits = np.sort(np.asarray(jnp.tanh(want["x"] @ w1) @ w2), axis=-1)
        near_tie = (logits[:, -1] - logits[:, -2]) < LABEL_GAP
        differ = got["y"].numpy() != np.asarray(want["y"])
        assert not (differ & ~near_tie).any()


def test_host_shard_matches_the_reference():
    batch = synthetic.ClusteredTask().sample(1, 12, device="cpu")
    batch["scale"] = torch.tensor(2.0)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for i in range(3):
        got = synthetic.host_shard(batch, i, 3)
        want = jsyn.host_shard(jbatch, i, 3)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    nested = synthetic.host_shard({"a": {"b": torch.arange(8)}}, 1, 2)
    assert nested["a"]["b"].tolist() == [4, 5, 6, 7]


@pytest.mark.parametrize("n, d, k, v", [(512, 64, 16, 8), (300, 32, 8, 4), (40, 32, 16, 4)])
def test_maddness_matches_the_reference(n, d, k, v):
    rng = np.random.default_rng(n)
    acts = rng.standard_normal((n, d)).astype(np.float32)
    jt = jmad.fit_hash_trees(acts, k=k, v=v)
    tt = maddness.fit_hash_trees(acts, k=k, v=v)
    assert tt.split_dims.numpy().tobytes() == np.asarray(jt.split_dims).tobytes()
    assert tt.thresholds.numpy().tobytes() == np.asarray(jt.thresholds).tobytes()
    assert tt.depth == jt.depth
    x = torch.from_numpy(acts.copy())
    codes = maddness.maddness_encode(x, tt, v)
    assert codes.dtype == torch.int32
    assert codes.numpy().tobytes() == np.asarray(jmad.maddness_encode(jnp.asarray(acts), jt,
                                                                      v)).tobytes()
    protos = maddness.bucket_prototypes(x, tt, k=k, v=v)
    assert protos.numpy().tobytes() == np.asarray(jmad.bucket_prototypes(acts, jt, k=k,
                                                                          v=v)).tobytes()


def test_maddness_on_clustered_features_and_power_of_two_k():
    acts = synthetic.ClusteredTask(d_in=32).sample(0, 256, device="cpu")["x"]
    tree = maddness.fit_hash_trees(acts.numpy(), k=16, v=8)
    codes = maddness.maddness_encode(acts, tree, 8)
    assert codes.shape == (256, 4) and int(codes.min()) >= 0 and int(codes.max()) < 16
    with pytest.raises(ValueError, match="power-of-two"):
        maddness.fit_hash_trees(acts.numpy(), k=12, v=8)
