"""Soft-PQ's first-step gradient against the reference's, from k-means
centroids, on the SSM and hybrid families.

The recipe's first soft-PQ step on mamba2_370m and zamba2_1p2b has a
gradient norm of ~1e8 (the temperatures' gradients at sites whose inputs
are not normalized, out_proj); clipping to 1.0 then leaves every other leaf
nearly still. This holds that norm, and each leaf's gradient, against the
reference's `value_and_grad` on the same params: the port's k-means
centroids (`core.convert.kmeans_init_lut` on the dense model's taped
activations, as the recipe's CentroidInit stage puts them) fed to both
packages, one batch of `testing.family_batch`.

Here at reduced width (`reduce_arch`, 2 layers, `family_batch` batches).
At full published width (2 layers, on the CPU; a few minutes and ~10 GB),
on the recipe's data (MarkovLM 4 x 256, the k-means samples from batch
10000, the soft-PQ batch 0; the dense weights at their init, where the
recipe's 4 dense steps under a 20-step warm-up leave them), run as a
script:

    PYTHONPATH=src python -m tests.test_torch_soft_pq_grad_norm --full

which prints each arch's loss, global norm and largest leaves in both
packages."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.checkpointer import tree_paths
from repro_torch import configs as tcfg
from repro_torch.core.amm import Mode
from repro_torch.core.convert import graft_dense_to_lut, kmeans_init_lut
from repro_torch.data import MarkovLM
from repro_torch.testing import family_batch
from repro_torch.train import train_step as tts
from repro_torch.weights import params_from_numpy, reference_arrays, tree_map_ref

ARCHS = ("mamba2_370m", "zamba2_1p2b")
NORM_RTOL = 1e-4       # the global norm: fp32 sums of ~1e16 squares in two orders
LEAF_L2 = 1e-4         # each leaf's gradient, L2 relative to the reference's
BATCH, SEQ, SAMPLES = 2, 32, 2


def _setup(name: str, full: bool, layers: int = 2):
    """(reference bundle, its LUT_TRAIN params with the port's k-means
    centroids as numpy, port bundle, batch): the reference's dense init
    grafted into its LUT_TRAIN init and taped by the port's dense model on
    SAMPLES batches, as the recipe's CentroidInit stage does."""
    jarch, tarch = jcfg.get_arch(name), tcfg.get_arch(name)
    if full:
        jarch = dataclasses.replace(jarch, n_layers=layers)
        tarch = dataclasses.replace(tarch, n_layers=layers)
    else:
        jarch, tarch = (jcfg.reduce_arch(jarch, n_layers=2),
                        tcfg.reduce_arch(tarch, n_layers=2))
    jb = jcfg.build_model(jarch, Mode.LUT_TRAIN.value)
    jp = jax.tree.map(np.array, jax.jit(jb.init)(jax.random.PRNGKey(0)))
    jdense = jcfg.build_model(jarch, Mode.DENSE.value)
    tb = tcfg.build_model(tarch, Mode.LUT_TRAIN)
    tdense = tcfg.build_model(tarch, Mode.DENSE)
    dense = params_from_numpy(tdense, jax.tree.map(np.array, jax.jit(jdense.init)(
        jax.random.PRNGKey(1))), device="cpu")
    lut = graft_dense_to_lut(dense, params_from_numpy(tb, jp, device="cpu"))
    if full:        # the recipe's data: MarkovLM 4 x 256, k-means samples from batch 10000
        data = MarkovLM(vocab=tarch.vocab, seq_len=256, batch=4)
        samples, batch = [data.batch_at(10_000 + i) for i in range(SAMPLES)], data.batch_at(0)
    else:
        samples = [family_batch(tarch, BATCH, SEQ, seed=100 + i) for i in range(SAMPLES)]
        batch = family_batch(tarch, BATCH, SEQ, seed=7)
    samples = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()} for b in samples]
    lut = kmeans_init_lut(tdense, dense, tb, lut, samples, torch.Generator().manual_seed(0))
    arrays = reference_arrays(lut)
    paths = tree_paths(jp)
    jp = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                      [arrays[p] for p in paths])
    return jb, jp, tb, batch


def _norms(name: str, full: bool, layers: int = 2) -> dict:
    jb, jp, tb, batch = _setup(name, full, layers)

    def jloss(p, b):
        logits, aux = jb.train_logits(p, b, compute_dtype=jnp.float32)
        return jb.loss_from_logits(logits, aux, b["labels"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, jp),
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(tb, jax.tree.map(np.array, jp), device="cpu")
    frozen = tree_map_ref(lambda _p, _t: False, tp)
    live, leaves = tts.trainable_view(tp, frozen)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    logits, aux = tb.train_logits(live, tbatch, compute_dtype=torch.float32)
    loss = tb.loss_from_logits(logits, aux, tbatch["labels"])
    got = reference_arrays(tts.grads_tree(loss, leaves, tp, frozen))
    want = {p: np.asarray(g) for p, g in zip(tree_paths(jg), jax.tree_util.tree_leaves(jg))}
    norm = lambda d: float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())  # noqa: E731
                                       for g in d.values())))
    leaf = {p: (float(np.linalg.norm(got[p].astype(np.float64))),
                float(np.linalg.norm(want[p].astype(np.float64))),
                float(np.linalg.norm((got[p] - want[p]).astype(np.float64))))
            for p in want}
    return {"loss": (float(loss.detach()), float(jl)), "norm": (norm(got), norm(want)), "leaf": leaf}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the suite's parallel
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# zamba2_1p2b's mamba layers are mamba2_370m's block; the script runs both
@pytest.mark.parametrize("name", ["zamba2_1p2b"])
def test_soft_pq_first_step_gradient_matches_the_reference(name):
    """From the port's k-means centroids, the soft-PQ loss, the global
    gradient norm and every leaf's gradient equal the reference's within
    fp32 rounding (NORM_RTOL, LEAF_L2); the temperatures carry the norm in
    both packages."""
    r = _norms(name, full=False)
    np.testing.assert_allclose(*r["loss"], rtol=1e-5)
    np.testing.assert_allclose(*r["norm"], rtol=NORM_RTOL)
    for path, (g, w, d) in r["leaf"].items():
        assert d <= LEAF_L2 * max(w, 1e-30) or w == 0 and g == 0, (path, g, w, d)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="full published width")
    ap.add_argument("--layers", type=int, default=2, help="depth at full width")
    ap.add_argument("--arch", choices=ARCHS, action="append", help="default: both")
    args = ap.parse_args()
    torch.manual_seed(0)
    for name in args.arch or ARCHS:
        r = _norms(name, args.full, args.layers)
        top = sorted(r["leaf"].items(), key=lambda kv: -kv[1][1])[:4]
        print(f"{name} ({'full width' if args.full else 'reduced'}, "
              f"{args.layers if args.full else 2} layers): loss port "
              f"{r['loss'][0]!r} reference {r['loss'][1]!r}; global norm port {r['norm'][0]!r} "
              f"reference {r['norm'][1]!r}")
        for path, (g, w, d) in top:
            print(f"  {path}: port {g!r} reference {w!r} |port - reference| {d!r}")


if __name__ == "__main__":
    main()
