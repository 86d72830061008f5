"""Training every family of the port against the JAX reference: the loss
(with the MoE aux value) and the gradient of every leaf for every arch in
DENSE and in LUT_TRAIN, as `tests/test_archs.py` runs the reference; and
the launcher: the reference's --arch choices, the two families it refuses,
the reference's own failure there, and the Recipe on the token-input
families. Per family the train step, the tape, Lloyd, deploy and a trained
artifact: tests/test_torch_train_families_pipeline.py (two files, so that
the suite's workers share them).

`reduce_arch` sizes (d_model 128, at most 4 layers, vocab 512, 4 experts,
V = 16), all fp32, the same numpy inputs from a seed in both packages. LUT
centroids start at the activations' scale (x 40), where k-means puts them,
so that the codes spread over the codebooks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _grad_close

from repro import configs as jcfg
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.data import MarkovLM as JMarkovLM
from repro.train import recipe as jrecipe
from repro_torch import configs as tcfg
from repro_torch.launch import train as tlaunch
from repro_torch.testing import family_batch
from repro_torch.train import train_step as tts
from repro_torch.weights import params_from_numpy, reference_arrays, tree_map_ref

ALL = tcfg.ARCH_IDS + tcfg.EXTRA_IDS
FAMILIES = ["arctic_480b", "mamba2_370m", "zamba2_1p2b", "whisper_tiny", "qwen2_vl_7b"]
EXPERT_KINDS = ("moe/gate", "moe/up", "moe/down")
B, S = 2, 16
LOGIT_TOL = 1e-5      # a deployed model's logits, the same int8 tables in both
TIE_EPS = 1e-6
CENTROID_SCALE = 40.0
LR_STEP1 = 5e-3       # the cosine schedule below at step 1 (warmup 2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the models are small, and
    the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(arch, seed=0):
    """The family's training batch (`testing.family_batch`), numpy: labels
    and tokens; stub frames for the enc-dec; patch and text embedding rows
    with their grid's (t, h, w) M-RoPE streams for the vision-LM."""
    return family_batch(arch, B, S, seed=seed)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _models(name, mode, key=0):
    """Both packages' bundles of the reduced arch and the reference's init
    (numpy), LUT centroids moved to the activations' scale."""
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch(name)), mode)
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch(name)), mode)
    jp = jax.tree.map(np.array, jax.jit(jb.init)(jax.random.PRNGKey(key)))

    def scale(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                scale(v)
            elif k == "centroids":
                tree[k] = v * CENTROID_SCALE

    scale(jp)
    return jb, jp, tb


def _port_grads(tb, tp, batch):
    frozen = tree_map_ref(lambda _p, _t: False, tp)
    live, leaves = tts.trainable_view(tp, frozen)
    logits, aux = tb.train_logits(live, batch, compute_dtype=torch.float32)
    loss = tb.loss_from_logits(logits, aux, batch["labels"])
    return loss, aux, tts.grads_tree(loss, leaves, tp, frozen)


# ---------------------------------------------------------------------------
# the loss and every gradient, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "lut_train"])
@pytest.mark.parametrize("name", ALL)
def test_loss_with_aux_and_every_gradient_match_reference(name, mode):
    """`ModelBundle.loss` (CE, plus LM_AUX_WEIGHT x the MoE value for the lm
    family) within rtol 1e-5 of the reference's `value_and_grad`, and every
    gradient leaf within `_grad_close` (frozen LUT weights: zero in both).
    An MoE model's aux is positive and moves the loss."""
    jb, jp, tb = _models(name, mode)
    batch = _batch(jb.arch)

    def jloss(p, b):
        logits, aux = jb.train_logits(p, b, compute_dtype=jnp.float32)
        return jb.loss_from_logits(logits, aux, b["labels"]), aux

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), _j(batch))
    loss, aux, grads = _port_grads(tb, params_from_numpy(tb, jp, device="cpu"), _t(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    if tb.arch.n_experts:
        assert float(aux) > 0
    want, got = jflatten(jg), reference_arrays(grads)
    assert sorted(got) == sorted(want)
    for path in want:
        _grad_close(got[path], want[path], path)
    if mode == "lut_train" and tb.arch.n_experts:
        # the expert weights are frozen; their shared codebooks learn
        assert not got["segments/1/moe/up/w"].any()
        assert np.abs(got["segments/1/moe/up/centroids"]).max() > 0


# ---------------------------------------------------------------------------
# the launcher, and the reference's faults it refuses to copy
# ---------------------------------------------------------------------------

def test_launcher_offers_the_reference_choices(tmp_path, capsys):
    """--arch takes what the reference's launcher takes, bert_base included:
    every arch the launcher trains dumps its recipe."""
    for name in jcfg.ARCH_IDS + ("bert_base",):
        if tlaunch.train_refusal(tcfg.get_arch(name)) is not None:
            continue
        tlaunch.main(["--arch", name, "--lut", "--dump-recipe", str(tmp_path / f"{name}.json")])
        assert (tmp_path / f"{name}.json").exists()
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "gpt2", "--dump-recipe", str(tmp_path / "x.json")])


@pytest.mark.parametrize("name,reason", [("whisper_tiny", "audio frames"),
                                         ("qwen2_vl_7b", "embeddings")])
def test_launcher_refuses_the_families_its_data_cannot_feed(tmp_path, capsys, name, reason):
    """whisper_tiny and qwen2_vl_7b exit 2 naming the reason, before
    anything is built or written."""
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--arch", name, "--device", "cpu", "--lut", "--ckpt-dir",
                      str(tmp_path / "ck")])
    assert exc.value.code == 2
    assert reason in capsys.readouterr().err
    assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("name", ["whisper_tiny", "qwen2_vl_7b"])
def test_reference_recipe_fails_at_its_first_dense_step(tmp_path, name):
    """The known reference faults the port's refusal avoids: the
    reference's Recipe on MarkovLM token batches dies in its first dense
    step, on KeyError 'frames' (whisper_tiny) and on reading embeds of None
    (qwen2_vl_7b, reported by the step guard after its retries)."""
    arch = jcfg.reduce_arch(jcfg.get_arch(name), d_model=64, n_layers=2, vocab=128, d_ff=128)
    data = JMarkovLM(vocab=128, seq_len=16, batch=4)
    recipe = jrecipe.default_recipe(steps=2, lut=True, artifact_dir=str(tmp_path / "art"))
    if name == "whisper_tiny":
        with pytest.raises(KeyError, match="frames"):
            recipe.run(arch, data, ckpt_dir=tmp_path / "run", verbose=False)
    else:
        with pytest.raises(RuntimeError, match="step failed") as exc:
            recipe.run(arch, data, ckpt_dir=tmp_path / "run", verbose=False)
        assert isinstance(exc.value.__cause__, AttributeError)
        assert "astype" in str(exc.value.__cause__)
    assert not (tmp_path / "art").exists()


@pytest.mark.parametrize("name", ["mamba2_370m", "zamba2_1p2b", "arctic_480b", "bert_base"])
def test_port_recipe_trains_the_token_families(tmp_path, name):
    """The launcher's Recipe at a tiny size on the token-input families:
    dense -> k-means -> soft-PQ -> deploy -> eval, the artifact written and
    loaded, its deployed loss finite and equal to the loaded model's."""
    from repro_torch.data import MarkovLM
    from repro_torch.serving import artifact as tart
    from repro_torch.train.recipe import default_recipe

    base = tcfg.get_arch(name)
    arch = tcfg.reduce_arch(base, d_model=64, n_layers=2, vocab=128,
                            d_ff=0 if base.d_ff == 0 else 128)
    data = MarkovLM(vocab=128, seq_len=16, batch=4)
    res = default_recipe(steps=2, lut=True, artifact_dir=str(tmp_path / "art")).run(
        arch, data, ckpt_dir=tmp_path / "run", verbose=False, device="cpu")
    loss = res.stage_result("eval")["deployed_loss"]
    assert np.isfinite(loss)
    art = tart.load_artifact(tmp_path / "art", device="cpu")
    with torch.no_grad():
        again = float(art.bundle.loss(art.params, data.batch_at(99_999),
                                      compute_dtype=torch.float32))
    assert again == pytest.approx(loss, rel=1e-6)
