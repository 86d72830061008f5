"""The port's int8 error-feedback gradient reduce (`train/grad_compression.py`)
against the reference's, and the compressed dense stage.

The reference's `_quant`, `compressed_mean_1d` and `compressed_mean_tree`
run under its `shard_map` over an 8-device data mesh (forced host devices,
in a subprocess); the port's plain version takes the same per-rank inputs.
They agree bytewise, or an element differs by one step of its chunk's final
scale where a 1-ulp difference of the chunk's fp32 sum (XLA's einsum sums
the peers in another order) flips a requantization tie; such elements are
counted and bounded. The port's collective version on 2 and 4 gloo ranks
equals its plain version bytewise. The reference test's linear toy
(tests/test_sharded.py) through `make_compressed_grad_fn`, the recipe's
compressed dense stage (DESIGN.md §10.4: it runs, learns, checkpoints and
resumes its residual bytewise), the launcher's `--grad-compression` (alone,
and at 2 gloo ranks in torchrun's environment), and the reference's
compressed train state restored by the port bytewise."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.configs import build_model as jbuild
from repro.configs import get_arch as jget
from repro.configs import reduce_arch as jreduce
from repro.core.amm import Mode as JMode
from repro.optim import AdamW as JAdamW
from repro.train.grad_compression import residual_correct as jresidual_correct
from repro.train.train_step import init_compressed_state as jinit_compressed_state
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.data import MarkovLM
from repro_torch.launch.mesh import mesh_of_group
from repro_torch.optim import AdamW
from repro_torch.testing import one_step_off
from repro_torch.train import grad_compression as gc
from repro_torch.train import recipe as trecipe
from repro_torch.train.train_step import init_compressed_state, make_compressed_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.weights import reference_arrays
from tests._subproc import SRC, run_with_devices
from tests._tp_ranks import _tree_of, dp_compress, dp_launcher, run_ranks

N_REF = 8                 # the reference's data mesh
LOSS_TOL = 1e-5           # the reference test's loss bound (fp32 means)
GRAD_ERR = 0.05           # the reference test's max-abs error over max-abs
TIE_STEPS = 1 + 1e-5      # one final-scale step, and fp32 rounding of its ratio
# at most this share of elements off by one step (a tie flipped by 1 ulp is
# rare: a handful among the 12000 here)
TIE_SHARE = 1e-2


def _inputs():
    rng = np.random.default_rng(0)
    # rank r's vector scaled by r + 1, so that the chunks' scales differ
    vecs = (rng.standard_normal((N_REF, 3000)) * np.arange(1, N_REF + 1)[:, None]).astype(
        np.float32)
    trees = [{"table": rng.standard_normal((5, 4)).astype(np.float32) * (r + 1),
              "w": rng.standard_normal((2, 3, 4)).astype(np.float32)} for r in range(N_REF)]
    toy = {"w": rng.standard_normal((16, 4)).astype(np.float32),
           "x": rng.standard_normal((32, 16)).astype(np.float32),
           "y": rng.standard_normal((32, 4)).astype(np.float32)}
    return vecs, trees, toy


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("gc")
    vecs, trees, _ = _inputs()
    np.savez(d / "in.npz", vecs=vecs, table=np.stack([t["table"] for t in trees]),
             w=np.stack([t["w"] for t in trees]))
    run_with_devices(textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import make_mesh
        from repro.train.grad_compression import _quant, compressed_mean_1d, compressed_mean_tree

        sm = getattr(jax, "shard_map", None)
        kw = dict(check_vma=False)
        if sm is None:
            from jax.experimental.shard_map import shard_map as sm
            kw = dict(check_rep=False)
        mesh = make_mesh(({N_REF},), ("data",))
        d = np.load("{d / 'in.npz'}")
        one = jax.jit(sm(lambda v: compressed_mean_1d(v[0], axis="data", n={N_REF})[None],
                         mesh=mesh, in_specs=P("data"), out_specs=P("data"), **kw))
        # each rank's tree: its table, and its w stacked over 2 layers
        def per_rank(t):
            t = jax.tree.map(lambda x: x[0], t)
            return jax.tree.map(lambda x: x[None], compressed_mean_tree(t, axis="data",
                                                                       n={N_REF}))
        tr = jax.jit(sm(per_rank, mesh=mesh, in_specs=P("data"), out_specs=P("data"), **kw))
        out = tr({{"embed": {{"table": d["table"]}}, "segments": [{{"w": d["w"]}}]}})
        q = [jax.jit(_quant)(jnp.asarray(v)) for v in d["vecs"]]
        np.savez("{d / 'out.npz'}", one=np.asarray(one(d["vecs"])),
                 table=np.asarray(out["embed"]["table"]), w=np.asarray(out["segments"][0]["w"]),
                 q=np.stack([np.asarray(a) for a, _ in q]),
                 s=np.stack([np.asarray(b) for _, b in q]))
        """), n_devices=N_REF)
    with np.load(d / "out.npz") as f:
        return dict(f)


def _held(got: torch.Tensor, want: np.ndarray, n: int) -> int:
    off, worst = one_step_off(got, torch.as_tensor(want), n)
    assert worst <= TIE_STEPS and off <= TIE_SHARE * got.numel(), (off, worst)
    return off


def test_quant_and_compressed_means_match_the_reference(reference, monkeypatch):
    vecs, trees, _ = _inputs()
    for r, v in enumerate(vecs):
        q, s = gc._quant(torch.as_tensor(v))
        np.testing.assert_array_equal(q.numpy(), reference["q"][r])
        assert s.dtype == torch.float32 and s.item() == reference["s"][r]
    plain = gc.plain_compressed_mean(torch.as_tensor(vecs))
    for r in range(N_REF):                  # every rank ends with the same vector
        np.testing.assert_array_equal(reference["one"][r], reference["one"][0])
    ties = _held(plain, reference["one"][0], N_REF)
    monkeypatch.setattr(gc, "PEER_SUM_SLICE", 7)      # the peer sum in ragged slices
    assert torch.equal(gc.plain_compressed_mean(torch.as_tensor(vecs)), plain)
    tree = gc.plain_compressed_mean_tree([_tree_of(t) for t in trees])
    want = np.concatenate([reference["table"][0].reshape(-1), reference["w"][0].reshape(-1)])
    ties += _held(gc.flat_vector(tree), want, N_REF)
    assert [tuple(t.shape) for t in tree["segments"][0][0].values()] == [(3, 4)]
    print(f"elements one final-scale step off the reference: {ties}")


@pytest.mark.parametrize("n", [2, 4])
def test_collective_version_equals_the_plain_version(n):
    vecs, trees, toy = _inputs()
    ranks = run_ranks(dp_compress, n, vecs[:n], trees[:n], toy, axis="data")
    plain = gc.plain_compressed_mean(torch.as_tensor(vecs[:n])).numpy()
    plain_tree = gc.flat_vector(gc.plain_compressed_mean_tree(
        [_tree_of(t) for t in trees[:n]])).numpy()
    w = torch.as_tensor(toy["w"]).requires_grad_(True)
    loss_ref = ((torch.as_tensor(toy["x"]) @ w - torch.as_tensor(toy["y"])) ** 2).mean()
    (g_ref,) = torch.autograd.grad(loss_ref, w)
    for r in ranks:
        np.testing.assert_array_equal(r["vec"], plain)
        np.testing.assert_array_equal(r["tree"], plain_tree)
        t = r["toy"]
        assert abs(t["loss"] - loss_ref.item()) < LOSS_TOL
        err = np.abs(t["grad"] - g_ref.numpy()).max() / np.abs(g_ref.numpy()).max()
        assert err < GRAD_ERR, err
        assert np.abs(t["residual"]).max() > 0           # what int8 dropped
        np.testing.assert_array_equal(t["grad"], ranks[0]["toy"]["grad"])


def test_residual_is_exactly_what_int8_drops():
    rng = np.random.default_rng(1)
    grads = _tree_of({"table": rng.standard_normal((5, 4)).astype(np.float32),
                      "w": rng.standard_normal((2, 3, 4)).astype(np.float32)})
    residual = gc.init_residual(grads)
    corrected, res = gc.residual_correct(grads, residual)
    # one scale per leaf of the reference's stacked tree: over both layers of w
    w = torch.stack([lay["w"] for lay in corrected["segments"][0]])
    q, s = gc._quant(w)
    np.testing.assert_array_equal(torch.stack([lay["w"] for lay in res["segments"][0]]).numpy(),
                                  (w - q.float() * s).numpy())
    corrected2, _ = gc.residual_correct(grads, res)
    np.testing.assert_array_equal(corrected2["embed"]["table"].numpy(),
                                  (grads["embed"]["table"] + res["embed"]["table"]).numpy())


def _arch():
    return reduce_arch(get_arch("qwen3_1p7b"), d_model=64, n_layers=2, vocab=128, d_ff=128)


def _data(arch):
    # batch 16: at the reference test's batch 4 the MarkovLM losses of 8
    # steps spread more than the exact step moves them (its first and last
    # loss are in either order, compressed or not)
    return MarkovLM(vocab=arch.vocab, seq_len=16, batch=16)


def _stage(steps=8):
    # a constant lr: the default cosine warm-up (20 steps) barely moves 8
    # steps
    return trecipe.DensePretrain(steps=steps, ckpt_every=4, log_every=0, grad_compression=True,
                                 optim=trecipe.OptimSpec(lr=1e-2, schedule="constant"))


def test_grad_compression_dense_stage(tmp_path):
    arch, recipe = _arch(), trecipe.Recipe(stages=(_stage(),)).validate()
    res = recipe.run(arch, _data(arch), ckpt_dir=tmp_path / "run", verbose=False, device="cpu")
    hist = res.histories["dense"]
    assert len(hist) == 8 and all(np.isfinite(h["loss"]) for h in hist)
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] and np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    ck = Checkpointer(tmp_path / "run" / "00_dense")
    with np.load(ck.dir / f"step_{ck.latest_step():08d}" / "arrays.npz") as f:
        res_keys = [k for k in f.files if k.startswith("opt/residual/")]
        assert res_keys and any(np.abs(f[k]).max() > 0 for k in res_keys)
    res2 = recipe.run(arch, _data(arch), ckpt_dir=tmp_path / "run", verbose=False, device="cpu")
    assert res2.manifest["stages"][0]["status"] == "done"
    for (p, a), (_, b) in zip(sorted(tree_items(res.dense_params)),
                              sorted(tree_items(res2.dense_params))):
        np.testing.assert_array_equal(a, b, err_msg=p)


def tree_items(tree):
    return reference_arrays(tree).items()


def test_compressed_state_resumes_bytewise(tmp_path):
    """8 steps straight against 4, a commit, and a fresh Trainer resuming the
    other 4 (params, AdamW state and the residual from the checkpoint)."""
    arch = _arch()
    bundle = build_model(arch, Mode.DENSE)
    opt = trecipe.OptimSpec(lr=1e-2, schedule="constant").build(8)
    step = make_compressed_train_step(bundle, opt, mesh_of_group("cpu"),
                                      compute_dtype=torch.float32)
    data = _data(arch)
    batch_at = lambda i: {k: torch.as_tensor(np.asarray(v))      # noqa: E731
                          for k, v in data.batch_at(i).items()}

    def fit(total, ckdir):
        params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
        tr = Trainer(step_fn=step, batch_at=batch_at,
                     cfg=TrainerConfig(total_steps=total, ckpt_every=4, ckpt_dir=str(ckdir),
                                       log_every=0))
        return tr.fit(params, init_compressed_state(opt, params)), tr

    (p8, s8), _ = fit(8, tmp_path / "straight")
    fit(4, tmp_path / "split")
    (pr, sr), tr = fit(8, tmp_path / "split")
    assert [h["step"] for h in tr.history] == [4, 5, 6, 7]
    for a, b in ((p8, pr), (s8, sr)):
        for (p, x), (_, y) in zip(sorted(tree_items(a)), sorted(tree_items(b))):
            np.testing.assert_array_equal(x, y, err_msg=p)
    assert float(gc.flat_vector(s8["residual"]).abs().max()) > 0


def test_launcher_grad_compression_runs_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--grad-compression", "--d-model", "32", "--layers", "1", "--vocab", "64",
           "--seq", "16", "--batch", "4", "--steps", "4", "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    outs = [subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env)
            for _ in range(2)]
    for o in outs:
        assert o.returncode == 0, o.stderr
    assert "recipe: dense[4]+int8grads" in outs[0].stdout
    assert "[int8 compressed grads over 1 rank(s)]" in outs[0].stdout
    assert "[dense] already done" in outs[1].stdout
    manifest = json.loads((tmp_path / "ck" / "recipe_run.json").read_text())
    assert manifest["recipe"]["stages"][0]["grad_compression"] is True


def test_launcher_grad_compression_over_two_gloo_ranks(tmp_path):
    """Each rank joins the mesh from torchrun's environment; rank 0 alone
    logs and writes the checkpoints and the manifest; a re-run restores the
    committed stage on every rank."""
    argv = ["--device", "cpu", "--grad-compression", "--d-model", "32", "--layers", "1",
            "--vocab", "64", "--seq", "16", "--batch", "4", "--steps", "4", "--ckpt-dir",
            str(tmp_path / "ck")]
    first = run_ranks(dp_launcher, 2, 2, argv, axis=None)
    for out in first:
        assert "[int8 compressed grads over 2 rank(s)]" in out, out
    assert "step      0 loss" in first[0] and "step      0 loss" not in first[1]
    ck = Checkpointer(tmp_path / "ck" / "00_dense")
    assert ck.latest_step() == 4
    with np.load(ck.dir / "step_00000004" / "arrays.npz") as f:
        res_keys = [k for k in f.files if k.startswith("opt/residual/")]
        assert res_keys and any(np.abs(f[k]).max() > 0 for k in res_keys)
        assert all(np.isfinite(f[k]).all() for k in f.files)
    manifest = json.loads((tmp_path / "ck" / "recipe_run.json").read_text())
    assert manifest["stages"][0]["status"] == "done"
    for out in run_ranks(dp_launcher, 2, 2, argv, axis=None):
        assert "[dense] already done — restored" in out, out


def test_ranks_run_only_the_compressed_dense_stage(tmp_path, monkeypatch):
    """Over several ranks the launcher refuses --lut and a dense stage
    without --grad-compression before it joins a group, and `Recipe.run`
    refuses any other stage in a process group of several ranks."""
    from repro_torch.launch import train

    monkeypatch.setenv("WORLD_SIZE", "2")
    for extra in (["--grad-compression", "--lut"], []):
        with pytest.raises(SystemExit) as e:
            train.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), *extra])
        assert e.value.code == 2
    monkeypatch.setattr(trecipe.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(trecipe.dist, "get_world_size", lambda: 2)
    arch = _arch()
    for stages in ((_stage(), trecipe.CentroidInit()), (trecipe.DensePretrain(steps=2),)):
        with pytest.raises(trecipe.RecipeError, match="do not run over the 2 ranks"):
            trecipe.Recipe(stages=stages).run(arch, _data(arch), ckpt_dir=tmp_path / "run",
                                              verbose=False, device="cpu")
    assert not (tmp_path / "run").exists()


def test_reference_compressed_state_restores_in_the_port(tmp_path):
    """The reference's {"params", "opt": init_compressed_state(...)} with a
    non-zero residual, written by its Checkpointer, restores in the port
    bytewise (the residual rides in the opaque opt slot)."""
    small = dict(n_layers=2, vocab=64, d_model=64, d_ff=128)
    jp = jbuild(jreduce(jget("qwen3_1p7b"), **small), JMode.DENSE).init(jax.random.PRNGKey(0))
    state = jinit_compressed_state(JAdamW(), jp)
    _, state["residual"] = jresidual_correct(jax.tree.map(lambda p: p * 0.37, jp),
                                             state["residual"])
    assert max(float(jnp.abs(r).max()) for r in jax.tree.leaves(state["residual"])) > 0
    JCheckpointer(tmp_path).save(3, {"params": jp, "opt": state}, blocking=True)
    tb = build_model(reduce_arch(get_arch("qwen3_1p7b"), **small), Mode.DENSE)
    tparams = tb.init(torch.Generator().manual_seed(1), device="cpu")
    like = {"params": tparams, "opt": init_compressed_state(AdamW(), tparams)}
    step, tree = Checkpointer(tmp_path).restore(like)
    want = jflatten({"params": jp, "opt": state})
    got = reference_arrays(tree)
    assert step == 3 and sorted(got) == sorted(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)
