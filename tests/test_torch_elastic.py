"""Elastic rescale and the Trainer on a data mesh, against the reference:
`best_mesh_shape` equal to the reference's; the reference's 8 -> 4 elastic
test (tests/test_sharded.py) at 4 -> 2 gloo ranks on the CPU, the dp-4
checkpoint restored by the reference too, with ZeRO-1 and with FSDP
(`ElasticContext.build(fsdp=True)`); the Trainer over the ZeRO-1 step at
dp 2, committing on rank 0 and resuming each rank's shards bytewise."""

import jax
import numpy as np
import pytest

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.configs import build_model as jbuild
from repro.configs import get_arch as jget
from repro.configs import reduce_arch as jreduce
from repro.core.amm import Mode as JMode
from repro.distributed import elastic as jelastic
from repro.optim import AdamW as JAdamW
from repro_torch.distributed import elastic
from tests._tp_ranks import dp_elastic, dp_trainer, run_ranks

# the reference test's reduced model (tests/test_sharded.py)
SMALL = dict(arch="llama3_8b", layers=2, vocab=64, d=64, d_ff=128, mode="dense", lr=1e-2,
             clip=1.0, batch=8, seq=16)


def test_best_mesh_shape_matches_the_reference():
    for n in range(1, 17):
        for pm in (1, 2, 4, 8):
            assert elastic.best_mesh_shape(n, prefer_model=pm) == \
                jelastic.best_mesh_shape(n, prefer_model=pm), (n, pm)
    # FSDP builds: the step gets FSDP's rules; (data, model) meshes build
    # (tests/test_torch_tp_train.py)
    ctx = elastic.ElasticContext.build(["cpu"], lambda m, r: r, fsdp=True)
    assert ctx.rules.fsdp and ctx.step_fn is ctx.rules


def test_elastic_rescale_4_to_2(tmp_path):
    """The reference's 8 -> 4 test at 4 -> 2 ranks: 6 steps at dp 4, a
    commit, all four leave; a new group of 2 restores the checkpoint cut
    for its mesh and runs 6 more; the dp-4 checkpoint also restores in the
    reference."""
    spec = dict(SMALL, arch="qwen3_1p7b", lr=3e-3)
    ck = str(tmp_path / "ck")
    four = run_ranks(dp_elastic, 4, 4, spec, ck, 6, False, axis=None)
    two = run_ranks(dp_elastic, 2, 2, spec, ck, 6, True, axis=None)
    assert [r["mesh"] for r in four] == [(4, 1)] * 4 and [r["mesh"] for r in two] == [(2, 1)] * 2
    assert all(r["start"] == 6 and r["step"] == 12 for r in two)
    losses = four[0]["loss"] + two[0]["loss"]
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert two[0]["loss"] == two[1]["loss"]
    # the dp-4 checkpoint in the reference
    jb = jbuild(jreduce(jget("qwen3_1p7b"), n_layers=2, vocab=64, d_model=64, d_ff=128),
                JMode.DENSE)
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    like = {"params": jp, "opt": jax.eval_shape(JAdamW().init, jp)}
    step, tree = JCheckpointer(ck).restore(like, step=6)
    with np.load(tmp_path / "ck" / "step_00000006" / "arrays.npz") as f:
        files = dict(f)
    got = jflatten(tree)
    assert step == 6 and sorted(got) == sorted(files)
    for path, a in got.items():
        np.testing.assert_array_equal(a, files[path], err_msg=path)


def test_elastic_rescale_4_to_2_under_fsdp(tmp_path):
    """The same rescale under FSDP: 6 steps at dp 4, each rank holding its
    quarter of every leaf `param_spec(fsdp=True)` splits over "data", a
    commit (the reference's layout, which the reference restores), all four
    leave; a group of 2 restores its halves and runs 6 more, both ranks
    with the same losses."""
    from repro_torch.configs import build_model, get_arch, reduce_arch
    from repro_torch.core.amm import Mode
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.testing import expected_rank_shapes

    spec = dict(SMALL, arch="qwen3_1p7b", lr=3e-3, fsdp=True)
    ck = str(tmp_path / "ck")
    four = run_ranks(dp_elastic, 4, 4, spec, ck, 6, False, axis=None)
    two = run_ranks(dp_elastic, 2, 2, spec, ck, 6, True, axis=None)
    assert all(r["fsdp"] for r in four + two)
    assert all(r["start"] == 6 and r["step"] == 12 for r in two)
    losses = four[0]["loss"] + two[0]["loss"]
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert two[0]["loss"] == two[1]["loss"]
    bundle = build_model(reduce_arch(get_arch("qwen3_1p7b"), n_layers=2, vocab=64, d_model=64,
                                     d_ff=128), Mode.DENSE)
    for ranks, n in ((four, 4), (two, 2)):
        for i, r in enumerate(ranks):
            want, _ = expected_rank_shapes(bundle, ShardingRules(data=n, fsdp=True), i)
            assert r["shapes"] == want, (n, i)
    jb = jbuild(jreduce(jget("qwen3_1p7b"), n_layers=2, vocab=64, d_model=64, d_ff=128),
                JMode.DENSE)
    jp = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    step, tree = JCheckpointer(ck).restore({"params": jp, "opt": jax.eval_shape(JAdamW().init,
                                                                                  jp)}, step=6)
    with np.load(tmp_path / "ck" / "step_00000006" / "arrays.npz") as f:
        files = dict(f)
    assert step == 6 and sorted(jflatten(tree)) == sorted(files)
    for path, a in jflatten(tree).items():
        np.testing.assert_array_equal(a, files[path], err_msg=path)


def test_trainer_commits_on_rank_0_and_resumes_the_zero1_shards(tmp_path):
    """The Trainer over the ZeRO-1 step at dp 2: rank 0 writes whole arrays
    (the reference's format) behind a barrier, and a run stopped at a
    commit and resumed (each rank reading its shards) ends bytewise where
    the straight run ends."""
    spec = SMALL
    ranks = run_ranks(dp_trainer, 2, spec, str(tmp_path), 4, axis="data")
    for r in ranks:
        assert r["resumed_steps"] == [2, 3]
        assert sorted(r["straight"]) == sorted(r["resumed"])
        for path, a in r["straight"].items():
            np.testing.assert_array_equal(a, r["resumed"][path], err_msg=path)
    with np.load(tmp_path / "split" / "step_00000004" / "arrays.npz") as f:
        for path, a in ranks[0]["resumed"].items():
            np.testing.assert_array_equal(f[path], a, err_msg=path)
