"""bfloat16 leaves in checkpoint files, between the two packages.

A bf16 arch's params (command_r_35b, reduced, param_dtype bfloat16) and a
bf16 AdamW-like tree: the port writes what the reference writes (manifest
dtype "bfloat16", each `.npy` member's bytes, header '<V2' included); the
port restores the reference's files, its own and its older files (uint16
bits under manifest dtype "uint16") into bfloat16 tensors bytewise. The
reference cannot restore its own bf16 checkpoint (`np.savez` stores an
ml_dtypes array as void, which `jax.device_put` rejects): a known reference
fault, shown here."""

import json
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core.amm import Mode as JMode
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.weights import layer_specs, params_from_numpy, reference_arrays

STEP = 7


@pytest.fixture(scope="module")
def trees():
    """(reference bf16 params, the same params in the port's layout)."""
    arch = dict(n_layers=2, param_dtype="bfloat16")
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("command_r_35b"), **arch), JMode.DENSE)
    jparams = jb.init(jax.random.PRNGKey(0))
    tb = build_model(reduce_arch(get_arch("command_r_35b"), **arch), Mode.DENSE)
    tparams = params_from_numpy(tb, jax.tree.map(np.asarray, jparams), device="cpu")
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    return jparams, tb, tparams


def _members(path) -> dict[str, bytes]:
    with zipfile.ZipFile(path / f"step_{STEP:08d}" / "arrays.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def _manifest(path) -> dict:
    return json.loads((path / f"step_{STEP:08d}" / "manifest.json").read_text())


def _bits(tree) -> dict[str, bytes]:
    return {p: a.tobytes() for p, a in reference_arrays(tree).items()}


def test_port_writes_the_reference_bytes(trees, tmp_path):
    jparams, _, tparams = trees
    JCheckpointer(tmp_path / "ref").save(STEP, jparams, blocking=True)
    Checkpointer(tmp_path / "port").save(STEP, tparams, blocking=True)
    want, got = _members(tmp_path / "ref"), _members(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert b"'descr': '<V2'" in want["embed/table.npy"][:64]
    assert _manifest(tmp_path / "port")["leaves"] == _manifest(tmp_path / "ref")["leaves"]
    assert _manifest(tmp_path / "port")["leaves"]["embed/table"]["dtype"] == "bfloat16"


def test_port_restores_the_reference_its_own_and_older_files(trees, tmp_path):
    jparams, tb, tparams = trees
    JCheckpointer(tmp_path / "ref").save(STEP, jparams, blocking=True)
    Checkpointer(tmp_path / "port").save(STEP, tparams, blocking=True)
    # the port's files before bf16 members: uint16 bits, manifest dtype uint16
    old = tmp_path / "old" / f"step_{STEP:08d}"
    old.mkdir(parents=True)
    flat = reference_arrays(tparams)
    np.savez(old / "arrays.npz", **flat)
    (old / "manifest.json").write_text(json.dumps({"step": STEP, "leaves": {
        k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()}}))
    want = _bits(tparams)
    for src in ("ref", "port", "old"):
        for like in (tparams, layer_specs(tb)):
            step, got = Checkpointer(tmp_path / src).restore(like, device="cpu")
            assert step == STEP
            assert got["embed"]["table"].dtype == torch.bfloat16, src
            assert _bits(got) == want, src


def test_port_carries_a_bf16_train_state_both_ways(tmp_path):
    """A bf16 leaf beside fp32 and int leaves, and a bf16 scalar."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(torch.bfloat16)
    tree = {"m": {"w": w, "s": torch.tensor(1.5, dtype=torch.bfloat16)},
            "v": {"w": w.float()}, "step": torch.tensor(3, dtype=torch.int32)}
    Checkpointer(tmp_path).save(STEP, tree, blocking=True)
    _, got = Checkpointer(tmp_path).restore(tree)
    assert _bits(got) == _bits(tree)
    assert got["m"]["s"].dtype == torch.bfloat16 and got["v"]["w"].dtype == torch.float32
    leaves = _manifest(tmp_path)["leaves"]
    assert leaves["m/w"]["dtype"] == leaves["m/s"]["dtype"] == "bfloat16"
    assert leaves["v/w"]["dtype"] == "float32" and leaves["step"]["dtype"] == "int32"


def test_reference_cannot_restore_a_bf16_checkpoint(trees, tmp_path):
    """Known reference fault: its restore device_puts the '<V2' void arrays
    np.load returns, which JAX rejects, for its own files and the port's."""
    jparams, _, tparams = trees
    JCheckpointer(tmp_path / "ref").save(STEP, jparams, blocking=True)
    Checkpointer(tmp_path / "port").save(STEP, tparams, blocking=True)
    for src in ("ref", "port"):
        with pytest.raises(TypeError, match="V2 is not a valid JAX array type"):
            JCheckpointer(tmp_path / src).restore(jparams)
