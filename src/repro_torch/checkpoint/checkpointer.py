"""Checkpoints with a background save and an atomic commit, in the
reference's format.

Counterpart of `repro.checkpoint.checkpointer`. One directory per step:

  <dir>/step_00000123/
      manifest.json      tree structure, shapes, dtypes, step
      arrays.npz         every leaf, keyed by its path in the reference's
                         stacked tree (checkpoint.paths)

The port's trees (segments as per-layer dicts, AdamW moments with one empty
(0,) tensor per frozen layer) are written as the reference's stacked arrays
and split again on restore (`weights.reference_arrays`,
`weights.tree_from_reference`), so a checkpoint of params and AdamW state
written by either package restores in the other.

  * save() copies the tree to host memory, then writes it on a background
    thread: the training loop does not wait for the disk;
  * the commit is atomic (write step_X.tmp, then os.replace), so a crash
    mid-write never leaves a half-readable checkpoint; restore() takes the
    newest committed step;
  * keep_last bounds the disk used.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.paths import treedef_string, unflatten_tree
from repro_torch.weights import reference_arrays, tree_from_reference


def atomic_write_json(path: str | os.PathLike, obj: Any) -> None:
    """Write JSON with the checkpoints' tmp-then-os.replace discipline: a
    crash mid-write never leaves a half-readable file."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, sort_keys=True))
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, *, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Any, *, blocking: bool = False, on_commit=None) -> None:
        """Copy `tree` (port layout, tensor leaves) to host memory now, write it
        in the background (unless blocking). `on_commit(step)` runs on the
        writer thread right after the commit; its exceptions are swallowed
        (a hook must never fail a committed checkpoint)."""
        flat = reference_arrays(tree)
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(step, flat, on_commit),
                                        daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict[str, np.ndarray], on_commit=None) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": step,
            "treedef": treedef_string(unflatten_tree(flat)),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        if on_commit is not None:
            try:
                on_commit(step)
            except Exception:       # noqa: BLE001 — never fail a committed save
                pass
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: int | None = None,
                device: str | torch.device | None = None) -> tuple[int, Any]:
        """Restore into the structure of `like` (port layout; leaves tensors,
        whose devices the restored leaves take, or ParamSpecs, whose leaves go
        to `device`: the card unless the caller asks for the CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self.dir / f"step_{step:08d}" / "arrays.npz") as data:
            return step, tree_from_reference(like, data, device=device)
