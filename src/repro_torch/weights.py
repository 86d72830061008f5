"""Carry model params from numpy arrays into the port's layout.

The JAX package keeps each segment's layers stacked on a leading axis (it
scans over them); the port keeps a list of per-layer dicts. `params_from_numpy`
takes the reference's param tree with every leaf a numpy array (as
`jax.tree.map(np.asarray, params)` gives it), unstacks the layer axis and
places each leaf on `device` with its dtype unchanged: int8 tables stay int8,
and bfloat16 leaves (ml_dtypes arrays) keep their bits. It imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """A dtype-exact copy of one numpy array on `device`."""
    a = np.array(a)                          # own, writable, contiguous
    if a.dtype.name == "bfloat16":           # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(bundle, tree: dict[str, Any], *,
                      device: str | torch.device | None = None) -> dict[str, Any]:
    """The reference param tree of `bundle` (numpy leaves) -> the port's params."""
    device = resolve_device(device)
    segs = tree["segments"]
    if len(segs) != len(bundle.cfg.segments):
        raise ValueError(f"tree has {len(segs)} segments, the bundle {len(bundle.cfg.segments)}")
    out: dict[str, Any] = {
        "embed": _map(tree["embed"], lambda a: tensor_from_numpy(a, device)),
        "final_norm": _map(tree["final_norm"], lambda a: tensor_from_numpy(a, device)),
        "segments": [],
    }
    for seg, (count, _) in zip(segs, bundle.cfg.segments):
        layers = []
        for j in range(count):
            def take(a, j=j):
                if a.shape[0] != count:
                    raise ValueError(f"leaf of shape {a.shape} is not stacked over {count} layers")
                return tensor_from_numpy(a[j], device)
            layers.append(_map(seg, take))
        out["segments"].append(layers)
    if "lm_head" in tree:
        out["lm_head"] = _map(tree["lm_head"], lambda a: tensor_from_numpy(a, device))
    return out
