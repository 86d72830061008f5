"""Carry model params between the reference's layout and the port's.

The JAX package keeps each segment's layers stacked on a leading axis (it
scans over them); the port keeps a list of per-layer dicts. `params_from_numpy`
takes the reference's param tree with every leaf a numpy array (as
`jax.tree.map(np.asarray, params)` gives it) or a CPU tensor, unstacks the
layer axis and places each leaf on `device` with its dtype unchanged: int8
tables stay int8, and bfloat16 leaves (ml_dtypes arrays or bfloat16 tensors)
keep their bits. `params_to_numpy` is its inverse. It imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """A dtype-exact copy of one numpy array (or tensor) on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True).contiguous()
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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A dtype-exact host copy; a bfloat16 tensor comes back as its uint16
    bit patterns (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def params_to_numpy(bundle, params: dict[str, Any]) -> dict[str, Any]:
    """The port's params -> the reference's param tree of `bundle`: each
    segment's per-layer dicts stacked on a leading axis, every leaf a numpy
    array (bfloat16 as uint16 bit patterns, see `tensor_to_numpy`)."""
    out: dict[str, Any] = {
        "embed": _map(params["embed"], tensor_to_numpy),
        "final_norm": _map(params["final_norm"], tensor_to_numpy),
        "segments": [],
    }
    for layers, (count, _) in zip(params["segments"], bundle.cfg.segments):
        if len(layers) != count:
            raise ValueError(f"segment has {len(layers)} layers, the bundle {count}")

        def stack(path: tuple[str, ...], layers=layers) -> np.ndarray:
            leaves = []
            for layer in layers:
                node = layer
                for k in path:
                    node = node[k]
                leaves.append(node)
            return tensor_to_numpy(torch.stack(leaves))

        out["segments"].append(_map_paths(layers[0], stack, ()))
    if "lm_head" in params:
        out["lm_head"] = _map(params["lm_head"], tensor_to_numpy)
    return out


def _map_paths(tree: Any, fn, path: tuple[str, ...]) -> Any:
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path)
