"""Carry model params between the reference's layout and the port's.

The JAX package keeps each segment's layers (and the hybrid's mamba layers,
"mamba_stack", and the enc-dec's "encoder" and "decoder" layers) stacked on
a leading axis (it scans over them); the port keeps a list of per-layer
dicts. `params_from_numpy`
takes the reference's param tree with every leaf a numpy array (as
`jax.tree.map(np.asarray, params)` gives it) or a CPU tensor, unstacks the
layer axis and places each leaf on `device` with its dtype unchanged: int8
tables stay int8, and bfloat16 leaves (ml_dtypes arrays or bfloat16 tensors)
keep their bits. `params_to_numpy` is its inverse. Both take LUT_TRAIN trees (a scalar
`log_t` per layer stacks to an (L,) leaf) and AdamW moment trees, whose
frozen leaves are empty (0,) tensors: the reference keeps one (0,) leaf for
a whole stacked frozen weight, the port one per layer.

`tree_map_ref`, `reference_arrays` and `tree_from_reference` do the same for
any tree of the port's layout (train state: params, AdamW state): each leaf
named by its path in the reference's stacked tree, which is what
checkpoints are keyed by and what optimizer rules match. It imports no JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.paths import flatten_tree, is_node_tuple, unflatten_tree
from repro_torch.device import resolve_device


def is_bf16_bits(a: np.ndarray) -> bool:
    """Whether a host array holds bfloat16 values under another name: an
    ml_dtypes bfloat16 array, or the 2-byte void ('<V2') that a checkpoint
    file's bfloat16 member reads back as without ml_dtypes."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def tensor_from_numpy(a: Any, device: torch.device, *, bf16: bool = False) -> torch.Tensor:
    """A dtype-exact copy of one numpy array (or tensor) on `device`. With
    `bf16`, uint16 bit patterns (the port's older checkpoint files) are read
    as the bfloat16 values they hold."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True).contiguous()
    a = np.array(a)                          # own, writable, contiguous
    if is_bf16_bits(a) or (bf16 and a.dtype == np.uint16):   # numpy has no bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# the top-level keys of a layer stack that is not under "segments", and the
# config field that counts its layers
_STACKS = {"mamba_stack": "n_layers", "encoder": "n_enc_layers", "decoder": "n_dec_layers"}


def _stack_count(bundle, path: str) -> int:
    """Layers a stacked reference path is stacked over."""
    parts = path.split("/")
    if parts[0] in _STACKS:
        return getattr(bundle.cfg, _STACKS[parts[0]])
    return bundle.cfg.segments[int(parts[1])][0]


def _check_segments(bundle, tree: dict[str, Any]) -> None:
    if len(tree["segments"]) != len(bundle.cfg.segments):
        raise ValueError(f"tree has {len(tree['segments'])} segments, the bundle "
                         f"{len(bundle.cfg.segments)}")


def _check_layers(bundle, params: dict[str, Any]) -> None:
    """The port's per-layer lists against the bundle's layer counts."""
    if bundle.kind != "lm":
        got = [(len(params[key]), getattr(bundle.cfg, field))
               for key, field in _STACKS.items() if key in params]
    else:
        _check_segments(bundle, params)
        got = [(len(layers), count) for layers, (count, _) in zip(params["segments"],
                                                                  bundle.cfg.segments)]
    for have, want in got:
        if have != want:
            raise ValueError(f"a layer stack has {have} layers, the bundle {want}")


def params_from_numpy(bundle, tree: dict[str, Any], *,
                      device: str | torch.device | None = None) -> dict[str, Any]:
    """The reference param tree of `bundle` (numpy leaves) -> the port's params."""
    if bundle.kind == "lm":
        _check_segments(bundle, tree)
    flat = flatten_tree(tree)
    for path, a in flat.items():
        if is_stacked(path) and tuple(a.shape) != (0,):
            count = _stack_count(bundle, path)
            if a.shape[0] != count:
                raise ValueError(f"{path} of shape {tuple(a.shape)} is not stacked over "
                                 f"{count} layers")
    return tree_from_reference(layer_specs(bundle), flat, device=device)


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
    _check_layers(bundle, params)
    return unflatten_tree(reference_arrays(params))


def _stack_to_numpy(leaves: list[torch.Tensor]) -> np.ndarray:
    """One reference leaf from the per-layer tensors of a segment; the empty
    (0,) moments of a frozen weight stay one (0,) leaf, as in the reference."""
    if all(tuple(t.shape) == (0,) for t in leaves):
        return tensor_to_numpy(leaves[0])
    return tensor_to_numpy(torch.stack([t.detach() for t in leaves]))


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def tree_map_ref(fn: Callable, tree: Any, *rest: Any, _path: str = "") -> Any:
    """Map `fn(path, leaf, *rest_leaves)` over a tree of the port's layout
    (and trees of the same structure), where `path` is the leaf's path in the
    reference's stacked tree: a segment's per-layer dicts drop their layer
    index, so every layer of a stacked leaf gets the same path. Returns the
    tree of results; leaves are visited in the reference's flatten order
    within each segment layer."""
    if isinstance(tree, dict):
        return {k: tree_map_ref(fn, tree[k], *(r[k] for r in rest), _path=_join(_path, str(k)))
                for k in sorted(tree)}
    if is_node_tuple(tree):
        return type(tree)(*(tree_map_ref(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                                         _path=_join(_path, "." + f)) for f in tree._fields))
    if type(tree) in (list, tuple):
        last = _path.rsplit("/", 1)[-1]
        if last == "segments" and tree and type(tree[0]) is list:
            return [[tree_map_ref(fn, layer, *(r[i][j] for r in rest), _path=_join(_path, str(i)))
                     for j, layer in enumerate(layers)] for i, layers in enumerate(tree)]
        if last in _STACKS:
            return [tree_map_ref(fn, layer, *(r[j] for r in rest), _path=_path)
                    for j, layer in enumerate(tree)]
        return [tree_map_ref(fn, v, *(r[i] for r in rest), _path=_join(_path, str(i)))
                for i, v in enumerate(tree)]
    return fn(_path, tree, *rest)


def is_stacked(path: str) -> bool:
    """Whether a reference path names a leaf stacked over layers (a segment's,
    the hybrid's mamba stack, the enc-dec's encoder or decoder), at the root
    of a param tree or inside a train state's ("params/...", "opt/.m/...")."""
    return any(part == "segments" or part in _STACKS for part in path.split("/"))


def reference_leaves(tree: Any) -> dict[str, list]:
    """{reference path: [its leaves in the port's tree]}, in the reference's
    flatten order: one leaf per layer for a stacked path, else one."""
    groups: dict[str, list] = {}
    tree_map_ref(lambda p, leaf: groups.setdefault(p, []).append(leaf), tree)
    return groups


def reference_arrays(tree: Any) -> dict[str, np.ndarray]:
    """{reference path: dtype-exact host array} of a tree of the port's layout
    (tensor leaves): the flat form of the reference's stacked tree."""
    return {p: _stack_to_numpy(leaves) if is_stacked(p) else tensor_to_numpy(leaves[0])
            for p, leaves in reference_leaves(tree).items()}


def flat_vector(tree: Any) -> torch.Tensor:
    """Every tensor leaf of a port-layout tree as fp32, concatenated in the
    reference's flatten order (a layer stack's leaf whole, layer-major);
    None leaves (a frozen leaf's gradient) add nothing."""
    return torch.cat([leaf.float().reshape(-1) for leaves in reference_leaves(tree).values()
                      for leaf in leaves if leaf is not None])


def unflatten_vector(vec: torch.Tensor, like: Any) -> Any:
    """`flat_vector`'s inverse: `like`'s tree with each tensor leaf's values
    from `vec` (views where the dtype is `vec`'s), None where `like` has None."""
    parts: dict[str, list] = {}
    off = 0
    for path, leaves in reference_leaves(like).items():
        for leaf in leaves:
            if leaf is None:
                parts.setdefault(path, []).append(None)
                continue
            parts.setdefault(path, []).append(
                vec[off:off + leaf.numel()].view(leaf.shape).to(leaf.dtype))
            off += leaf.numel()
    cursors = {p: iter(v) for p, v in parts.items()}
    return tree_map_ref(lambda p, _leaf: next(cursors[p]), like)


def tree_from_reference(like: Any, arrays: Mapping[str, Any], *,
                        device: str | torch.device | None = None, cuts: Any = None) -> Any:
    """The tree of `like`'s structure (port layout; leaves tensors or
    ParamSpecs) holding `arrays[path]` for each reference path: a stacked
    array is split over the layers (an empty (0,) one gives each layer an
    empty leaf). Each leaf goes to the device of the tensor it replaces, or
    to `device` (the card unless the caller asks for the CPU). A leaf whose
    `like` is bfloat16 takes bfloat16 bits stored as such, as a 2-byte void
    or as uint16. `cuts`, a tree of `like`'s structure, keeps only the part
    `cut.apply(array)` of each leaf (a data rank's ZeRO-1 shard,
    `distributed.data_parallel.Cut`)."""
    dev = None
    cursors: dict[str, int] = {}
    counts = {p: len(leaves) for p, leaves in reference_leaves(like).items()}
    held: dict[str, Any] = {}      # a stacked array, read once for all its layers
    if cuts is None:
        cuts = tree_map_ref(lambda _p, _leaf: None, like)

    def take(path: str, leaf: Any, cut: Any) -> torch.Tensor:
        nonlocal dev
        if isinstance(leaf, torch.Tensor):
            target = leaf.device
        else:
            dev = dev if dev is not None else resolve_device(device)
            target = dev
        a = held[path] if path in held else arrays[path]
        if is_stacked(path) and tuple(a.shape) != (0,):
            j = cursors.get(path, 0)
            cursors[path] = j + 1
            if j + 1 < counts[path]:
                held[path] = a
            else:
                held.pop(path, None)
            a = a[j]
        if cut is not None:
            a = cut.apply(a)
        return tensor_from_numpy(a, target, bf16=leaf.dtype == torch.bfloat16)

    return tree_map_ref(take, like, cuts)


def layer_specs(bundle) -> dict[str, Any]:
    """The bundle's params as ParamSpecs in the port's layout (a list of
    per-layer spec dicts per segment), without allocating them: the `like`
    of a restore."""
    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()}
        return type(tree)(tuple(tree.shape[1:]), tree.dtype)

    specs = dict(bundle.param_specs())
    if bundle.kind != "lm":
        for key in _STACKS.keys() & specs.keys():
            specs[key] = [strip(specs[key])] * _stack_count(bundle, key)
    else:
        specs["segments"] = [[strip(seg)] * count
                             for seg, (count, _) in zip(specs["segments"], bundle.cfg.segments)]
    return specs


def first_layers(params: dict[str, Any]) -> dict[str, Any]:
    """The tree with each layer stack replaced by its first layer: the
    reference's paths, with one layer's leaves (their dtypes, say)."""
    if "segments" not in params:
        return dict(params, **{key: params[key][0] for key in _STACKS.keys() & params.keys()})
    return dict(params, segments=[layers[0] for layers in params["segments"]])
