"""The reference's leaf-path convention for param trees, without JAX.

Counterpart of `repro.checkpoint.checkpointer.tree_paths` / `flatten_tree`:
every leaf of a tree of dicts and lists is named by the slash-joined keys and
indices that lead to it ("segments/1/attn/q/table_q"), in the order
`jax.tree_util.tree_flatten` visits them: dict keys sorted, list items in
order. Checkpoints and deployment artifacts key their arrays by these paths.

The reference keeps each segment's layers stacked on a leading axis, the
port keeps a list of per-layer dicts; `weights.params_from_numpy` and
`weights.params_to_numpy` convert between the two layouts, so the paths here
are always those of the reference's stacked tree.
"""

from __future__ import annotations

from typing import Any, Iterator

# NamedTuple types that are tree nodes (their fields named ".<field>", in
# field order, as jax names a namedtuple's children); any other NamedTuple,
# such as a ParamSpec, is a leaf
NODE_TUPLES: list[type] = []


def register_node(cls: type) -> type:
    NODE_TUPLES.append(cls)
    return cls


def is_node_tuple(tree: Any) -> bool:
    return type(tree) in NODE_TUPLES


def _walk(tree: Any, prefix: tuple[str, ...]) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif is_node_tuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), prefix + ("." + name,))
    elif type(tree) in (list, tuple):           # a NamedTuple (ParamSpec) is a leaf
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def tree_paths(tree: Any) -> list[str]:
    """Slash-joined path of every leaf, in the reference's flatten order."""
    return [p for p, _ in _walk(tree, ())]


def flatten_tree(tree: Any) -> dict[str, Any]:
    """{path: leaf} in the reference's flatten order."""
    return dict(_walk(tree, ()))


def unflatten_tree(flat: dict[str, Any]) -> Any:
    """The tree of `flatten_tree`'s output: a node whose keys are all
    indices 0..n-1 becomes a list, any other node a dict."""
    root: dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and sorted(out) == sorted(str(i) for i in range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def treedef_string(tree: Any) -> str:
    """The tree's structure as `str(jax.tree_util.tree_structure(tree))`
    prints it, which artifact manifests and checkpoints record (for reading
    only)."""
    def fmt(node: Any) -> str:
        if is_node_tuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(fmt(v) for v in node) + "])")
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}" for k in sorted(node)) + "}"
        if type(node) in (list, tuple):
            return "[" + ", ".join(fmt(v) for v in node) + "]"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
