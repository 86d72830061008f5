"""Sharding rules: the partition spec of every param, optimizer, cache and
batch leaf.

Counterpart of `repro.distributed.sharding`, for the port's tensor-parallel
serving and data-parallel training. The mesh axes are ("data", "model") (`launch/mesh.py`); "model" is
the tensor-parallel axis. A spec is a tuple with one entry per dim of the
leaf: None (replicated over the mesh), an axis name, or a tuple of axis
names. `ShardingRules` is a pure function of (path, shape) and the mesh's
axis sizes, and gives the reference's `PartitionSpec` entries exactly:

  TP   a weight's output dim over "model" (column-parallel); the LUT table
       column-sharded over M, the one-hot contraction column-parallel like
       the matmul it replaces, the codebooks replicated. The sites that
       consume a column-parallel producer's sharded output ('o', 'down',
       'out_proj': `site_roles`) shard their INPUT dim instead (row-parallel:
       weight rows, the table's and the centroids' codebook axis).
  EP   an MoE expert dim over the data axes, else over "model"
  SP   the dense KV cache's sequence axis over "model"; the paged pool's KV
       heads over "model"
  DP   the batch dim of every input over "data" (`batch_shardings`)
  FSDP (`fsdp=True`) weights and tables also over "data": a rank holds its
       part, the forward gathers it per block (`data_parallel.py`)
  ZeRO-1 (`zero1=True`, the default) the AdamW moments over "data" even where
       the params are replicated (`opt_spec`)

Only a dim divisible by its axis size is sharded; the rules take the first
divisible candidate and otherwise replicate. The defaults are the
reference's (row-parallel roles on, no FSDP, ZeRO-1 on). The data-parallel
train step (`distributed/data_parallel.py`) places each rank's moments by
`opt_spec`, inside its model shard on a (data, model) mesh, where the
training layout (`tensor_parallel.layout(train=True)`) cuts each param by
`param_spec`; under `fsdp=True` that layout also cuts each param the spec
splits over "data" (`tensor_parallel.Layout.fsdp`), which the forward
gathers per block (`models/sharded.py`).

How a rank of the port's tensor-parallel engine holds and runs its shards
follows these specs (`distributed/tensor_parallel.py`), with the kept
differences named there (`Layout.kept`). The engine's layout reads
`param_spec` for every site pair, the embedding, the experts and the SSM
blocks, and `site_roles`; where it departs from a spec (the experts over
"model" at data = 1, the mamba2 block's head-aligned in_proj and conv
selections) the difference is named and tested against these rules
(tests/test_torch_tp_families.py). The caches follow `cache_spec`'s
rules where they are the engine's: the paged pool by KV heads, the SSM
state by heads; the dense KV cache by KV heads (the spec: its sequence)
and the conv window by the rank's channels (the spec: contiguous
channels) are kept differences. The engine serves data = 1 meshes only.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.weights import reference_leaves, tree_map_ref

Spec = tuple

# site kinds that consume a column-parallel producer's sharded output: they
# shard their INPUT dim (Megatron's row-parallel role)
ROW_PARALLEL_LEAF_KINDS = ("down", "o", "out_proj")

# path segments under which leaves are stacked over layers
_STACK_SEGMENTS = ("segments/", "mamba_stack/", "encoder/", "decoder/")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Specs on a ("data", "model") mesh of `data` x `model` ranks."""

    model: int = 1
    data: int = 1
    fsdp: bool = False           # weights over "data" too (ZeRO-3 style)
    zero1: bool = True           # optimizer moments over "data"

    @classmethod
    def for_mesh(cls, mesh: Any, **kw: Any) -> "ShardingRules":
        """The rules of a mesh with a `shape` mapping ({"data": d, "model": m})."""
        return cls(model=mesh.shape["model"], data=mesh.shape.get("data", 1), **kw)

    @property
    def tp(self) -> int:
        return self.model

    def _axsize(self, axis: str) -> int:
        return {"data": self.data, "model": self.model}[axis]

    def batch_dim(self, b: int):
        """Spec entry of a global-batch dim (None when it does not divide)."""
        return "data" if b % self.data == 0 else None

    # ------------------------------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...],
                   site_roles: dict[str, bool] | None = None) -> Spec:
        """Spec of one param leaf of the reference's (layer-stacked) tree.
        `site_roles` maps site paths to their row-parallel role
        (`site_roles(bundle)`); without it the parent's name decides."""
        name = path.split("/")[-1]
        off = 1 if is_stacked(path) else 0
        spec: list[Any] = [None] * len(shape)
        eff = shape[off:]

        def put(i_eff: int, axis: str) -> bool:
            if spec[off + i_eff] is None and eff[i_eff] % self._axsize(axis) == 0:
                spec[off + i_eff] = axis
                return True
            return False

        def put_fsdp(prefer: tuple[int, ...]) -> None:
            if not self.fsdp:
                return
            for i in prefer:
                if spec[off + i] is None and eff[i] % self.data == 0:
                    spec[off + i] = "data"
                    return

        parts = path.split("/")
        parent_path = "/".join(parts[:-1])
        if site_roles is not None and parent_path in site_roles:
            row_parallel = site_roles[parent_path]
        else:
            row_parallel = len(parts) >= 2 and parts[-2] in ROW_PARALLEL_LEAF_KINDS

        if name == "table" and len(eff) == 2:            # embedding (vocab, d)
            put(0, "model") or put(1, "model")
            put_fsdp((1, 0))
        elif name == "w" and len(eff) == 2:              # linear (d_in, d_out)
            if row_parallel:
                put(0, "model") or put(1, "model")
            else:
                put(1, "model") or put(0, "model")
            put_fsdp((0, 1) if not row_parallel else (1, 0))
        elif name == "w" and len(eff) == 3:              # experts (E, d_in, d_out)
            put(0, "data") or put(0, "model")
            if spec[off + 0] == "data":
                put(2, "model") or put(1, "model")
        elif name == "table_q" and len(eff) == 3:        # LUT (C, K, M)
            if row_parallel:
                put(0, "model") or put(2, "model")
            else:
                put(2, "model")
            put_fsdp((0,) if not row_parallel else (2,))
        elif name == "table_q" and len(eff) == 4:        # MoE LUT (E, C, K, M)
            put(0, "data") or put(0, "model")
            if spec[off + 0] == "data":
                put(3, "model")
        elif name == "centroids" and len(eff) == 3 and row_parallel:
            put(0, "model")                               # aligns with C-sharded inputs
        # table_scale (tiny), other centroids, log_t, norms, conv, ssm
        # scalars: replicated
        return tuple(spec)

    # ------------------------------------------------------------------
    def opt_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """An AdamW moment of the param at `path` (its reference stacked
        shape): the param's spec plus ZeRO-1's "data" on the first free dim
        that divides; the step counter and a frozen leaf's empty (0,)
        placeholder are replicated."""
        if tuple(shape) == (0,) or path.endswith("step"):
            return ()                                     # the reference's P()
        base = list(self.param_spec(path, shape))
        if self.zero1 and not self.fsdp and "data" not in base:
            for i, s in enumerate(base):
                if s is None and shape[i] % self.data == 0 and shape[i] > 1:
                    base[i] = "data"
                    break
        return tuple(base)

    def opt_shardings(self, opt_state: Any) -> Any:
        """The spec of every leaf of an AdamWState in the port's layout, as a
        tree of its structure: each leaf takes `opt_spec` of its param's
        reference path (the state's own key, ".m" or ".v", stripped) and
        stacked shape."""
        counts = {p: len(leaves) for p, leaves in reference_leaves(opt_state).items()}

        def spec(path: str, leaf) -> Spec:
            shape = tuple(leaf.shape)
            if is_stacked(path) and shape != (0,):
                shape = (counts[path], *shape)
            return self.opt_spec(path.split("/", 1)[1] if "/" in path else path, shape)

        return tree_map_ref(spec, opt_state)

    def batch_shardings(self, batch: dict[str, Any]) -> dict[str, Spec]:
        """{key: spec} of a global batch (leaves with a `shape`): dim 0 over
        "data" where it divides, M-RoPE's pos (3, B, S) on its second axis."""
        out: dict[str, Spec] = {}
        for k, v in batch.items():
            shape = tuple(v.shape)
            if k == "pos" and len(shape) == 3:
                out[k] = (None, self.batch_dim(shape[1]), None)
            elif shape:
                out[k] = (self.batch_dim(shape[0]),) + (None,) * (len(shape) - 1)
            else:
                out[k] = ()
        return out

    # ------------------------------------------------------------------
    def cache_spec(self, path: str, shape: tuple[int, ...], batch: int) -> Spec:
        """KV / SSM caches: a layer-stacked leading dim, then the batch."""
        name = path.split("/")[-1]
        bspec = self.batch_dim(batch)
        if name in ("k_pool", "v_pool") and len(shape) == 5:
            # (L, n_pages, page_size, KV, Dh): pages take the slot axis' place
            # as the data-parallel dim, KV heads over "model"
            pages = "data" if shape[1] % self.data == 0 else None
            kvh = "model" if shape[3] % self.tp == 0 else None
            return (None, pages, None, kvh, None)
        if name in ("k", "v") and len(shape) == 5:       # (L, B, S, KV, Dh)
            seq = "model" if shape[2] % self.tp == 0 else None
            return (None, bspec, seq, None, None)
        if name == "ssm":                                # (L, B, H, P, N)
            hd = "model" if shape[2] % self.tp == 0 else None
            return (None, bspec, hd, None, None)
        if name == "conv":                               # (L, B, W-1, ch)
            ch = "model" if shape[3] % self.tp == 0 else None
            return (None, bspec, None, ch)
        return (None,) * len(shape)


def is_stacked(path: str) -> bool:
    """Whether a reference path names a leaf stacked over layers."""
    return any(seg in path for seg in _STACK_SEGMENTS)


def site_roles(bundle: Any) -> dict[str, bool]:
    """{site param-tree path: is row-parallel} from the bundle's site registry."""
    return {s.path: s.kind.rsplit("/", 1)[-1] in ROW_PARALLEL_LEAF_KINDS
            for s in bundle.sites()}
