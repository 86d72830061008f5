"""Sharding rules: the partition spec of every param, cache and batch leaf.

Counterpart of `repro.distributed.sharding` for the port's tensor-parallel
serving. The mesh axes are ("data", "model") (`launch/mesh.py`); "model" is
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

Only a dim divisible by its axis size is sharded; the rules take the first
divisible candidate and otherwise replicate. The reference's defaults are
the port's rules (row-parallel roles on, no FSDP); its `fsdp` variant and
the optimizer specs (`opt_spec`, ZeRO-1) are not ported: they come with the
sharded train step.

How a rank of the port's tensor-parallel engine holds and runs its shards
follows these specs (`distributed/tensor_parallel.py`), with the kept
differences named there. The engine's path reads `param_spec` (the dense
blocks' sites and the embedding) and `site_roles`. `cache_spec`,
`batch_dim` and `param_spec`'s expert, SSM and conv branches are held
against the reference by the tests only, until the MoE and training slices
place by them: the engine splits its KV caches by heads itself, which is
`cache_spec` for the paged pool and a kept difference for the dense cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any

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

    @classmethod
    def for_mesh(cls, mesh: Any) -> "ShardingRules":
        """The rules of a mesh with a `shape` mapping ({"data": d, "model": m})."""
        return cls(model=mesh.shape["model"], data=mesh.shape.get("data", 1))

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
        stacked = any(seg in path for seg in _STACK_SEGMENTS)
        off = 1 if stacked else 0
        spec: list[Any] = [None] * len(shape)
        eff = shape[off:]

        def put(i_eff: int, axis: str) -> bool:
            if spec[off + i_eff] is None and eff[i_eff] % self._axsize(axis) == 0:
                spec[off + i_eff] = axis
                return True
            return False

        parts = path.split("/")
        parent_path = "/".join(parts[:-1])
        if site_roles is not None and parent_path in site_roles:
            row_parallel = site_roles[parent_path]
        else:
            row_parallel = len(parts) >= 2 and parts[-2] in ROW_PARALLEL_LEAF_KINDS

        if name == "table" and len(eff) == 2:            # embedding (vocab, d)
            put(0, "model") or put(1, "model")
        elif name == "w" and len(eff) == 2:              # linear (d_in, d_out)
            if row_parallel:
                put(0, "model") or put(1, "model")
            else:
                put(1, "model") or put(0, "model")
        elif name == "w" and len(eff) == 3:              # experts (E, d_in, d_out)
            put(0, "data") or put(0, "model")
            if spec[off + 0] == "data":
                put(2, "model") or put(1, "model")
        elif name == "table_q" and len(eff) == 3:        # LUT (C, K, M)
            if row_parallel:
                put(0, "model") or put(2, "model")
            else:
                put(2, "model")
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


def site_roles(bundle: Any) -> dict[str, bool]:
    """{site param-tree path: is row-parallel} from the bundle's site registry."""
    return {s.path: s.kind.rsplit("/", 1)[-1] in ROW_PARALLEL_LEAF_KINDS
            for s in bundle.sites()}
