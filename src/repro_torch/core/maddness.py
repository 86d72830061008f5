"""MADDNESS baseline (Blalock & Guttag 2021): hashing-based PQ encoding.

Counterpart of `repro.core.maddness`, the baseline of the paper's Fig. 3b /
Table 4. Instead of an argmin over Euclidean distances, each sub-vector is
encoded by walking a balanced binary regression tree (depth log2(K), one
split dimension per level, one threshold per node). The trees are fitted by
the greedy SSE-reduction heuristic; the prototypes are bucket means. The
encoding is not differentiable, which is the failure LUT-NN's soft-PQ
fixes.

Fitting runs offline in numpy (data-dependent control flow), as in the
reference; encoding and the prototypes run on tensors on the input's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class HashTree(NamedTuple):
    """Per-codebook balanced binary split trees.

    split_dims : (C, L) int32      split dimension per level
    thresholds : (C, L, 2**(L-1))  per-(level, bucket) thresholds (padded)
    """

    split_dims: torch.Tensor
    thresholds: torch.Tensor

    @property
    def depth(self) -> int:
        return self.split_dims.shape[-1]


def _fit_tree_1cb(x: np.ndarray, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Fit one codebook's tree on (N, V) sub-vectors. Greedy: at each level,
    pick the dim whose bucket-median split removes the most SSE."""
    n, v = x.shape
    buckets = np.zeros(n, np.int64)
    split_dims = np.zeros(depth, np.int32)
    thresholds = np.zeros((depth, 2 ** (depth - 1)), np.float32)
    for level in range(depth):
        nb = 2 ** level
        best_dim, best_gain = 0, -np.inf
        best_th = np.zeros(nb, np.float32)
        for dim in range(v):
            gain, ths = 0.0, np.zeros(nb, np.float32)
            col = x[:, dim]
            for b in range(nb):
                m = buckets == b
                if m.sum() < 2:
                    continue
                cb = col[m]
                th = np.median(cb)
                ths[b] = th
                lo, hi = cb[cb <= th], cb[cb > th]
                sse_parent = ((cb - cb.mean()) ** 2).sum()
                sse_kids = sum(((s - s.mean()) ** 2).sum() for s in (lo, hi) if len(s))
                gain += sse_parent - sse_kids
            if gain > best_gain:
                best_dim, best_gain, best_th = dim, gain, ths
        split_dims[level] = best_dim
        thresholds[level, :nb] = best_th[:nb]
        col = x[:, best_dim]
        buckets = buckets * 2 + (col > thresholds[level, buckets]).astype(np.int64)
    return split_dims, thresholds


def fit_hash_trees(acts: np.ndarray, *, k: int, v: int,
                   device: str | torch.device = "cpu") -> HashTree:
    """acts: (N, D) activation samples (numpy) -> trees for C = D // v
    codebooks, as tensors on `device`."""
    depth = int(np.log2(k))
    if 2 ** depth != k:
        raise ValueError(f"MADDNESS needs power-of-two K, got {k}")
    acts = np.asarray(acts)
    n, d = acts.shape
    c = d // v
    sub = acts.reshape(n, c, v)
    dims, ths = zip(*(_fit_tree_1cb(np.asarray(sub[:, i, :], np.float32), depth)
                      for i in range(c)))
    return HashTree(split_dims=torch.from_numpy(np.stack(dims)).to(device),
                    thresholds=torch.from_numpy(np.stack(ths)).to(device))


def maddness_encode(a: torch.Tensor, tree: HashTree, v: int) -> torch.Tensor:
    """Hash-encode (N, D) -> int32 (N, C) bucket indices by walking the trees,
    on a's device."""
    n, d = a.shape
    c = d // v
    sub = a.reshape(n, c, v).float()
    dims = tree.split_dims.to(a.device).long()
    ths = tree.thresholds.to(a.device)
    bucket = torch.zeros((n, c), dtype=torch.long, device=a.device)
    for level in range(tree.depth):
        vals = torch.gather(sub, 2, dims[None, :, level, None].expand(n, c, 1))[:, :, 0]
        th = torch.gather(ths[None, :, level, :].expand(n, -1, -1), 2, bucket[:, :, None])[:, :, 0]
        bucket = bucket * 2 + (vals > th).long()
    return bucket.to(torch.int32)


def bucket_prototypes(acts: torch.Tensor, tree: HashTree, *, k: int, v: int) -> torch.Tensor:
    """Prototypes = per-bucket means (MADDNESS' "centroids"): (C, K, V) on
    acts' device; an empty bucket takes its codebook's mean over all rows.
    The sums run row by row in float32, as numpy's mean over the rows does,
    so the prototypes are the reference's bytewise."""
    idx = maddness_encode(acts, tree, v).long()            # (N, C)
    n, d = acts.shape
    c = d // v
    sub = acts.reshape(n, c, v).float()
    sums = torch.zeros((c, k, v), dtype=torch.float32, device=acts.device)
    total = torch.zeros((c, v), dtype=torch.float32, device=acts.device)
    cbs = torch.arange(c, device=acts.device)
    for i in range(n):
        sums[cbs, idx[i]] += sub[i]
        total += sub[i]
    counts = torch.zeros((c, k), dtype=torch.float32, device=acts.device)
    counts.scatter_add_(1, idx.T, torch.ones((c, n), dtype=torch.float32, device=acts.device))
    means = sums / counts.clamp_min(1.0)[:, :, None]
    return torch.where(counts[:, :, None] > 0, means, (total / n)[:, None, :])
