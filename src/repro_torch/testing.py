"""Helpers for holding the port against the reference: shared inputs made
with numpy from a seed, and the near-tie test that explains a differing code.

Used by tests/test_torch_*.py (which also import the JAX package) and by
chip_smoke.py; this module itself imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pq, quant

# (N, D, M, K, V): N and M ragged against the kernels' tiles, C ragged against
# their codebook chunks (the shapes of tests/test_fused_decode.py)
RAGGED = [
    (33, 64, 70, 16, 8),
    (100, 64, 130, 16, 32),
    (7, 96, 130, 8, 16),
    (65, 160, 48, 16, 32),
    (17, 96, 384, 16, 16),
]
# RAGGED and two shapes whose C (1 and 20) take the cluster sizes the ragged
# C (2..8) do not: the fused and v2 launches use clusters of min(16, C)
# rounded down to a power of two, so C = 5, 6 and 20 do not divide by theirs
CLUSTER_SHAPES = RAGGED + [(9, 32, 70, 16, 32), (33, 640, 144, 16, 32)]
LAYOUTS = ("per_codebook", "per_column", "m_shared", "scalar")
# (C, K, V, M): LUT sites past the kernels' first envelope (V = 64; K = 512,
# codes in two bytes; C = 128 at V = 8), and two K between 256 and 512 whose
# codebook's TMA ring stage splits into two equal boxes of 192 and 150 rows
# (at K = 300 only where a box's bytes stay 128-byte aligned, else the
# lookup gathers from global memory)
WIDE_SITES = [(32, 16, 64, 2048), (64, 512, 32, 2048), (128, 16, 8, 2048),
              (64, 384, 32, 2048), (64, 300, 32, 2048)]


def make_amm_inputs(n: int, d: int, m: int, k: int, v: int, seed: int):
    """x (N, D), centroids (C, K, V), real table (C, K, M), bias (M,): float32
    numpy arrays from one seed."""
    rng = np.random.default_rng(seed)
    c = d // v
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((c, k, v), dtype=np.float32),
            rng.standard_normal((c, k, m), dtype=np.float32),
            rng.standard_normal((m,), dtype=np.float32))


def quantize_np(table: np.ndarray, layout: str) -> tuple[np.ndarray, np.ndarray]:
    """(int8 table, fp32 scale) in one of LAYOUTS. "scalar" is one (1, 1, 1)
    scale over the whole table, the layout the kernels accept beside m-shared."""
    t = torch.from_numpy(table)
    if layout == "scalar":
        scale = torch.clamp(t.abs().amax().float(), min=1e-8).reshape(1, 1, 1) / 127.0
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        return q.numpy(), scale.numpy()
    qt = quant.quantize_table(t, per_column=layout == "per_column",
                              m_shared=layout == "m_shared")
    return qt.q.numpy(), qt.scale.numpy()


def tie_gaps(x: torch.Tensor, centroids: torch.Tensor, codes_a: torch.Tensor,
             codes_b: torch.Tensor) -> torch.Tensor:
    """For every (n, c) where two encodings disagree, |d(a) - d(b)| / (1 + |d(a)|)
    with d the fp32 distances: how close the two choices were to a tie.
    Empty when the codes agree."""
    dists = pq.pairwise_sq_dists(pq.split_subvectors(x.float(), centroids.shape[-1]),
                                 centroids.float())
    codes_a = codes_a.long().to(dists.device)
    codes_b = codes_b.long().to(dists.device)
    diff = codes_a != codes_b
    da = dists.gather(-1, codes_a[..., None])[..., 0][diff]
    db = dists.gather(-1, codes_b[..., None])[..., 0][diff]
    return (da - db).abs() / (1.0 + da.abs())


def rows_near_tie(x: torch.Tensor, centroids: torch.Tensor, eps: float) -> torch.Tensor:
    """(N,) bool: rows whose best and second-best fp32 distance in some
    codebook are within eps * (1 + |best|): rows where an fp32 summation
    order other than the plain version's may pick another code."""
    dists = pq.pairwise_sq_dists(pq.split_subvectors(x.float(), centroids.shape[-1]),
                                 centroids.float())
    two = torch.topk(dists, 2, dim=-1, largest=False).values
    gap = (two[..., 1] - two[..., 0]) / (1.0 + two[..., 0].abs())
    return (gap <= eps).any(dim=-1)
