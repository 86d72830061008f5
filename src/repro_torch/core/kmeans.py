"""k-means (Lloyd) with k-means++ seeding, for centroid init, in PyTorch.

Counterpart of `repro.core.kmeans`. The paper initializes the soft-PQ
centroids by k-means over activations the original model produces on
~1024 training samples (section 6.1, Eq. 1), one problem per codebook. As the
reference vmaps Lloyd over the C codebooks, every function here takes a
batch of problems, (C, N, V), and runs them together: a layer initializes in
one pass of `iters` steps, with no loop over codebooks.

Seeding draws from a `torch.Generator` (the reference's JAX keys have no
torch counterpart), so seeds differ from the reference's; Lloyd from the
same `init=` centers follows it.
"""

from __future__ import annotations

import torch


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, N, V), (B, K, V) -> (B, N, K) squared distances, fp32."""
    x = x.float()
    c = c.float()
    return ((x * x).sum(-1)[..., :, None] - 2.0 * x @ c.transpose(-1, -2)
            + (c * c).sum(-1)[..., None, :])


def _uniform(gen: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.rand((n,), generator=gen, device=gen.device).to(device)


def kmeans_plusplus(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding of each problem: (B, N, V) -> (B, K, V). Each next
    center is drawn with probability proportional to its squared distance to
    the closest center chosen so far (inverse CDF of one uniform per problem,
    as jax.random.choice draws)."""
    b, n, _ = x.shape
    rows = torch.arange(b, device=x.device)
    first = (_uniform(gen, b, x.device) * n).long().clamp_max(n - 1)
    centers = [x[rows, first]]
    min_d = _sq_dists(x, centers[0][:, None, :])[..., 0].clamp_min(0.0)    # (B, N)
    for _ in range(1, k):
        cum = torch.cumsum(min_d, dim=-1)
        total = cum[:, -1:]
        u = _uniform(gen, b, x.device)[:, None]
        # all points on the chosen centers: draw uniformly
        r = torch.where(total > 0, total * (1.0 - u), (1.0 - u) * n)
        cum = torch.where(total > 0, cum, torch.arange(1, n + 1, device=x.device,
                                                       dtype=cum.dtype).expand(b, n))
        idx = torch.searchsorted(cum, r).clamp_max(n - 1)[:, 0]
        c_new = x[rows, idx]
        centers.append(c_new)
        min_d = torch.minimum(min_d, _sq_dists(x, c_new[:, None, :])[..., 0].clamp_min(0.0))
    return torch.stack(centers, dim=1)


def kmeans(gen: torch.Generator | None, x: torch.Tensor, *, k: int, iters: int = 25,
           init: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm on each problem: x (B, N, V) -> (centroids (B, K, V),
    inertia (B,)). Starts from `init` (B, K, V) when given, else from
    k-means++ seeds drawn from `gen`.

    An empty cluster is reseeded at the point worst represented by its
    assigned centroid, which keeps all K codes live: the LUT kernels assume a
    dense codebook."""
    x = x.float()
    centers = init.float() if init is not None else kmeans_plusplus(gen, x, k)
    rows = torch.arange(x.shape[0], device=x.device)
    for _ in range(iters):
        d = _sq_dists(x, centers)                                  # (B, N, K)
        onehot = torch.nn.functional.one_hot(d.argmin(-1), k).float()
        counts = onehot.sum(1)                                     # (B, K)
        sums = onehot.transpose(1, 2) @ x                          # (B, K, V)
        new = sums / counts.clamp_min(1.0)[..., None]
        worst = x[rows, d.min(-1).values.argmax(-1)]               # (B, V)
        centers = torch.where((counts > 0)[..., None], new, worst[:, None, :])
    inertia = _sq_dists(x, centers).min(-1).values.sum(-1)
    return centers, inertia


def kmeans_per_codebook(gen: torch.Generator | None, acts: torch.Tensor, *, k: int, v: int,
                        iters: int = 25, init: torch.Tensor | None = None) -> torch.Tensor:
    """Per-codebook k-means over a layer's activations (Eq. 1):
    acts (N, D) -> centroids (C, K, V), C = D // v, all codebooks at once."""
    n, d = acts.shape
    sub = acts.reshape(n, d // v, v).transpose(0, 1)               # (C, N, V)
    centroids, _ = kmeans(gen, sub, k=k, iters=iters, init=init)
    return centroids
