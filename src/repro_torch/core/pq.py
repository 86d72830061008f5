"""Product-quantization math for LUT-NN inference (paper Eqs. 1-4), in PyTorch.

Counterpart of `repro.core.pq`, same names and shape conventions:

  a      : (N, D)        input activations
  P      : (C, K, V)     centroids / codebooks, C = D // V
  T      : (C, K, M)     lookup table
  dists  : (N, C, K)     squared Euclidean distances per codebook
  enc    : (N, C, K)     one-hot encoding

Distances are fp32 by the same expansion ||a||^2 - 2 a.P + ||P||^2 as the
reference, so that codes agree with it except on near-ties. Training adds
the soft encoding (Eq. 5), its straight-through form (Eq. 6) and the table
build (Eq. 3); `.detach()` stands where the reference stops gradients.
"""

from __future__ import annotations

import torch


def split_subvectors(a: torch.Tensor, v: int) -> torch.Tensor:
    """(..., D) -> (..., C, V) with C = D // V. D must be divisible by V."""
    *lead, d = a.shape
    if d % v:
        raise ValueError(f"feature dim {d} not divisible by sub-vector length {v}")
    return a.reshape(*lead, d // v, v)


def pairwise_sq_dists(a_sub: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """a_sub (N, C, V), P (C, K, V) -> (N, C, K) squared distances in fp32."""
    a32 = a_sub.float()
    p32 = p.float()
    cross = torch.einsum("ncv,ckv->nck", a32, p32)
    a_nrm = (a32 * a32).sum(-1)[:, :, None]              # (N, C, 1)
    p_nrm = (p32 * p32).sum(-1)[None, :, :]              # (1, C, K)
    return a_nrm - 2.0 * cross + p_nrm


def hard_encode(dists: torch.Tensor) -> torch.Tensor:
    """one-hot(argmin) over K, in dists' dtype. argmin keeps the lowest index
    of a tie, as jnp.argmin does."""
    k = dists.shape[-1]
    idx = torch.argmin(dists, dim=-1)
    return torch.nn.functional.one_hot(idx, k).to(dists.dtype)


def soft_encode(dists: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """softmax(-dists / t) over K, Eq. 5; t > 0 is the (learned) temperature."""
    return torch.softmax(-dists / t, dim=-1)


def ste_encode(dists: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Soft-PQ straight-through encoding, Eq. 6: the forward value is the hard
    one-hot, the gradient that of the softmax (w.r.t. dists and t)."""
    soft = soft_encode(dists, t)
    hard = hard_encode(dists)
    return soft + (hard - soft).detach()


def build_table(p: torch.Tensor, w: torch.Tensor, *,
                stop_weight_grad: bool = True) -> torch.Tensor:
    """Lookup tables T[..., c] = P[..., c] @ W_c (Eq. 3).

    P (..., C, K, V), W (..., D, M) with D = C*V -> T (..., C, K, M); leading
    axes (stacked layers) batch. The replaced weight is frozen in soft-PQ
    training, so its gradient is stopped unless `stop_weight_grad` is False."""
    *lead, c, k, v = p.shape
    d, m = w.shape[-2:]
    if d != c * v:
        raise ValueError(f"weight rows {d} != C*V = {c}*{v}")
    w = w.detach() if stop_weight_grad else w
    w_sub = w.reshape(*w.shape[:-2], c, v, m)
    return torch.einsum("...ckv,...cvm->...ckm", p.to(w.dtype), w_sub)


def lut_contract(enc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """sum_c enc[n,c,:] . T[c,:,m] -> (N, M), accumulated in fp32."""
    n = enc.shape[0]
    c, k, m = t.shape
    return enc.reshape(n, c * k).float() @ t.reshape(c * k, m).float()


def lut_contract_int8(enc_hard: torch.Tensor, table_q: torch.Tensor,
                      scale_m: torch.Tensor) -> torch.Tensor:
    """Integer table read with the m-shared (1, 1, M) scale: the one-hot
    selects int8 rows whose exact int32 sum is rescaled once per column.
    Written as a gather of the selected rows (equal to the one-hot int8 dot,
    which PyTorch has no integer kernel for on the card)."""
    idx = torch.argmax(enc_hard, dim=-1)                 # one-hot -> index
    acc = gather_lut(idx, table_q.to(torch.int32))
    return acc.float() * scale_m.reshape(1, -1)


def encode_indices(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, D) -> int32 (N, C) nearest-centroid indices."""
    a_sub = split_subvectors(a, p.shape[-1])
    return torch.argmin(pairwise_sq_dists(a_sub, p), dim=-1).to(torch.int32)


def gather_lut(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N, C) indices, (C, K, M) table -> (N, M): sum over c of T[c, idx[n, c], :].

    In T's dtype: with an int32 table the sum is exact."""
    c = t.shape[0]
    rows = t[torch.arange(c, device=t.device)[None, :], idx.long()]   # (N, C, M)
    return rows.sum(dim=1, dtype=t.dtype)


def pq_reconstruct(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize a through its nearest centroids (analysis util)."""
    a_sub = split_subvectors(a, p.shape[-1])
    enc = hard_encode(pairwise_sq_dists(a_sub, p))          # (N, C, K)
    rec = torch.einsum("nck,ckv->ncv", enc.to(p.dtype), p)
    return rec.reshape(a.shape)
