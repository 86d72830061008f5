"""Plain PyTorch versions of the LUT kernels.

`fused_decode_plain` and `lut_amm_v2_plain` compute exactly what the CUDA
kernels compute (csrc/lut_common.cuh): fp32 expansion distances, lowest index
wins a tie, then an exact int32 gather-accumulate dequantized once for an
m-shared or scalar scale (fp32 per-codebook rescale otherwise), then bias and
activation in fp32, cast to x's dtype. They are what a CPU tensor runs, what
the CPU tests hold against the JAX kernels, and what `chip_smoke.py` holds the
CUDA kernels against on the card. `lut_amm_ref` and `encode_ref` are the
counterparts of the reference's oracle (`repro.kernels.ref`).

`calls` counts the calls of each plain version, so a run can show that the
main path on the card never reached them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pq

ACTIVATIONS = ("none", "relu", "silu", "gelu", "relu2")

calls = {"fused_decode_plain": 0, "lut_amm_v2_plain": 0}


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """The kernels' epilogue activations; gelu is the tanh approximation, as
    jax.nn.gelu is by default."""
    if act == "none":
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "silu":
        return F.silu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act == "relu2":
        r = torch.clamp_min(y, 0.0)
        return r * r
    raise ValueError(f"unknown epilogue activation {act!r}")


def encode_ref(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, D), (C, K, V) -> int32 (N, C) nearest-centroid indices."""
    return pq.encode_indices(x, centroids)


def lut_amm_ref(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """The reference oracle's semantics: fp32-dequantized table, one-hot
    contraction in fp32, cast to x.dtype. No bias or activation."""
    n, d = x.shape
    c, k, v = centroids.shape
    if d != c * v:
        raise ValueError(f"D={d} != C*V={c}*{v}")
    idx = encode_ref(x, centroids)
    onehot = F.one_hot(idx.long(), k).float()
    table = table_q.float() * scale.float()
    return torch.einsum("nck,ckm->nm", onehot, table).to(x.dtype)


def _lookup(x, centroids, table_q, scale, bias, act):
    n, d = x.shape
    c, k, v = centroids.shape
    if d != c * v:
        raise ValueError(f"D={d} != C*V={c}*{v}")
    if act not in ACTIVATIONS:
        raise ValueError(f"act={act!r} not in {ACTIVATIONS}")
    idx = encode_ref(x, centroids)
    if scale.shape[0] == 1:
        # m-shared / scalar: exact int32 sum, one rounding per element
        y = pq.gather_lut(idx, table_q.to(torch.int32)).float() * scale.reshape(1, -1)
    else:
        y = pq.gather_lut(idx, table_q.float() * scale)
    if bias is not None:
        y = y + bias.float()
    return apply_act(y, act).to(x.dtype)


def fused_decode_plain(x, centroids, table_q, scale, *, bias=None, act="none"):
    """Plain version of the fused kernel (kernels/fused_decode.py)."""
    calls["fused_decode_plain"] += 1
    return _lookup(x, centroids, table_q, scale, bias, act)


def lut_amm_v2_plain(x, centroids, table_q, scale, *, bias=None, act="none"):
    """Plain version of the v2 kernel (kernels/lut_amm.py)."""
    calls["lut_amm_v2_plain"] += 1
    return _lookup(x, centroids, table_q, scale, bias, act)
