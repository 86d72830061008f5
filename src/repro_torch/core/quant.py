"""Scalar quantization of lookup tables (paper section 3.3), in PyTorch.

Counterpart of `repro.core.quant`: symmetric r = s * q with
s = max|r| / (2^(bits-1) - 1), zero-point 0. Scale layouts:

  per-codebook (C, 1, 1)   the paper's one scale per table
  per-column   (C, 1, M)
  m-shared     (1, 1, M)   one scale per output column, shared over codebooks:
                           it factors out of the codebook sum, so the kernels
                           accumulate exact int32 and dequantize once
  scalar       (1, 1, 1)   accepted by the kernels like m-shared

`fake_quant` is the straight-through quantize-dequantize of soft-PQ training.
The scale's axes count from the end, so a stack of tables (L, C, K, M)
quantizes table by table in one call. A tensor-parallel rank holds a shard
of a table (its M columns, or its C codebooks): `reduce_absmax` takes the
shard's absmax to the whole table's (a max over the model axis) where the
layout's max runs over the split axis, so that the rank quantizes with the
unsharded scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedTable(NamedTuple):
    """Deployed LUT: int8 codes (C, K, M) plus fp32 scales."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def table_scale(t: torch.Tensor, *, bits: int = 8, per_column: bool = False,
                m_shared: bool = False, reciprocal: bool = False,
                reduce_absmax=None) -> torch.Tensor:
    """Symmetric scale in the layout the flags select (see module docstring).
    `reciprocal` multiplies by the fp32 1 / (2^(bits-1) - 1) instead of
    dividing, as XLA compiles the reference's division by that constant
    (its jitted deploy): the two differ by an ulp on some tables.
    `reduce_absmax` (absmax -> absmax) is applied to the absmax before the
    clamp: a tensor-parallel shard's max over its peers."""
    if m_shared:
        absmax = t.abs().amax(dim=(-3, -2), keepdim=True)  # (1, 1, M)
    elif per_column:
        absmax = t.abs().amax(dim=-2, keepdim=True)        # (C, 1, M)
    else:
        absmax = t.abs().amax(dim=(-2, -1), keepdim=True)  # (C, 1, 1)
    if reduce_absmax is not None:
        absmax = reduce_absmax(absmax.detach())
    absmax = torch.clamp(absmax.float(), min=1e-8)
    return absmax * (1.0 / _qmax(bits)) if reciprocal else absmax / _qmax(bits)


def quantize_table(t: torch.Tensor, *, bits: int = 8, per_column: bool = False,
                   m_shared: bool = False, reciprocal: bool = False) -> QuantizedTable:
    scale = table_scale(t, bits=bits, per_column=per_column, m_shared=m_shared,
                        reciprocal=reciprocal)
    q = torch.clamp(torch.round(t.float() / scale), -_qmax(bits), _qmax(bits))
    return QuantizedTable(q=q.to(torch.int8), scale=scale)


def fake_quant(t: torch.Tensor, *, bits: int = 8, per_column: bool = False,
               m_shared: bool = False, reduce_absmax=None) -> torch.Tensor:
    """Quantization-aware training with a straight-through estimator: the
    forward value is quantize-dequantize(T), the gradient the identity."""
    scale = table_scale(t, bits=bits, per_column=per_column, m_shared=m_shared,
                        reduce_absmax=reduce_absmax)
    t32 = t.float()
    qdq = torch.clamp(torch.round(t32 / scale), -_qmax(bits), _qmax(bits)) * scale
    return (t32 + (qdq - t32).detach()).to(t.dtype)
