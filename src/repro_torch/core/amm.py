"""Functional LUT-NN linear layer (the paper's core operator), in PyTorch.

Counterpart of `repro.core.amm`: one entry point, `lut_linear`, with modes

  DENSE      exact x @ W (+ b)
  LUT_INFER  deployed path: int8 table + hard argmin encode, through the
             LUT kernels (`use_kernel`), or through plain tensor ops as the
             integer one-hot contraction (`int8_dot`) or the dequantized
             one-hot contraction
  LUT_TRAIN  soft-PQ training (paper section 3): the table rebuilt from the
             frozen weight on every call and fake-quantized (section 3.3),
             the encoding the argmin/softmax straight-through estimator
             (Eq. 6) at the learned temperature (section 3.2); plain tensor
             ops, autograd for the gradients

Param dicts as in the reference:
  dense  : {"w": (D, M) [, "b": (M,)]}
  train  : {"centroids": (C, K, V), "log_t": ()} (+ frozen {"w", "b"})
  deploy : {"centroids": (C, K, V), "table_q": int8 (C, K, M),
            "table_scale": (1|C, 1, 1|M) [, "b": (M,)]}

and the cost accounting of the paper's Table 1 (`lut_flops`, `dense_flops`,
`lut_table_bytes`, `dense_bytes`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping

import torch

from repro_torch.core import pq, quant
from repro_torch.core.temperature import temperature


class Mode(str, enum.Enum):
    DENSE = "dense"
    LUT_TRAIN = "lut_train"
    LUT_INFER = "lut_infer"


@dataclasses.dataclass(frozen=True)
class LUTConfig:
    """Static LUT hyper-parameters of one site (see repro.core.amm.LUTConfig)."""

    k: int = 16
    v: int = 32
    bits: int = 8
    per_column: bool = False
    int8_dot: bool = False
    use_kernel: bool = False

    def codebooks(self, d: int) -> int:
        if d % self.v:
            raise ValueError(f"D={d} not divisible by V={self.v}")
        return d // self.v


def lut_linear(cfg: LUTConfig, mode: Mode, params: Mapping[str, Any], x: torch.Tensor, *,
               frozen: Mapping[str, Any] | None = None, reduce_absmax=None) -> torch.Tensor:
    """Apply one (possibly LUT-replaced) linear layer. x: (..., D) -> (..., M).
    LUT_TRAIN takes the frozen dense weight (and bias) as `frozen`, and a
    tensor-parallel shard its `reduce_absmax` (`lut_train_contract`)."""
    if mode == Mode.DENSE:
        y = x @ params["w"].to(x.dtype)
        b = params.get("b")
        return y + b.to(y.dtype) if b is not None else y

    if mode == Mode.LUT_TRAIN:
        if frozen is None:
            raise ValueError("LUT_TRAIN needs the frozen dense weight")
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        y = lut_train_contract(cfg, params, frozen["w"], xf, reduce_absmax=reduce_absmax)
        b = frozen.get("b")
        y = y + b.to(y.dtype) if b is not None else y
        return y.reshape(*lead, -1).to(x.dtype)

    if mode == Mode.LUT_INFER:
        p = params["centroids"]
        qt = quant.QuantizedTable(params["table_q"], params["table_scale"])
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        b = params.get("b")
        if cfg.use_kernel:
            from repro_torch.kernels import ops

            # bias rides the kernel's fused epilogue
            y = ops.lut_amm(xf, p, qt.q, qt.scale, bias=b)
        else:
            dists = pq.pairwise_sq_dists(pq.split_subvectors(xf, cfg.v), p)
            if cfg.int8_dot:
                y = pq.lut_contract_int8(pq.hard_encode(dists), qt.q, qt.scale)
            else:
                table = qt.dequant(dtype=x.dtype)
                y = pq.lut_contract(pq.hard_encode(dists).to(x.dtype), table)
            y = y + b.to(y.dtype) if b is not None else y
        return y.reshape(*lead, -1).to(x.dtype)

    raise ValueError(f"unknown mode {mode}")


def lut_train_contract(cfg: LUTConfig, params: Mapping[str, Any], w: torch.Tensor,
                       xf: torch.Tensor, *, reduce_absmax=None) -> torch.Tensor:
    """LUT_TRAIN's contraction without the bias: the fake-quantized table
    of the centroids and the frozen `w`, the straight-through encoding of
    the rows xf (N, D); (N, M) fp32. A tensor-parallel rank passes its
    shards and `reduce_absmax` (`quant.table_scale`)."""
    p = params["centroids"]
    t = temperature(params["log_t"])
    table = pq.build_table(p, w, stop_weight_grad=True)
    table = quant.fake_quant(table, bits=cfg.bits, per_column=cfg.per_column,
                             m_shared=cfg.int8_dot, reduce_absmax=reduce_absmax)
    dists = pq.pairwise_sq_dists(pq.split_subvectors(xf, cfg.v), p)
    enc = pq.ste_encode(dists, t)
    return pq.lut_contract(enc.to(xf.dtype), table.to(xf.dtype))


def lut_flops(n: int, d: int, m: int, cfg: LUTConfig) -> int:
    """Paper Table 1: N*D*K (encode) + N*M*D/V (lookup-accumulate)."""
    return n * d * cfg.k + n * m * d // cfg.v


def dense_flops(n: int, d: int, m: int) -> int:
    return n * d * m


def lut_table_bytes(d: int, m: int, cfg: LUTConfig) -> int:
    """int8 table + fp32 scales + fp32 codebook bytes (paper Table 1 size)."""
    c = d // cfg.v
    table = c * cfg.k * m                       # int8
    scales = c * 4 * (m if cfg.per_column else 1)
    codebook = c * cfg.k * cfg.v * 4
    return table + scales + codebook


def dense_bytes(d: int, m: int, dtype_bytes: int = 4) -> int:
    return d * m * dtype_bytes
