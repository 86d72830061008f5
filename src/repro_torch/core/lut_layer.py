"""Initializers and converters of LUT linear layers, in PyTorch.

Counterpart of `repro.core.lut_layer`. A linear site is a dict of tensors in
one of three lifecycle stages:

  dense weights --(activation samples, k-means, Eq. 1)--> soft-PQ trainable
  soft-PQ trainable --(build + int8-quantize the table, Eq. 3)--> deployed LUT
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import kmeans, pq, quant
from repro_torch.core.amm import LUTConfig
from repro_torch.core.temperature import init_log_temperature


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    dtype: torch.dtype


def init_dense(gen: torch.Generator, d: int, m: int, *, bias: bool = False,
               dtype=torch.float32, scale: float | None = None,
               device="cpu") -> dict[str, Any]:
    """N(0, scale^2) weight, scale 1/sqrt(d) by default; zero bias."""
    s = scale if scale is not None else 1.0 / d ** 0.5
    w = torch.randn((d, m), generator=gen, device=gen.device).to(device) * s
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((m,), dtype=dtype, device=device)
    return p


def lut_train_params_from_dense(gen: torch.Generator, dense_params: dict[str, Any],
                                acts: torch.Tensor, cfg: LUTConfig, *,
                                kmeans_iters: int = 25) -> tuple[dict[str, Any], dict[str, Any]]:
    """k-means-initialized soft-PQ params of one dense layer from samples of
    its inputs (N, D). Returns the (trainable, frozen) param dicts."""
    d = dense_params["w"].shape[0]
    centroids = kmeans.kmeans_per_codebook(gen, acts.reshape(-1, d), k=cfg.k, v=cfg.v,
                                           iters=kmeans_iters)
    trainable = {"centroids": centroids,
                 "log_t": init_log_temperature(device=centroids.device)}
    return trainable, dict(dense_params)


def quantize_for(t: torch.Tensor, cfg: LUTConfig) -> quant.QuantizedTable:
    """The int8 table of a deployed site in the scale layout its serving path
    wants: the kernels and int8_dot take the m-shared (1, 1, M) scale, which
    factors out of the codebook sum (exact int32 lookups). The scale is the
    reference's compiled deploy's, bit for bit (`quant.table_scale`'s
    `reciprocal`)."""
    return quant.quantize_table(t, bits=cfg.bits, per_column=cfg.per_column,
                                m_shared=cfg.int8_dot or cfg.use_kernel, reciprocal=True)


def deploy_params(trainable: dict[str, Any], frozen: dict[str, Any],
                  cfg: LUTConfig) -> dict[str, Any]:
    """The inference LUT of one site: int8 table + scales (the weight dropped)."""
    table = pq.build_table(trainable["centroids"], frozen["w"], stop_weight_grad=False)
    qt = quantize_for(table, cfg)
    out = {"centroids": trainable["centroids"].float(), "table_q": qt.q,
           "table_scale": qt.scale}
    if "b" in frozen:
        out["b"] = frozen["b"]
    return out


def deploy_param_specs(d: int, m: int, cfg: LUTConfig, *,
                       bias: bool = False) -> dict[str, ParamSpec]:
    """Deployed params of a (d -> m) site. Kernel and int8_dot sites take the
    m-shared (1, 1, M) scale: it factors out of the codebook sum, so the
    lookup is exact int32 arithmetic dequantized once per output."""
    c = cfg.codebooks(d)
    if cfg.int8_dot or cfg.use_kernel:
        s_shape = (1, 1, m)
    elif cfg.per_column:
        s_shape = (c, 1, m)
    else:
        s_shape = (c, 1, 1)
    specs = {
        "centroids": ParamSpec((c, cfg.k, cfg.v), torch.float32),
        "table_q": ParamSpec((c, cfg.k, m), torch.int8),
        "table_scale": ParamSpec(s_shape, torch.float32),
    }
    if bias:
        specs["b"] = ParamSpec((m,), torch.float32)
    return specs
