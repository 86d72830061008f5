"""Plain PyTorch versions of the LUT kernels.

`fused_decode_plain` and `lut_amm_v2_plain` compute exactly what the CUDA
kernels compute (csrc/lut_common.cuh): fp32 expansion distances, lowest index
wins a tie, then an exact int32 gather-accumulate dequantized once for an
m-shared or scalar scale, fused with the bias add into one rounding (fp32
per-codebook rescale, then + bias, otherwise), then the activation in fp32,
cast to x's dtype. `lut_amm_v1_plain` sums the fp32-dequantized entries in
the v1 kernel's order (csrc/lut_amm_v1.cu). `encode_ref` is the plain version
of the encode kernel (csrc/encode.cu). They are what a CPU tensor runs, what
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

calls = {"fused_decode_plain": 0, "lut_amm_v2_plain": 0, "lut_amm_v1_plain": 0,
         "encode_plain": 0}


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


def encode_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Plain version of the encode kernel (kernels/dist_argmin.py)."""
    calls["encode_plain"] += 1
    return encode_ref(x, centroids)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fl32(a * b + c) with a single rounding, as a fused multiply-add gives
    it: the product of two fp32 values is exact in fp64; the fp64 sum is
    rounded to odd (TwoSum finds its error, and an inexact sum with an even
    last bit moves one ulp toward the exact value), which makes the final
    rounding to fp32 the correct one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


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
    return lookup(encode_ref(x, centroids), table_q, scale, bias=bias, act=act, dtype=x.dtype)


def lookup(idx: torch.Tensor, table_q: torch.Tensor, scale: torch.Tensor, *,
           bias: torch.Tensor | None = None, act: str = "none",
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused and v2 kernels' lookup and epilogue on given (N, C) codes."""
    if act not in ACTIVATIONS:
        raise ValueError(f"act={act!r} not in {ACTIVATIONS}")
    if scale.shape[0] == 1:
        # m-shared / scalar: exact int32 sum, one rounding per element, the
        # bias add fused into it
        acc = pq.gather_lut(idx, table_q.to(torch.int32)).float()
        s = scale.reshape(1, -1).expand_as(acc)
        y = acc * s if bias is None else fma_f32(acc, s, bias.float().expand_as(acc))
    else:
        y = pq.gather_lut(idx, table_q.float() * scale)
        if bias is not None:
            y = y + bias.float()
    return apply_act(y, act).to(dtype)


def fused_decode_plain(x, centroids, table_q, scale, *, bias=None, act="none"):
    """Plain version of the fused kernel (kernels/fused_decode.py)."""
    calls["fused_decode_plain"] += 1
    return _lookup(x, centroids, table_q, scale, bias, act)


def lut_amm_v2_plain(x, centroids, table_q, scale, *, bias=None, act="none"):
    """Plain version of the v2 kernel (kernels/lut_amm.py)."""
    calls["lut_amm_v2_plain"] += 1
    return _lookup(x, centroids, table_q, scale, bias, act)


def v1_block_c(c: int, v: int, block_c: int | None = None) -> int:
    """v1's chunk of the codebook sum: the reference's max(1, min(C, 2048 // V))
    unless given, reduced to a divisor of C (`lut_amm_pallas_v1`)."""
    bc = min(block_c if block_c else max(1, min(c, 2048 // v)), c)
    while c % bc:
        bc -= 1
    return bc


def lut_amm_v1_plain(x, centroids, table_q, scale, *, block_c=None):
    """Plain version of the v1 kernel (kernels/lut_amm.py::lut_amm_v1): each
    entry dequantized in fp32 (t * s), summed in codebook order within chunks
    of block_c codebooks, the chunk sums added in order; cast to x's dtype.
    No bias or activation. A (1, 1, 1|M) scale is read as its broadcast over C."""
    calls["lut_amm_v1_plain"] += 1
    n, d = x.shape
    c, k, v = centroids.shape
    if d != c * v:
        raise ValueError(f"D={d} != C*V={c}*{v}")
    bc = v1_block_c(c, v, block_c)
    idx = encode_ref(x, centroids).long()
    s = scale.float()
    total = torch.zeros((n, table_q.shape[-1]), dtype=torch.float32, device=x.device)
    chunk = torch.zeros_like(total)
    for ci in range(c):
        entry = table_q[ci][idx[:, ci]].float() * s[0 if s.shape[0] == 1 else ci, 0]
        chunk = chunk + entry
        if (ci + 1) % bc == 0:
            total = total + chunk
            chunk = torch.zeros_like(total)
    return total.to(x.dtype)
