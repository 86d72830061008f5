"""Public LUT-AMM entry point with version dispatch.

Counterpart of `repro.kernels.ops.lut_amm`. Without `version`, a site runs the
fused kernel (v3) when all C codebooks' fp32 centroids plus one N tile's codes
fit in a block's shared memory on this card, else v2: the no-record rule of
`repro.kernels.autotune.kernel_choice`, with the card's 227 KB in place of the
TPU's VMEM budget. There is no autotuner yet: block sizes are fixed in each
wrapper. A CPU tensor runs the plain version of the chosen kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as v2_mod

VERSION_V2 = 2
VERSION_FUSED = 3


def choose_version(c: int, k: int, v: int) -> int:
    return VERSION_FUSED if fused_mod.fits(c, k, v) else VERSION_V2


def lut_amm(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
            scale: torch.Tensor, *, bias: torch.Tensor | None = None,
            act: str = "none", version: int | None = None) -> torch.Tensor:
    """LUT-NN approximate matmul: (N, C*V) -> (N, M) in x.dtype.

    version: None picks by the fit rule; 3 forces the fused kernel, 2 forces
    v2. The TPU's v1 kernel is not ported (ROADMAP Queue B)."""
    if version == 1:
        raise NotImplementedError("lut_amm version=1 (lut_amm_pallas_v1) is not ported to "
                                  "the GPU yet: ROADMAP Queue B")
    if version not in (None, VERSION_V2, VERSION_FUSED):
        raise ValueError(f"version={version!r}: expected None, 2 or 3")
    if version is None:
        c, k, v = centroids.shape
        version = choose_version(c, k, v)
    if bias is not None:
        bias = bias.float()           # the epilogue adds bias in fp32
    fn = fused_mod.fused_decode if version == VERSION_FUSED else v2_mod.lut_amm_v2
    return fn(x, centroids, table_q, scale, bias=bias, act=act)
