"""Public LUT entry points with autotuned version dispatch.

Counterpart of `repro.kernels.ops`. `lut_amm` asks `autotune.kernel_choice`
for the kernel version and launch of each shape: a record (measured on the
card, restored from an artifact, or analytic) always wins; with none, the
fused kernel (v3) runs when all C codebooks' fp32 centroids plus one N tile's
codes fit in a block's shared memory on this card, else v2. `version=1|2|3`
forces a kernel. A CPU tensor runs the plain version of the chosen kernel.
`encode` runs the encode kernel.

On the meta device (a dry run, `launch/dryrun.py`) both launch nothing: they
return an empty tensor of the output's shape and charge the active
`roofline.op_cost.OpCostMode` the kernel's work (`roofline.analysis.
lut_site_cost`), for the version `autotune.kernel_choice` picks on the card
at that shape. Only meta tensors take that branch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import dist_argmin as enc_mod
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import lut_amm as lut_mod
from repro_torch.kernels import ref

VERSION_V1 = 1
VERSION_V2 = 2
VERSION_FUSED = autotune.VERSION_FUSED
KERNEL_OF_VERSION = {VERSION_V1: "lut_amm_v1", VERSION_V2: "lut_amm_v2",
                     VERSION_FUSED: "fused_decode"}


def _backend(x: torch.Tensor) -> str:
    """The autotune key's backend: the card's for a dry run's meta tensors."""
    return autotune.BACKEND_CUDA if x.is_meta else autotune.backend_of(x)


def _dry_call(kernel: str, x: torch.Tensor, centroids: torch.Tensor, m: int,
              out_shape: tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """A kernel call on meta tensors: its work charged to the active
    OpCostMode (none: nothing), an empty output returned."""
    from repro_torch.roofline import analysis, op_cost

    mode = op_cost.active()
    if mode is not None:
        c, k, v = centroids.shape
        n = x.shape[0]
        mode.charge_site(analysis.lut_site_cost(n, c, k, v, m, x.element_size(), kernel),
                         kernel, (n, m, c, k, v))
    return torch.empty(out_shape, dtype=dtype, device=x.device)


def lut_amm(x: torch.Tensor, centroids: torch.Tensor, table_q: torch.Tensor,
            scale: torch.Tensor, *, bias: torch.Tensor | None = None,
            act: str = "none", version: int | None = None,
            blocks: autotune.BlockConfig | None = None) -> torch.Tensor:
    """LUT-NN approximate matmul: (N, C*V) -> (N, M) in x.dtype.

    version: None asks the autotune record (else the fit rule); 1, 2 or 3
    forces v1, v2 or the fused kernel. blocks: the launch (None: the
    record's when it chose the version, else the wrapper's defaults)."""
    if version not in (None, VERSION_V1, VERSION_V2, VERSION_FUSED):
        raise ValueError(f"version={version!r}: expected None, 1, 2 or 3")
    if version is None:
        n, _ = x.shape
        c, k, v = centroids.shape
        version, rec_blocks, _ = autotune.kernel_choice(
            n, table_q.shape[-1], c, k, v, dtype=autotune.dtype_name(x.dtype),
            backend=_backend(x))
        blocks = blocks or rec_blocks
    if x.is_meta:
        m = table_q.shape[-1]
        return _dry_call(KERNEL_OF_VERSION[version], x, centroids, m, (x.shape[0], m), x.dtype)
    cfg = blocks or autotune.DEFAULT
    if version == VERSION_V1:
        # v1 has no fused epilogue: bias and activation follow in x's dtype,
        # as the reference adds them outside lut_amm_pallas_v1
        y = lut_mod.lut_amm_v1(x, centroids, table_q, scale, **autotune.v1_launch(cfg))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return ref.apply_act(y, act).to(y.dtype)
    if bias is not None:
        bias = bias.float()           # the epilogue adds bias in fp32
    launch = autotune.cluster_launch(cfg)
    if version == VERSION_FUSED:
        return fused_mod.fused_decode(x, centroids, table_q, scale, bias=bias, act=act, **launch)
    return lut_mod.lut_amm_v2(x, centroids, table_q, scale, bias=bias, act=act, **launch)


def encode(x: torch.Tensor, centroids: torch.Tensor, *, block_n: int | None = None,
           block_c: int | None = None) -> torch.Tensor:
    """Closest-centroid encode: (N, C*V) -> int32 (N, C), with the launch of
    the "encode" autotune record unless given (a record's launch that does
    not fit the kernel takes the default, `autotune.encode_launch`)."""
    n, _ = x.shape
    c, k, v = centroids.shape
    if x.is_meta:
        return _dry_call("encode", x, centroids, 0, (n, c), torch.int32)
    cfg = autotune.resolve_blocks("encode", n, 0, c, k, v, autotune.dtype_name(x.dtype),
                                  autotune.backend_of(x), block_n, None, block_c)
    if block_n is None or block_c is None:          # a field came from the record
        return enc_mod.encode(x, centroids, **autotune.encode_launch(cfg, n, c, k, v))
    return enc_mod.encode(x, centroids, block_n=block_n or None, block_c=block_c or None)
