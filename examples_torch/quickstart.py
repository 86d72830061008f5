"""Quickstart: replace one matmul with a LUT-NN table lookup, in PyTorch.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The port's counterpart of examples/quickstart.py, on the card unless
`--device cpu` asks for the CPU. Walks the paper end to end on a single
operator: k-means centroids (Eq. 1), table precompute (Eq. 3), argmin
encode + table read (Eq. 4), and the cost accounting of Table 1.
"""

import argparse

import torch

from repro_torch.core import (
    LUTConfig,
    Mode,
    dense_bytes,
    dense_flops,
    lut_flops,
    lut_linear,
    lut_table_bytes,
)
from repro_torch.core.lut_layer import deploy_params, init_dense, lut_train_params_from_dense
from repro_torch.device import resolve_device

N, D, M = 1024, 256, 512
CFG = LUTConfig(k=16, v=8, bits=8)


def table1(n: int = N, d: int = D, m: int = M, cfg: LUTConfig = CFG) -> dict[str, int]:
    """The Table 1 numbers the script prints: FLOPs and weight bytes, dense
    against LUT."""
    return {"dense_flops": dense_flops(n, d, m), "lut_flops": lut_flops(n, d, m, cfg),
            "dense_bytes": dense_bytes(d, m), "lut_table_bytes": lut_table_bytes(d, m, cfg)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # clustered inputs — the structure LUT-NN exploits (paper section 1)
    centers = torch.randn((16, D), generator=gen, device=dev)   # 16 clusters, one per slot
    x = centers[torch.randint(0, 16, (N,), generator=gen, device=dev)]
    x = x + 0.05 * torch.randn((N, D), generator=gen, device=dev)

    dense = init_dense(gen, D, M, device=dev)
    y_ref = lut_linear(CFG, Mode.DENSE, dense, x)

    # offline: learn centroids from activations, precompute + quantize the table
    trainable, frozen = lut_train_params_from_dense(gen, dense, x, CFG)
    deployed = deploy_params(trainable, frozen, CFG)

    # online: encode -> lookup -> accumulate (no D-contraction matmul)
    y_lut = lut_linear(CFG, Mode.LUT_INFER, deployed, x)

    rel = float(torch.linalg.norm(y_lut - y_ref) / torch.linalg.norm(y_ref))
    t = table1()
    print(f"device                       : {dev}")
    print(f"approximation rel. error     : {rel:.4f}")
    print(f"FLOPs   dense -> LUT         : {t['dense_flops']:.2e} -> {t['lut_flops']:.2e} "
          f"({t['dense_flops'] / t['lut_flops']:.1f}x, paper Table 1)")
    print(f"weights dense -> int8 tables : {t['dense_bytes']:.2e} -> "
          f"{t['lut_table_bytes']:.2e} bytes ({t['dense_bytes'] / t['lut_table_bytes']:.1f}x)")
    return dict(t, rel_error=rel)


if __name__ == "__main__":
    main()
