"""LUT-AMM kernels: CUDA sources (csrc/), their build, wrappers, plain versions
and the dispatching entry point `ops.lut_amm`."""
