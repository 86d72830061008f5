"""LUT-NN inference in PyTorch with hand-written CUDA kernels for Hopper (H100).

A port of the JAX package `repro`, module for module under the same names;
`repro` stays the reference it is held against. This package imports torch
and numpy only, never jax or repro.
"""

import torch

# The reference computes float32 matmuls in full float32. PyTorch would let
# cuBLAS use TF32 (about three decimal digits) for them and cuDNN for
# convolutions; both are switched off so that the dense layers, attention and
# logits on the card stay comparable with the reference and the CPU.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
