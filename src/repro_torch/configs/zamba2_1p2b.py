"""Zamba2-1.2B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

38 mamba2 layers (d_inner=4096, 64 heads of 64, N=64); one shared
attention+MLP block (32 MHA heads of 64, d_ff=8192) invoked every 6 layers
with concat(hidden, embedding) fusion.
"""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="zamba2_1p2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    tie_embeddings=True,
    sub_quadratic=True,
    rope_theta=10_000.0,
)
