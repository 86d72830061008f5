"""Qwen3-1.7B — GQA + qk_norm, tied embeddings [hf:Qwen/Qwen3-1.7B]."""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="qwen3_1p7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
