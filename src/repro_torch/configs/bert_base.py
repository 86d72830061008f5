"""BERT-base — the paper's own NLP model (Tables 2/5, Fig. 13).

Used by benchmarks/tests (not part of the assigned 40-cell matrix).
lut_policy last_n:6 reproduces the paper's default of replacing the FC
operators of the last 6 layers; (K, V) = (16, 32) per paper Table 2.
"""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="bert_base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072,
    vocab=30522,
    act="gelu",
    mlp_gated=False,
    causal=False,
    tie_embeddings=True,
    lut_policy="last_n:6",
    rope_theta=10_000.0,
)
