"""Minitron-8B — pruned Nemotron-4 [arXiv:2407.14679; hf].

Squared-ReLU non-gated MLP (Nemotron family), 256k vocab.
"""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="minitron_8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384,
    vocab=256000,
    act="relu2",
    mlp_gated=False,
    rope_theta=500_000.0,
)
