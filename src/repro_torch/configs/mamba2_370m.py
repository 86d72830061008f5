"""Mamba2-370M — SSD, attention-free [arXiv:2405.21060]."""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="mamba2_370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0, n_kv_heads=0, d_head=0,      # attention-free
    d_ff=0,                                  # no MLP: pure mixer stack
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,                         # 32 SSD heads
    ssm_groups=1,
    tie_embeddings=True,
    sub_quadratic=True,
    notes="SSD (state-space duality); d_inner=2048, 32 heads of 64, N=128.",
)
