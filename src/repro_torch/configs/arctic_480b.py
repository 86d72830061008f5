"""Snowflake Arctic 480B — 128 experts top-2 + dense residual branch
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="arctic_480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864,
    vocab=32000,
    n_experts=128, top_k=2,
    moe_dense_residual=True,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    grad_accum=2,
)
