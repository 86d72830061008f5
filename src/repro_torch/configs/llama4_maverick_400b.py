"""Llama-4 Maverick 400B-A17B — MoE 128e top-1 + shared expert
[hf:meta-llama/Llama-4-*]. The modality early-fusion frontend is out of
scope for the LM shapes (text tokens only here).
"""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="llama4_maverick_400b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192,
    vocab=202048,
    n_experts=128, top_k=1,
    moe_shared_expert=True,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    grad_accum=2,
)
