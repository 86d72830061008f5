"""Command-R 35B — GQA, no biases [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="command_r_35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22528,
    vocab=256000,
    use_bias=False,
    rope_theta=8_000_000.0,
    param_dtype="bfloat16",
    grad_accum=2,
)
