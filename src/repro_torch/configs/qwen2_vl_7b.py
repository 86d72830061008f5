"""Qwen2-VL-7B backbone — M-RoPE; the dynamic-resolution ViT frontend is a
STUB: the caller passes patch and text embeddings [arXiv:2409.12191; hf]."""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="qwen2_vl_7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944,
    vocab=152064,
    mrope_sections=(16, 24, 24),            # t/h/w splits of d_head/2
    takes_embeds=True,
    rope_theta=1_000_000.0,
)
