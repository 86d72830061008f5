"""Whisper-tiny — enc-dec, conv audio frontend STUBBED: the caller passes
frame embeddings (B, enc_frames, d_model) [arXiv:2212.04356]."""
from repro_torch.configs import ArchSpec

ARCH = ArchSpec(
    name="whisper_tiny",
    family="audio",
    n_layers=4,                              # decoder layers
    n_enc_layers=4,
    enc_frames=1500,
    d_model=384,
    n_heads=6, n_kv_heads=6, d_head=64,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
    takes_embeds=False,                      # decoder takes tokens; encoder takes stub frames
    rope_theta=10_000.0,
)
