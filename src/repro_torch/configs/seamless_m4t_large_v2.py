"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf]: encoder-decoder, 24+24L,
d_model 1024, 16H (kv=16), d_ff 8192, vocab 256206 (padded to 256256 for
16-way vocab sharding).  The audio frontend is a STUB per spec:
input_specs() provides precomputed frame embeddings [B, frames, d_model]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_type="none",  # learned/convolutional positions in the real model; stubbed
    modality_stub="audio_frames",
    stub_frames=1024,
    sub_quadratic=False,
    source="arXiv:2308.11596",
)
