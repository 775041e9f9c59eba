"""Qwen2-VL-72B [arXiv:2409.12191; hf]: 80L, d_model 8192, 64H GQA kv=8,
d_ff 29568, vocab 152064, M-RoPE (3-section rotary over temporal/h/w),
dynamic-resolution vision frontend STUBBED per spec (precomputed patch
embeddings).  Full attention => long_500k skipped."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_type="mrope",
    rope_theta=1e6,
    modality_stub="image_patches",
    img_patches=256,
    sub_quadratic=False,
    source="arXiv:2409.12191",
)
