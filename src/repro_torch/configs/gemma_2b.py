"""Gemma 2B [arXiv:2403.08295; hf]: 18L, d_model 2048, 8 heads, MQA (kv=1),
head_dim 256, GeGLU d_ff 16384, vocab 256000, tied embeddings, full attention
(=> long_500k skipped, DESIGN.md §5)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    rope_type="rope",
    tie_embeddings=True,
    sub_quadratic=False,
    source="arXiv:2403.08295",
)
