"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]: 24L,
d_model 2048, 32H (kv=32 => MHA), d_ff 5632 SwiGLU, vocab 100352, partial
rotary (25%), LayerNorm, full attention (=> long_500k skipped)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    mlp_type="swiglu",
    norm_type="layernorm",
    rope_type="partial",
    rope_fraction=0.25,
    sub_quadratic=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
