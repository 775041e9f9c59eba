"""StarCoder2-7B [arXiv:2402.19173; hf]: 32L, d_model 4608, 36H GQA kv=4,
d_ff 18432, vocab 49152, RoPE, sliding-window 4096 (paper §Model; makes the
arch sub-quadratic, so long_500k runs), LayerNorm + GELU MLP."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_type="rope",
    rope_theta=1e5,
    sliding_window=4096,
    sub_quadratic=True,
    source="arXiv:2402.19173",
)
