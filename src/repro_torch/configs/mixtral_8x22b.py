"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d_model 6144, 48H GQA kv=8,
d_ff 16384, vocab 32768, MoE 8 experts top-2, sliding-window attention
(per the assignment table) => sub-quadratic, long_500k runs."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_type="rope",
    rope_theta=1e6,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    sub_quadratic=True,
    source="arXiv:2401.04088",
)
