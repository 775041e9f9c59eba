"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table]: 61L,
d_model 7168, 64H GQA kv=8, vocab 163840, MoE 384 experts top-8 with expert
d_ff 2048 + 1 shared expert, first layer dense.  Full attention =>
long_500k skipped.  The 384-expert top-8 routing is the closest LM analogue
of GraphMP's selective shard scheduling (DESIGN.md §5) — hillclimb cell."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_type="rope",
    rope_theta=5e4,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_k_dense=1),
    sub_quadratic=False,
    source="arXiv:2501.kimi2",
)
