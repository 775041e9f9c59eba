"""Jamba-v0.1 52B [arXiv:2403.19887; hf]: 32L, d_model 4096, 32H GQA kv=8,
d_ff 14336, vocab 65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave
(one attention layer per 8), hybrid => sub-quadratic, long_500k runs."""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_type="none",  # Jamba uses no positional encoding (Mamba provides order)
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    attn_every=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
    source="arXiv:2403.19887",
)
