"""Minitron-4B [arXiv:2407.14679; hf]: pruned Nemotron; 32L, d_model 3072,
24H GQA kv=8, d_ff 9216, vocab 256000, squared-ReLU MLP, full attention
(=> long_500k skipped)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="relu2",
    norm_type="layernorm",
    rope_type="partial",
    rope_fraction=0.5,
    sub_quadratic=False,
    source="arXiv:2407.14679",
)
