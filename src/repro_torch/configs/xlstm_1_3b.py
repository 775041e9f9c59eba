"""xLSTM-1.3B [arXiv:2405.04517; unverified]: 48 blocks, d_model 2048,
4 heads, no separate FFN (d_ff=0; projections live inside the m/sLSTM
blocks), vocab 50304, xLSTM[7:1] (one sLSTM block per 8), recurrent =>
O(1)-state decode, long_500k runs."""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_type="none",
    xlstm=XLSTMConfig(slstm_every=8),
    sub_quadratic=True,
    source="arXiv:2405.04517",
)
