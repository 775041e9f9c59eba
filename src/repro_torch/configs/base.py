"""Architecture config system: one frozen dataclass per assigned arch.

A copy of the reference's ``repro/configs`` (which imports no jax), so the
port imports nothing of ``repro``.  ``get_config(arch_id)`` resolves the
full published config; ``cfg.reduced()`` gives the same *family* at
smoke-test scale (tiny widths, few layers/experts) for the per-arch CPU
tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0          # kimi: first layer(s) dense
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8       # xLSTM[7:1]: one sLSTM block per 8
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    chunk_size: int = 256
    qkv_blocksize: int = 4     # block-diagonal q/k/v (paper's qkv_proj_blocksize)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | audio | vlm | ssm
    num_layers: int              # decoder layers for enc-dec
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // num_heads
    mlp_type: str = "swiglu"     # swiglu | geglu | gelu | relu2
    norm_type: str = "rmsnorm"
    rope_type: str = "rope"      # rope | partial | mrope | none
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 => full attention
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    attn_every: int = 0          # hybrid: one attention layer per this many (jamba=8)
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder_layers: int = 0      # >0 => encoder-decoder
    modality_stub: str = ""      # '' | 'audio_frames' | 'image_patches'
    stub_frames: int = 1024      # encoder frame count for audio stub
    img_patches: int = 256       # image patch count for vlm stub
    sub_quadratic: bool = False  # eligible for long_500k
    source: str = ""
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ArchConfig":
        """Same family, smoke-test scale."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4 if (self.attn_every or self.xlstm) else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            attn_every=2 if self.attn_every else 0,
            moe=None if self.moe is None else dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=8.0),  # no drops at smoke scale => exact tests
            mamba=None if self.mamba is None else dataclasses.replace(
                self.mamba, d_state=8, d_conv=4, expand=2),
            xlstm=None if self.xlstm is None else dataclasses.replace(
                self.xlstm, slstm_every=2, chunk_size=16),
            encoder_layers=2 if self.encoder_layers else 0,
            stub_frames=32,
            img_patches=16,
        )


ARCH_IDS = [
    "gemma-2b", "starcoder2-7b", "minitron-4b", "stablelm-1.6b",
    "jamba-v0.1-52b", "seamless-m4t-large-v2", "mixtral-8x22b",
    "kimi-k2-1t-a32b", "qwen2-vl-72b", "xlstm-1.3b",
]

_MODULES = {
    "gemma-2b": "gemma_2b",
    "starcoder2-7b": "starcoder2_7b",
    "minitron-4b": "minitron_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mixtral-8x22b": "mixtral_8x22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
