"""Dense FFN variants: SwiGLU / GeGLU / GELU / squared-ReLU."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.context import DISABLED, ShardCtx
from repro_torch.models.nn import Init, gelu, silu


class FFN(nn.Module):
    def __init__(self, init: Init, d: int, d_ff: int, mlp_type: str, dtype):
        super().__init__()
        self.w_up = init.dense((d, d_ff), dtype, ("embed", "ffn"))
        self.w_down = init.dense((d_ff, d), dtype, ("ffn", "embed"))
        if mlp_type in ("swiglu", "geglu"):
            self.w_gate = init.dense((d, d_ff), dtype, ("embed", "ffn"))


def _act(h, mlp_type: str):
    if mlp_type == "gelu":
        return gelu(h)
    if mlp_type == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(mlp_type)


def ffn_apply(p: FFN, x, mlp_type: str, ctx: ShardCtx | None = None):
    ctx = ctx or DISABLED
    if mlp_type in ("swiglu", "geglu"):
        gate = x @ p.w_gate
        up = x @ p.w_up
        gate = silu(gate) if mlp_type == "swiglu" else gelu(gate)
        h = gate * up
    else:
        h = _act(x @ p.w_up, mlp_type)
    h = ctx.constrain(h, ("batch", "seq", "ffn"))
    return ctx.constrain(h @ p.w_down, ("batch", "seq", "embed"))
