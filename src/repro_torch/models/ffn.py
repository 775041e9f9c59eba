"""Dense FFN variants: SwiGLU / GeGLU / GELU / squared-ReLU.

On a mesh (``ffn_lanes``): ``w_up`` and ``w_gate`` column-parallel over
the 'ffn' dim, ``w_down`` row-parallel with a ``psum`` over 'model', the
FSDP split of 'embed' all-gathered first; a spec that leaves the ffn dim
whole leaves the layer whole on every lane."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import spmd
from repro_torch.dist.context import DISABLED, ShardCtx
from repro_torch.models.nn import (Init, dense_spec, gelu, lane_weights, silu,
                                   spec_of, split_over_model)


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


def _hidden(x, w, mlp_type: str):
    if mlp_type in ("swiglu", "geglu"):
        gate = x @ w.w_gate
        up = x @ w.w_up
        gate = silu(gate) if mlp_type == "swiglu" else gelu(gate)
        return gate * up
    return _act(x @ w.w_up, mlp_type)


def ffn_apply(p: FFN, x, mlp_type: str, ctx: ShardCtx | None = None):
    ctx = ctx or DISABLED
    h = ctx.constrain(_hidden(x, p, mlp_type), ("batch", "seq", "ffn"))
    return ctx.constrain(h @ p.w_down, ("batch", "seq", "embed"))


def ffn_lanes(p: FFN, x, mlp_type: str, ctx: ShardCtx):
    """The FFN on lanes (module docstring): ``x`` a lanes array split over
    the batch axes -> the output's, whole over 'model'."""
    w = lane_weights(p, ctx)
    y = spmd.lanewise(lambda wl, xl: _hidden(xl, wl, mlp_type) @ wl.w_down,
                      w, x)
    if split_over_model(dense_spec(spec_of(p.w_down, ctx), ctx), 0):
        y = spmd.psum(y, "model", ctx.mesh)
    return y
