"""Mixture-of-Experts on one device: sort-based, capacity-bounded dispatch.

The router's top-k assignment marks which experts ("shards") a token
updates; only those are touched.  Tokens above an expert's capacity are
dropped.  Which ones is decided by a *stable* sort of the (token, choice)
slots by expert, so the earlier slots keep their places, as in the
reference.  No [T, E, C] one-hot tensor is built, and nothing here reads a
value back to the host.  The expert-parallel paths over a mesh are not
ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.nn import Init, gelu, silu


class MoE(nn.Module):
    def __init__(self, init: Init, d: int, moe: MoEConfig, mlp_type: str,
                 dtype):
        super().__init__()
        E, f = moe.num_experts, moe.d_ff_expert
        self.router = init.dense((d, E), torch.float32)
        self.w_up = init.dense((E, d, f), dtype)
        self.w_down = init.dense((E, f, d), dtype)
        if mlp_type in ("swiglu", "geglu"):
            self.w_gate = init.dense((E, d, f), dtype)
        if moe.num_shared_experts:
            self.shared = FFN(init, d, f * moe.num_shared_experts, mlp_type,
                              dtype)


def _expert_ffn(p: MoE, xe, mlp_type: str):
    """xe: [E, C, d] -> [E, C, d] (batched per-expert GEMMs)."""
    if mlp_type in ("swiglu", "geglu"):
        gate = torch.bmm(xe, p.w_gate)
        up = torch.bmm(xe, p.w_up)
        gate = silu(gate) if mlp_type == "swiglu" else gelu(gate)
        h = gate * up
    else:
        h = gelu(torch.bmm(xe, p.w_up))
    return torch.bmm(h, p.w_down)


def _route(router, xf, moe: MoEConfig, capacity: int):
    """Sort-based capacity dispatch.

    xf: [T, d] -> (dispatch_idx [E, C] int32 (token index or -1),
                   combine_w [E, C] float32, aux loss [] float32)
    """
    T = xf.shape[0]
    E, k = moe.num_experts, moe.top_k
    dev = xf.device
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)          # [T, k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(-1)                            # [T*k]
    flat_w = top_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)            # group by expert
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # position of each slot within its expert group
    start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - start[se]
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, E * capacity)  # overflow
    dispatch_idx = torch.full((E * capacity + 1,), -1, dtype=torch.int32,
                              device=dev)
    dispatch_idx[slot] = torch.where(keep, st, -1).to(torch.int32)
    combine_w = torch.zeros(E * capacity + 1, dtype=torch.float32,
                            device=dev)
    combine_w[slot] = torch.where(keep, sw, 0.0)
    # load-balancing auxiliary loss (Switch-style); no bincount, whose
    # output length would need the maximum read back to the host
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_w)) / (T * k)
    aux = E * torch.sum(me * ce)
    return (dispatch_idx[: E * capacity].reshape(E, capacity),
            combine_w[: E * capacity].reshape(E, capacity), aux)


def capacity_of(moe: MoEConfig, tokens: int) -> int:
    return max(-(-int(moe.capacity_factor * tokens * moe.top_k)
                 // moe.num_experts), 1)


def moe_apply(p: MoE, x, moe: MoEConfig, mlp_type: str):
    """x: [B, S, d] -> ([B, S, d], aux_loss)."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    dispatch_idx, combine_w, aux = _route(p.router, xf, moe,
                                          capacity_of(moe, T))
    safe = torch.clamp_min(dispatch_idx, 0).long()
    xe = xf[safe] * (dispatch_idx >= 0)[..., None].to(x.dtype)  # [E, C, d]
    ye = _expert_ffn(p, xe, mlp_type)
    y = _combine(ye, dispatch_idx, combine_w, T, x.dtype)
    if hasattr(p, "shared"):
        y = y + ffn_apply(p.shared, x, mlp_type).reshape(T, d)
    return y.reshape(B, S, d), aux


def _combine(ye, dispatch_idx, combine_w, T: int, dtype):
    """Scatter-add expert outputs back to token order with routing weights."""
    w = combine_w[..., None].to(ye.dtype)
    flat_idx = torch.where(dispatch_idx >= 0, dispatch_idx, T).reshape(-1)
    contrib = (ye * w).reshape(-1, ye.shape[-1])
    y = torch.zeros((T + 1, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    y.index_add_(0, flat_idx.long(), contrib)
    return y[:T].to(dtype)
