"""Mixture-of-Experts: sort-based, capacity-bounded dispatch, on one
device or expert-parallel (EP) over a mesh's lanes.

The router's top-k assignment marks which experts ("shards") a token
updates; only those are touched.  Tokens above an expert's capacity are
dropped.  Which ones is decided by a *stable* sort of the (token, choice)
slots by expert, so the earlier slots keep their places, as in the
reference.  No [T, E, C] one-hot tensor is built, and nothing here reads a
value back to the host.

Three execution paths, as the reference's:
  * local — every expert on one device: batched GEMMs over [E, C, d];
  * EP a2a — experts split over the 'experts' rule's mesh axis; each data
    lane routes its *own* tokens (capacity from T_local), and a pair of
    ``all_to_all``s moves capacity slots to their experts' lanes and back;
  * EP replicated — tokens already replicated over the expert axis: each
    lane gathers the slots of its own experts from its copy of x, and one
    float32 ``psum`` combines.
On a mesh every path runs lane by lane (``dist.spmd``, ``moe_lanes``) on
the tokens of the lane's data shard and the expert weights the lane
holds (``nn.ShardedParameter``): each weight's split other than the EP
layout's (the FSDP split of 'embed') is all-gathered just before its
GEMM, one weight at a time, and the router whole.  The local path on a
mesh (the experts do not divide the EP axis) routes the tokens of every
data shard, gathered, on every lane: the reference's capacity from the
global T, its expert GEMMs repeated on each lane.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.dist import spmd
from repro_torch.dist.context import DISABLED, P, ShardCtx
from repro_torch.models.ffn import FFN, ffn_apply, ffn_lanes
from repro_torch.models.nn import Init, gather_to, gelu, silu


class MoE(nn.Module):
    def __init__(self, init: Init, d: int, moe: MoEConfig, mlp_type: str,
                 dtype):
        super().__init__()
        E, f = moe.num_experts, moe.d_ff_expert
        self.router = init.dense((d, E), torch.float32,
                                 ("embed", "experts"))
        self.w_up = init.dense((E, d, f), dtype,
                               ("experts", "embed", "expert_ff"))
        self.w_down = init.dense((E, f, d), dtype,
                                 ("experts", "expert_ff", "embed"))
        if mlp_type in ("swiglu", "geglu"):
            self.w_gate = init.dense((E, d, f), dtype,
                                     ("experts", "embed", "expert_ff"))
        if moe.num_shared_experts:
            self.shared = FFN(init, d, f * moe.num_shared_experts, mlp_type,
                              dtype)


def _expert_ffn(xe, w_up, w_down, w_gate, mlp_type: str):
    """xe: [E, C, d] -> [E, C, d] (batched per-expert GEMMs)."""
    if mlp_type in ("swiglu", "geglu"):
        gate = torch.bmm(xe, w_gate)
        up = torch.bmm(xe, w_up)
        gate = silu(gate) if mlp_type == "swiglu" else gelu(gate)
        h = gate * up
    else:
        h = gelu(torch.bmm(xe, w_up))
    return torch.bmm(h, w_down)


def _gather_slots(xf, dispatch_idx):
    """xf [T, d] -> the [E, C, d] capacity slots (zeros where empty)."""
    safe = torch.clamp_min(dispatch_idx, 0).long()
    return xf[safe] * (dispatch_idx >= 0)[..., None].to(xf.dtype)


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


def moe_apply(p: MoE, x, moe: MoEConfig, mlp_type: str,
              ctx: ShardCtx | None = None):
    """x: [B, S, d] -> ([B, S, d], aux_loss).  On an enabled ``ctx`` the
    batch is split over the data axes and ``moe_lanes`` runs it."""
    ctx = ctx or DISABLED
    B, S, d = x.shape
    if ctx.enabled:
        dp = ctx.rules.get("batch")
        y, aux = moe_lanes(p, spmd.shard(x, P(dp), ctx.mesh), moe, mlp_type,
                           ctx)
        return (spmd.unshard(y, P(dp), ctx.mesh),
                spmd.unshard(aux, P(), ctx.mesh))
    T = B * S
    xf = x.reshape(T, d)
    dispatch_idx, combine_w, aux = _route(p.router, xf, moe,
                                          capacity_of(moe, T))
    xe = _gather_slots(xf, dispatch_idx)                 # [E, C, d]
    ye = _expert_ffn(xe, p.w_up, p.w_down, getattr(p, "w_gate", None),
                     mlp_type)
    y = _combine(ye, dispatch_idx, combine_w, T, x.dtype)
    if hasattr(p, "shared"):
        y = y + ffn_apply(p.shared, x, mlp_type, ctx).reshape(T, d)
    return y.reshape(B, S, d), aux


def moe_lanes(p: MoE, x, moe: MoEConfig, mlp_type: str, ctx: ShardCtx):
    """The layer on lanes: ``x`` a lanes array [B_l, S, d] split over the
    batch axes -> (y lanes, whole over 'model'; aux lanes, the same on
    every lane)."""
    ep = ctx.axis_size("experts")
    # EP needs the expert count to divide the mesh axis (kimi 384, jamba
    # 16); otherwise TP-MoE: the local path (mixtral's 8 experts on a
    # 16-way axis)
    use_ep = ep > 1 and moe.num_experts % ep == 0
    # 'replicated' EP needs the tokens replicated over the EP axis: true
    # when experts shard over 'model', false for the serve 2-D layout
    # where they shard over 'data' (the token axis)
    ep_axis = ctx.rules.get("experts")
    dp = ctx.rules.get("batch") or ()
    dp_flat = (dp,) if isinstance(dp, str) else tuple(dp)
    replicated_ok = ep_axis not in dp_flat
    xf = spmd.lanewise(lambda t: t.reshape(-1, t.shape[-1]), x)
    if use_ep and ctx.ep_mode == "replicated" and replicated_ok:
        y, aux = _moe_ep_replicated(p, xf, moe, mlp_type, ctx)
    elif use_ep:
        y, aux = _moe_ep(p, xf, moe, mlp_type, ctx)
    else:
        y, aux = _moe_local_lanes(p, xf, moe, mlp_type, ctx)
    if hasattr(p, "shared"):
        y = spmd.lanewise(lambda a, b: a + b.reshape(a.shape), y,
                          ffn_lanes(p.shared, x, mlp_type, ctx))
    return spmd.lanewise(lambda t, xl: t.reshape(xl.shape), y, x), aux


def _combine(ye, dispatch_idx, combine_w, T: int, dtype):
    """Scatter-add expert outputs back to token order with routing weights."""
    w = combine_w[..., None].to(ye.dtype)
    flat_idx = torch.where(dispatch_idx >= 0, dispatch_idx, T).reshape(-1)
    contrib = (ye * w).reshape(-1, ye.shape[-1])
    y = torch.zeros((T + 1, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    y.index_add_(0, flat_idx.long(), contrib)
    return y[:T].to(dtype)


def _expert_ffn_lanes(xe, p: MoE, mlp_type: str, ctx: ShardCtx, up_spec,
                      dn_spec):
    """``_expert_ffn`` on lanes, each expert weight laid out by its spec
    (``gather_to``) just before its GEMM and dropped after it, so one
    gathered weight is alive at a time."""
    def bmm(t, w, spec):
        return spmd.lanewise(torch.bmm, t, gather_to(w, spec, ctx))
    if mlp_type in ("swiglu", "geglu"):
        gate = bmm(xe, p.w_gate, up_spec)
        up = bmm(xe, p.w_up, up_spec)
        h = spmd.lanewise(lambda g, u: (silu(g) if mlp_type == "swiglu"
                                        else gelu(g)) * u, gate, up)
        del gate, up
    else:
        h = spmd.lanewise(gelu, bmm(xe, p.w_up, up_spec))
    return bmm(h, p.w_down, dn_spec)


def _ep_capacity(xf, moe: MoEConfig) -> int:
    """The capacity of one data shard's tokens."""
    return capacity_of(moe, xf.flat[0].shape[0])


def _ep_aux(aux, ctx: ShardCtx):
    """``aux`` averaged over the data axes."""
    dp = ctx.rules.get("batch")
    return aux if dp is None else spmd.pmean(aux, dp, ctx.mesh)


def _moe_ep(p: MoE, xf, moe: MoEConfig, mlp_type: str, ctx: ShardCtx):
    """Expert-parallel path (a DP x EP grid, DeepSpeed-MoE style).

    Tokens stay split over the data axes; each lane routes its *local*
    tokens (dispatch buffers scale with T_local, not the global T), then
    a pair of ``all_to_all``s over the 'experts' axis moves capacity slots
    to their experts' lanes and back.  In the serve 2-D layout the expert
    ff dim is split over a second axis too, and a ``psum`` over it follows
    the down projection.
    """
    mesh = ctx.mesh
    axis = ctx.rules.get("experts")
    ff_axis = ctx.weight_rules.get("expert_ff")
    ff_axis = ff_axis if isinstance(ff_axis, str) and ff_axis != axis else None
    router = gather_to(p.router, P(), ctx)
    cap = _ep_capacity(xf, moe)

    def route(x_b, r):
        di, cw, aux = _route(r, x_b, moe, cap)
        return di, cw, aux, _gather_slots(x_b, di)

    di, cw, aux, xe = spmd.lanewise(route, xf, router)
    del router
    xe = spmd.all_to_all(xe, axis, 0, 1, mesh)
    ye = _expert_ffn_lanes(xe, p, mlp_type, ctx, P(axis, None, ff_axis),
                           P(axis, ff_axis, None))
    if ff_axis is not None:  # the down projection contracted a split dim
        ye = spmd.psum(ye, ff_axis, mesh)
    ye = spmd.all_to_all(ye, axis, 1, 0, mesh)
    y = spmd.lanewise(
        lambda e, i, w, x_b: _combine(e, i, w, x_b.shape[0], x_b.dtype),
        ye, di, cw, xf)
    return y, _ep_aux(aux, ctx)


def _moe_ep_replicated(p: MoE, xf, moe: MoEConfig, mlp_type: str,
                       ctx: ShardCtx):
    """No-token-movement EP: the tokens are already replicated over the
    'experts' axis (they split over the data axes only), so each lane
    routes its local tokens, gathers the slots of its *own* E/ep experts
    from its copy of x, runs their GEMMs, scatters into a float32 partial
    y, and one ``psum`` over the EP axis combines before the cast back."""
    mesh = ctx.mesh
    axis = ctx.rules.get("experts")
    E_local = moe.num_experts // ctx.axis_size("experts")
    router = gather_to(p.router, P(), ctx)
    cap = _ep_capacity(xf, moe)

    def route(x_b, r, me):
        di, cw, aux = _route(r, x_b, moe, cap)  # the full dispatch, local
        sl = int(me) * E_local
        di_loc, cw_loc = di[sl:sl + E_local], cw[sl:sl + E_local]
        return di_loc, cw_loc, aux, _gather_slots(x_b, di_loc)

    di, cw, aux, xe = spmd.lanewise(route, xf, router,
                                    spmd.axis_index(mesh, axis))
    del router
    ye = _expert_ffn_lanes(xe, p, mlp_type, ctx, P(axis), P(axis))
    y_part = spmd.lanewise(
        lambda e, i, w, x_b: _combine(e, i, w, x_b.shape[0], torch.float32),
        ye, di, cw, xf)
    y = spmd.lanewise(lambda t, x_b: t.to(x_b.dtype),
                      spmd.psum(y_part, axis, mesh), xf)
    return y, _ep_aux(aux, ctx)


def _moe_local_lanes(p: MoE, xf, moe: MoEConfig, mlp_type: str,
                     ctx: ShardCtx):
    """The local path on a mesh (module docstring): every data shard's
    tokens gathered on every lane and routed with the global capacity,
    every expert's GEMMs on every lane, and each lane's own rows of y."""
    mesh = ctx.mesh
    dp = ctx.rules.get("batch")
    xa = (xf if dp is None else
          spmd.all_gather(xf, dp, 0, mesh, label="MoE local path tokens"))
    T, T_local = xa.flat[0].shape[0], xf.flat[0].shape[0]
    router = gather_to(p.router, P(), ctx)
    di, cw, aux = spmd.lanewise(
        lambda x_b, r: _route(r, x_b, moe, capacity_of(moe, T)), xa, router)
    del router
    xe = spmd.lanewise(_gather_slots, xa, di)
    ye = _expert_ffn_lanes(xe, p, mlp_type, ctx, P(), P())
    y = spmd.lanewise(
        lambda e, i, w, x_b: _combine(e, i, w, T, x_b.dtype), ye, di, cw, xf)
    b = (spmd.axis_index(mesh, dp) if dp is not None
         else np.zeros(mesh.devices.shape, dtype=np.int64))
    return spmd.lanewise(lambda t, k: t.narrow(0, int(k) * T_local, T_local),
                         y, b), aux
