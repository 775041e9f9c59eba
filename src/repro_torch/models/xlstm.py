"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunk-parallel)
and sLSTM (scalar memory, strictly sequential recurrence).

mLSTM runs a chunkwise linear-attention form.  With F_t = sum_{r<=t} log f_r
within the chunk and the inbound stabilised state (C, n, m_in):

  D_tj  = exp(F_t - F_j + log i_j)          (intra-chunk pair decay, j <= t)
  m_t   = max(max_j log D_tj, F_t + m_in)   (stabiliser)
  num_t = sum_j e^{logD - m_t} (q.k_j) v_j + e^{F_t + m_in - m_t} q.C
  den_t = sum_j e^{logD - m_t} (q.k_j)     + e^{F_t + m_in - m_t} q.n
  y_t   = num_t / max(|den_t|, e^{-m_t})

which reduces to the O(1) decode step at chunk length 1.  The stabiliser
``m`` starts at ``NEG`` and the padded steps of a short last chunk are
identities (log i = NEG, log f = 0), as in the reference.  sLSTM keeps a
true sequential loop: its gates feed back through h_{t-1}.

On a mesh (``mlstm_lanes``, ``slstm_lanes``) both blocks are tensor
parallel over 'model', as the reference's specs split them.  mLSTM: ``up``
column-parallel, regrouped to each lane's channels of ``xr`` and of the
skip (``nn.regroup_halves``); q, k and v from the lane's blocks, which
are its heads' channels; ``wi`` and ``wf`` read every channel, so ``xr``
is gathered over 'model' for the lane's heads' gates; the recurrence on
the lane's heads; ``ogate`` column-parallel; ``down`` row-parallel with a
``psum``.  sLSTM: ``wx`` and ``b`` give the lane its channels of each
gate, ``r`` its heads, and the loop runs on them; ``up`` reads the whole
h, gathered over 'model'; ``down`` row-parallel with a ``psum``.  The
states are split over the batch only (``model.cache_spec``): a lane
reads its heads or channels and the new state is gathered back
(``nn.state_in``/``state_out``).  No weight is gathered over 'model'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import XLSTMConfig
from repro_torch.dist import spmd
from repro_torch.dist.context import DISABLED, ShardCtx
from repro_torch.models.nn import (RECURRENT, Init, const, gelu, lane_weights,
                                   model_index, model_lanes, model_split,
                                   own_slice, regroup_halves, silu, state_in,
                                   state_out)

NEG = -1e30


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
class MLSTM(nn.Module):
    def __init__(self, init: Init, d: int, num_heads: int, xc: XLSTMConfig,
                 dtype):
        super().__init__()
        f32 = torch.float32
        di = int(d * xc.proj_factor_mlstm)
        bs = min(xc.qkv_blocksize, di)
        nb = di // bs
        self.up = init.dense((d, 2 * di), dtype, ("embed", "mamba_inner"))
        # block-diagonal projections (the paper's qkv_proj_blocksize)
        self.wq = init.dense((nb, bs, bs), dtype, ("mamba_inner", None, None))
        self.wk = init.dense((nb, bs, bs), dtype, ("mamba_inner", None, None))
        self.wv = init.dense((nb, bs, bs), dtype, ("mamba_inner", None, None))
        self.wi = init.dense((di, num_heads), f32, (None, "lstm_heads"),
                             scale=0.01)
        self.wf = init.dense((di, num_heads), f32, (None, "lstm_heads"),
                             scale=0.01)
        self.bi = init.full((num_heads,), 0.0, f32, ("lstm_heads",))
        self.bf = init.full((num_heads,), 3.0, f32, ("lstm_heads",))
        self.ogate = init.dense((d, di), dtype, ("embed", "mamba_inner"))
        self.down = init.dense((di, d), dtype, ("mamba_inner", "embed"))


def init_mlstm_state(B: int, H: int, hd: int, device=None) -> dict:
    f32 = torch.float32
    return {
        "C": torch.zeros((B, H, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((B, H, hd), dtype=f32, device=device),
        "m": torch.full((B, H), NEG, dtype=f32, device=device),
    }


def _mlstm_step(q, k, v, li, lf, state):
    """One recurrent step (decode).  q/k/v: [B,H,hd]; li/lf: [B,H] (log)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    f = torch.exp(lf + m - m_new)[..., None]
    i = torch.exp(li - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C_new = f[..., None] * C + (i * kf)[..., None] * vf[..., None, :]
    n_new = f * n + i * kf
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, C_new)
    den = torch.abs(torch.einsum("bhk,bhk->bh", qf, n_new))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y, {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_chunked(q, k, v, li, lf, state, chunk: int):
    """[B,S,H,hd] inputs, [B,S,H] log gates -> (y [B,S,H,hd] float32,
    final state)."""
    B, S, H, hd = q.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:  # identity steps: i-gate -inf (no write), f-gate 0 (no decay)
        zpad = (0, 0, 0, 0, 0, pad)
        q, k, v = (F.pad(t, zpad) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=q.device))
    C, n, m = state["C"], state["n"], state["m"]
    ys = []
    for j in range(0, nc * Q, Q):
        qf = q[:, j:j + Q].float()
        kf = k[:, j:j + Q].float()
        vf = v[:, j:j + Q].float()
        lib, lfb = li[:, j:j + Q], lf[:, j:j + Q]            # [B,Q,H]
        Fc = torch.cumsum(lfb, dim=1)
        g = Fc[:, :, None, :] - Fc[:, None, :, :] + lib[:, None, :, :]
        g = torch.where(causal[None, :, :, None], g, NEG)   # [B,t,j,H]
        a_state = Fc + m[:, None]                            # [B,Q,H]
        m_t = torch.maximum(g.amax(dim=2), a_state)
        w = torch.exp(g - m_t[:, :, None, :])
        s = torch.einsum("bthk,bjhk->btjh", qf, kf)
        sw = s * w
        dec = torch.exp(a_state - m_t)                       # [B,Q,H]
        num = (torch.einsum("btjh,bjhv->bthv", sw, vf)
               + torch.einsum("bthk,bhkv->bthv", qf, C) * dec[..., None])
        den = sw.sum(dim=2) + torch.einsum("bthk,bhk->bth", qf, n) * dec
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # outbound state (stabilised at m_out)
        gQ = g[:, -1]                            # [B,j,H] decay to chunk end
        m_out = torch.maximum(a_state[:, -1], gQ.amax(dim=1))
        wq = torch.exp(gQ - m_out[:, None])
        decQ = torch.exp(a_state[:, -1] - m_out)
        C = decQ[..., None, None] * C + torch.einsum("bjh,bjhk,bjhv->bhkv",
                                                     wq, kf, vf)
        n = decQ[..., None] * n + torch.einsum("bjh,bjhk->bhk", wq, kf)
        m = m_out
    y = torch.cat(ys, dim=1)[:, :S]
    return y, {"C": C, "n": n, "m": m}


def _blockdiag(t, w):
    """[B, S, c] x the block-diagonal [c / bs, bs, bs] -> [B, S, c]."""
    B, S, c = t.shape
    nb, bs = w.shape[0], w.shape[1]
    y = torch.einsum("bsnk,nkl->bsnl", t.reshape(B, S, nb, bs), w)
    return y.reshape(B, S, c)


def _mlstm_qkv(p, xr, hd: int):
    """q (scaled), k, v [B, S, c] on the channels ``xr`` and ``p``'s
    blocks hold."""
    q = _blockdiag(xr, p.wq)
    q = q * const(hd ** -0.5, q)
    return q, _blockdiag(xr, p.wk), _blockdiag(xr, p.wv)


def _mlstm_gates(p, xr):
    """The log input and forget gates [B, S, h] of the heads ``p`` holds,
    from the whole ``xr``."""
    li = xr.float() @ p.wi + p.bi
    lf = F.logsigmoid(xr.float() @ p.wf + p.bf)
    return li, lf


def _mlstm_heads(q, k, v, li, lf, state, hd: int, chunk: int):
    """The recurrence on [B, S, c] q, k, v (c / hd heads) -> (y [B, S, c]
    float32, the new state)."""
    B, S, c = q.shape
    q, k, v = (t.reshape(B, S, c // hd, hd) for t in (q, k, v))
    if S == 1:
        y, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                                   lf[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = _mlstm_chunked(q, k, v, li, lf, state, chunk)
    return y.reshape(B, S, c), new_state


def _mlstm_out(p, y, x, res):
    """The output gate, the skip and ``down`` (before any ``psum``)."""
    y = y.to(x.dtype)
    y = y * silu(x @ p.ogate)
    y = y + res
    return y @ p.down


def mlstm_apply(p: MLSTM, x, num_heads: int, xc: XLSTMConfig,
                ctx: ShardCtx | None = None, *, state: dict | None = None):
    """x: [B, S, d] -> (y, new_state)."""
    B, S, d = x.shape
    xr, res = (x @ p.up).chunk(2, dim=-1)
    di = xr.shape[-1]
    H = num_heads
    hd = di // H
    q, k, v = _mlstm_qkv(p, xr, hd)
    li, lf = _mlstm_gates(p, xr)
    if state is None:
        state = init_mlstm_state(B, H, hd, x.device)
    y, new_state = _mlstm_heads(q, k, v, li, lf, state, hd, xc.chunk_size)
    ctx = ctx or DISABLED
    return (ctx.constrain(_mlstm_out(p, y, x, res), ("batch", "seq", "embed")),
            new_state)


def _state_lanes(cache: dict | None, dim: int, own: bool, ctx):
    """A lanes array of the state dicts the lanes compute on, from the
    cache's ``spmd.Lanes`` (``nn.state_in``); None without a cache."""
    if cache is None:
        return None
    parts = {k: state_in(t, dim, own, ctx) for k, t in cache.items()}
    return spmd.lanewise(lambda *ts: dict(zip(parts, ts)), *parts.values())


def _state_back(cache: dict | None, new, dim: int, own: bool, ctx) -> None:
    if cache is not None:
        for k, t in cache.items():
            state_out(t, spmd.lanewise(lambda st: st[k], new), dim, own,
                      ctx)


def mlstm_lanes(p: MLSTM, x, num_heads: int, xc: XLSTMConfig, ctx: ShardCtx,
                *, cache: dict | None = None):
    """The block on lanes, tensor parallel over 'model' (module
    docstring).  ``x``: a lanes array split over the batch axes;
    ``cache``: the layer's ``{"C", "n", "m"}`` as ``spmd.Lanes``, updated
    in place.  -> the output's lanes array, whole over 'model'.

    Where 'model' does not split the heads (H % tp != 0: xlstm-1.3b's 4
    heads on 16 'model' lanes) the lanes gather q, k and v and compute
    the gates and the recurrence replicated, on every head, then keep
    their channels."""
    mesh = ctx.mesh
    tp = model_lanes(mesh)
    w = lane_weights(p, ctx)
    own = model_split(p.ogate, ctx, 1)      # the lane's di/tp channels
    heads = model_split(p.wi, ctx, 1)       # ... which are its H/tp heads
    if own != model_split(p.wq, ctx, 0):
        raise ValueError(f"mlstm_lanes: the q/k/v blocks and the channels "
                         f"split unevenly over {tp} 'model' lanes")
    xr, res = regroup_halves(spmd.lanewise(lambda wl, t: t @ wl.up, w, x),
                             model_split(p.up, ctx, 1), own, ctx)
    hd = p.up.shape[1] // 2 // num_heads
    q, k, v = spmd.lanewise(lambda wl, t: _mlstm_qkv(wl, t, hd), w, xr)
    xw = (spmd.all_gather(xr, "model", 2, mesh, label=RECURRENT) if own
          else xr)                          # wi, wf read every channel
    li, lf = spmd.lanewise(_mlstm_gates, w, xw)
    if not heads and own:
        q, k, v = (spmd.all_gather(t, "model", 2, mesh, label=RECURRENT)
                   for t in (q, k, v))
    state = _state_lanes(cache, 1, heads, ctx)
    if state is None:
        state = spmd.lanewise(lambda t: init_mlstm_state(
            t.shape[0], t.shape[2] // hd, hd, t.device), q)
    y, new = spmd.lanewise(
        lambda a, b, c, i, f, st: _mlstm_heads(a, b, c, i, f, st, hd,
                                               xc.chunk_size),
        q, k, v, li, lf, state)
    _state_back(cache, new, 1, heads, ctx)
    if not heads and own:                   # the lane's channels
        y = spmd.lanewise(lambda t, m: own_slice(t, 2, m, tp), y,
                          model_index(mesh))
    out = spmd.lanewise(_mlstm_out, w, y, x, res)
    if model_split(p.down, ctx, 0):         # row-parallel
        out = spmd.psum(out, "model", mesh)
    return out


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
class SLSTM(nn.Module):
    def __init__(self, init: Init, d: int, num_heads: int, xc: XLSTMConfig,
                 dtype):
        super().__init__()
        dh = d // num_heads
        dff = int(d * xc.proj_factor_slstm)
        self.wx = init.dense((d, 4, d), dtype, ("embed", None, "mamba_inner"))
        self.r = init.dense((num_heads, dh, 4, dh), dtype,
                            ("lstm_heads", None, None, None), scale=dh ** -0.5)

        def bias(dev):  # forget-gate bias 3
            b = torch.zeros((4, d), dtype=torch.float32, device=dev)
            b[1] = 3.0
            return b
        self.b = init.tensor(bias, (4, d), torch.float32,
                             (None, "mamba_inner"))
        self.up = init.dense((d, 2 * dff), dtype, ("embed", "ffn"))
        self.down = init.dense((dff, d), dtype, ("ffn", "embed"))


def init_slstm_state(B: int, d: int, device=None) -> dict:
    z = torch.zeros((B, d), dtype=torch.float32, device=device)
    return {"c": z, "n": z + 1e-6, "h": z, "m": z + NEG}


def _slstm_step(xproj, r, state, num_heads: int):
    """xproj: [B, 4, d] precomputed input projection; recurrent part here."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    B, _, d = xproj.shape
    dh = d // num_heads
    hh = h.reshape(B, num_heads, dh)
    rec = torch.einsum("bhk,hkgl->bghl", hh.to(r.dtype), r).reshape(B, 4, d)
    gates = xproj.float() + rec.float()
    li, lf, z, o = gates[:, 0], gates[:, 1], gates[:, 2], gates[:, 3]
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(lf + m, li)
    f = torch.exp(lf + m - m_new)
    i = torch.exp(li - m_new)
    c_new = f * c + i * torch.tanh(z)
    n_new = f * n + i
    h_new = torch.sigmoid(o) * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_proj(p, x):
    # bf16 projection + float32 bias -> float32, as in the reference
    return torch.einsum("bsd,dge->bsge", x, p.wx) + p.b


def _slstm_scan(xproj, r, state, num_heads: int, dtype):
    """The sequential loop over S on the heads ``r`` holds -> (hs [B, S,
    c] in ``dtype``, the final state)."""
    hs = []
    for t in range(xproj.shape[1]):
        h, state = _slstm_step(xproj[:, t], r, state, num_heads)
        hs.append(h)
    return torch.stack(hs, dim=1).to(dtype), state


def _slstm_hidden(gate, up):
    return gelu(gate) * up


def slstm_apply(p: SLSTM, x, num_heads: int, ctx: ShardCtx | None = None,
                *, state: dict | None = None):
    """x: [B, S, d] -> (y, new_state).  Sequential over S (true
    recurrence)."""
    B, S, d = x.shape
    xproj = _slstm_proj(p, x)
    if state is None:
        state = init_slstm_state(B, d, x.device)
    hs, state = _slstm_scan(xproj, p.r, state, num_heads, x.dtype)
    # gated up/down projection FFN (proj factor 4/3)
    gate, up = (hs @ p.up).chunk(2, dim=-1)
    y = _slstm_hidden(gate, up) @ p.down
    return (ctx or DISABLED).constrain(y, ("batch", "seq", "embed")), state


def slstm_lanes(p: SLSTM, x, num_heads: int, ctx: ShardCtx, *,
                cache: dict | None = None):
    """The block on lanes, tensor parallel over 'model' (module
    docstring).  ``x``: a lanes array split over the batch axes;
    ``cache``: the layer's ``{"c", "n", "h", "m"}`` as ``spmd.Lanes``,
    updated in place.  -> the output's lanes array, whole over 'model'.

    With the heads split (H % tp == 0) a lane's channels are whole heads
    and the S-step loop runs with no collective in it.  Where 'model'
    does not split the heads, the lanes gather the input projection and
    run the loop replicated, on every head.  Where it does not split the
    FFN's ``down`` (``dff`` % tp != 0), the lanes gather ``up``'s output
    and each computes its 1/tp of ``down``'s output columns, then a
    gather (each product computed once)."""
    mesh = ctx.mesh
    tp = model_lanes(mesh)
    me = model_index(mesh)
    w = lane_weights(p, ctx)
    own = model_split(p.wx, ctx, 2)         # the lane's d/tp channels
    heads = model_split(p.r, ctx, 0)        # ... which are its H/tp heads
    dtype = x.flat[0].dtype
    xproj = spmd.lanewise(_slstm_proj, w, x)            # [B, S, 4, d/tp]
    if own and not heads:
        xproj = spmd.all_gather(xproj, "model", 3, mesh, label=RECURRENT)
    state = _state_lanes(cache, 1, heads, ctx)
    if state is None:
        state = spmd.lanewise(lambda t: init_slstm_state(
            t.shape[0], t.shape[3], t.device), xproj)
    h_lanes = num_heads // tp if heads else num_heads
    hs, new = spmd.lanewise(
        lambda t, wl, st: _slstm_scan(t, wl.r, st, h_lanes, dtype),
        xproj, w, state)
    _state_back(cache, new, 1, heads, ctx)
    if heads:                               # ``up`` reads every channel
        hs = spmd.all_gather(hs, "model", 2, mesh, label=RECURRENT)
    down_split = model_split(p.down, ctx, 0)
    gate, up = regroup_halves(spmd.lanewise(lambda wl, t: t @ wl.up, w, hs),
                              model_split(p.up, ctx, 1), down_split, ctx)
    g = spmd.lanewise(_slstm_hidden, gate, up)
    if down_split:                          # row-parallel
        return spmd.psum(spmd.lanewise(lambda wl, t: t @ wl.down, w, g),
                         "model", mesh)
    d = p.down.shape[1]
    if tp == 1 or d % tp:
        return spmd.lanewise(lambda wl, t: t @ wl.down, w, g)
    y = spmd.lanewise(lambda wl, t, m: t @ own_slice(wl.down, 1, m, tp),
                      w, g, me)
    return spmd.all_gather(y, "model", 2, mesh, label=RECURRENT)


def slstm_step_flops(d: int, num_heads: int) -> int:
    """Analytic per-step FLOPs of the recurrent part (for the roofline)."""
    dh = d // num_heads
    return 2 * num_heads * dh * 4 * dh + 12 * d  # recurrent matvec + gates
