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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import XLSTMConfig
from repro_torch.dist.context import DISABLED, ShardCtx
from repro_torch.models.nn import Init, const, gelu, silu

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


def mlstm_apply(p: MLSTM, x, num_heads: int, xc: XLSTMConfig,
                ctx: ShardCtx | None = None, *, state: dict | None = None):
    """x: [B, S, d] -> (y, new_state)."""
    B, S, d = x.shape
    xr, res = (x @ p.up).chunk(2, dim=-1)
    di = xr.shape[-1]
    H = num_heads
    hd = di // H
    nb, bs = p.wq.shape[0], p.wq.shape[1]

    def blockdiag(t, w):  # [B,S,di] x [nb,bs,bs] -> [B,S,H,hd]
        y = torch.einsum("bsnk,nkl->bsnl", t.reshape(B, S, nb, bs), w)
        return y.reshape(B, S, H, hd)

    q = blockdiag(xr, p.wq)
    q = q * const(hd ** -0.5, q)
    k = blockdiag(xr, p.wk)
    v = blockdiag(xr, p.wv)
    li = xr.float() @ p.wi + p.bi
    lf = F.logsigmoid(xr.float() @ p.wf + p.bf)
    if state is None:
        state = init_mlstm_state(B, H, hd, x.device)
    if S == 1:
        y, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                                   lf[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = _mlstm_chunked(q, k, v, li, lf, state, xc.chunk_size)
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * silu(x @ p.ogate)
    y = y + res
    ctx = ctx or DISABLED
    return ctx.constrain(y @ p.down, ("batch", "seq", "embed")), new_state


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


def slstm_apply(p: SLSTM, x, num_heads: int, ctx: ShardCtx | None = None,
                *, state: dict | None = None):
    """x: [B, S, d] -> (y, new_state).  Sequential over S (true
    recurrence)."""
    B, S, d = x.shape
    # bf16 projection + float32 bias -> float32, as in the reference
    xproj = torch.einsum("bsd,dge->bsge", x, p.wx) + p.b
    if state is None:
        state = init_slstm_state(B, d, x.device)
    hs = []
    for t in range(S):
        h, state = _slstm_step(xproj[:, t], p.r, state, num_heads)
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)
    # gated up/down projection FFN (proj factor 4/3)
    gate, up = (hs @ p.up).chunk(2, dim=-1)
    y = (gelu(gate) * up) @ p.down
    return (ctx or DISABLED).constrain(y, ("batch", "seq", "embed")), state
