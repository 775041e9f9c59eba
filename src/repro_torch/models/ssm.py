"""Mamba (selective SSM) block for the Jamba hybrid, chunked-parallel form.

Prefill splits the sequence into chunks; within a chunk the recurrence
h_t = dA_t * h_{t-1} + dBx_t is solved by a parallel prefix scan (log2 Q
levels), and the chunk's last state carries into the next.  The
[B, S, di, N] state sequence exists only one chunk at a time.  Decode is the
O(1) recurrent step on the carried (conv, ssm) state.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MambaConfig
from repro_torch.dist.context import DISABLED, ShardCtx
from repro_torch.models.nn import DTYPES, Init, silu, softplus


def d_inner_of(d_model: int, mc: MambaConfig) -> int:
    return mc.expand * d_model


def dt_rank_of(d_model: int, mc: MambaConfig) -> int:
    return mc.dt_rank or -(-d_model // 16)


class Mamba(nn.Module):
    def __init__(self, init: Init, d: int, mc: MambaConfig, dtype):
        super().__init__()
        di = d_inner_of(d, mc)
        dtr = dt_rank_of(d, mc)
        N = mc.d_state
        self.in_proj = init.dense((d, 2 * di), dtype,
                                  ("embed", "mamba_inner"))
        self.conv_w = init.dense((mc.d_conv, di), dtype,
                                 (None, "mamba_inner"), scale=0.5)
        self.conv_b = init.full((di,), 0.0, dtype, ("mamba_inner",))
        self.x_proj = init.dense((di, dtr + 2 * N), dtype,
                                 ("mamba_inner", None))
        self.dt_proj = init.dense((dtr, di), dtype,
                                  (None, "mamba_inner"))
        self.dt_bias = init.full((di,), 0.0, dtype, ("mamba_inner",))
        self.A_log = init.tensor(
            lambda dev: torch.log(torch.arange(
                1, N + 1, dtype=torch.float32, device=dev)).repeat(di, 1),
            (di, N), torch.float32, ("mamba_inner", "state"))
        self.D = init.full((di,), 1.0, dtype, ("mamba_inner",))
        self.out_proj = init.dense((di, d), dtype,
                                   ("mamba_inner", "embed"))


def _prefix_scan(a, bx):
    """Inclusive scan of h_t = a_t * h_{t-1} + bx_t along dim 1 from h = 0:
    -> (prod_{i<=t} a_i, h_t).  The odd-even recursion of
    ``jax.lax.associative_scan`` (log2 Q levels), so the float32 products
    combine in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, bx
    ra, rb = a[:, 1::2], bx[:, 1::2]
    oa, ob = _prefix_scan(a[:, 0:-1:2] * ra, ra * bx[:, 0:-1:2] + rb)
    if n % 2 == 0:
        oa_l, ob_l = oa[:, :-1], ob[:, :-1]
    else:
        oa_l, ob_l = oa, ob
    ra, rb = a[:, 2::2], bx[:, 2::2]
    ea = torch.cat([a[:, :1], oa_l * ra], dim=1)
    eb = torch.cat([bx[:, :1], ra * ob_l + rb], dim=1)
    pa, pb = torch.empty_like(a), torch.empty_like(bx)
    pa[:, 0::2], pa[:, 1::2] = ea, oa
    pb[:, 0::2], pb[:, 1::2] = eb, ob
    return pa, pb


def _ssm_scan_chunked(dA, dBx, Cs, h0, chunk: int):
    """y_t = C_t . h_t with h_t = dA_t * h_{t-1} + dBx_t.

    dA, dBx: [B, S, di, N]; Cs: [B, S, N] float32; h0: [B, di, N] float32.
    Returns (y [B, S, di] float32, h_last).
    """
    S = dA.shape[1]
    Q = min(chunk, S)
    h = h0
    ys = []
    for j in range(0, S, Q):  # the last chunk is short: no padding needed
        pa, pb = _prefix_scan(dA[:, j:j + Q], dBx[:, j:j + Q])
        h_all = pa * h[:, None] + pb        # [B, Q, di, N] (chunk transient)
        ys.append(torch.einsum("bqin,bqn->bqi", h_all, Cs[:, j:j + Q]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_apply(p: Mamba, x, mc: MambaConfig, ctx: ShardCtx | None = None,
                *, state: dict | None = None, chunk: int = 256,
                scan_dtype: str = "float32"):
    """x: [B, S, d] -> (y, new_state).  state carries (conv, ssm) for decode.

    ``scan_dtype='bfloat16'`` keeps the [B, S, di, N] discretisation tensors
    in bf16; the recurrence carry stays float32."""
    B, S, d = x.shape
    di = p.D.shape[0]
    N = p.A_log.shape[1]
    dc = p.conv_w.shape[0]
    xz = x @ p.in_proj
    xr, z = xz.chunk(2, dim=-1)
    ctx = ctx or DISABLED
    xr = ctx.constrain(xr, ("batch", "seq", "mamba_inner"))

    # causal depthwise conv over the sequence (the same op order for S = 1
    # and S > 1, so decode and prefill agree bitwise in bf16)
    if state is None:
        pad = torch.zeros((B, dc - 1, di), dtype=xr.dtype, device=x.device)
    else:
        pad = state["conv"]
    conv_in = torch.cat([pad, xr], dim=1)
    new_conv = conv_in[:, -(dc - 1):]
    xc = sum(conv_in[:, i:i + S] * p.conv_w[i] for i in range(dc))
    xc = silu(xc + p.conv_b)

    dtr = p.dt_proj.shape[0]
    xdb = xc @ p.x_proj
    dt, Bs, Cs = torch.split(xdb, [dtr, N, N], dim=-1)
    dt = softplus(dt @ p.dt_proj + p.dt_bias)
    A = -torch.exp(p.A_log.float())                          # [di, N]
    sdt = DTYPES[scan_dtype]
    dA = torch.exp(dt[..., None].float() * A).to(sdt)        # [B,S,di,N]
    dBx = ((dt * xc)[..., None].float()
           * Bs[:, :, None, :].float()).to(sdt)

    h0 = (state["ssm"] if state is not None else
          torch.zeros((B, di, N), dtype=torch.float32, device=x.device))
    if S == 1:
        h_last = dA[:, 0] * h0 + dBx[:, 0]
        y = torch.einsum("bin,bn->bi", h_last, Cs[:, 0].float())[:, None]
    else:
        y, h_last = _ssm_scan_chunked(dA, dBx, Cs.float(), h0, chunk)
    y = y.to(x.dtype) + xc * p.D
    y = y * silu(z)
    out = ctx.constrain(y @ p.out_proj, ("batch", "seq", "embed"))
    return out, {"conv": new_conv, "ssm": h_last}


def init_mamba_state(cfg, batch: int, dtype, device=None) -> dict:
    mc = cfg.mamba
    di = d_inner_of(cfg.d_model, mc)
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                           device=device),
    }
