"""Attention: GQA/MQA, RoPE/partial-RoPE/M-RoPE, sliding window, blocked
streaming softmax.

The KV cache is the resident "vertex array": it stays on the device, and
both prefill and decode stream it in blocks of ``block_k`` positions with
running (max, denominator, accumulator) statistics, so the [Sq, Skv] score
matrix is never materialised.  Scores and ``P @ V`` accumulate in float32;
``P`` is cast to V's dtype before the product, as in the reference.

Decode updates the caches in place.  Archs with a sliding window keep a
ring buffer of ``window`` slots with each slot's absolute position (-1
while empty).

On a mesh: GQA repeats the KV heads physically up to the tensor-parallel
degree when needed (``kv_repeat_for``; kv 8 -> 16 on a 16-way 'model'
axis), so caches hold ``K * rep`` heads.  Long-context decode
(``kv_seq_sharded``) shards the cache's sequence over the 'data' lanes
and combines their partial softmax statistics (``flash_decode_sharded``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist import spmd
from repro_torch.dist.context import DISABLED, P, ShardCtx
from repro_torch.models.nn import Init

NEG_INF = -1e30


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> torch.Tensor:
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    base = head_dim // 2
    return (base - 2 * (base // 3), base // 3, base // 3)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, fraction: float,
               theta: float, mrope_sections: tuple[int, ...] | None = None):
    """x: [B, S, H, hd]; positions: [B, S] or [B, S, 3] for M-RoPE."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    inv = rope_freqs(hd, fraction, theta, x.device)  # [rot/2]
    if mrope_sections is not None:
        # M-RoPE: the rot/2 frequency slots split into (t, h, w) sections,
        # each driven by its own position stream
        assert sum(mrope_sections) == rot // 2, (mrope_sections, rot)
        # output_size: a fixed shape, so no value is read back (and the
        # op runs on ``meta`` tensors)
        sec_id = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.tensor(mrope_sections, device=x.device),
            output_size=sum(mrope_sections))
        ang = positions[..., sec_id].float() * inv   # [B, S, rot/2]
    else:
        ang = positions[..., None].float() * inv
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def positions_for(cfg, batch: int, seq: int, offset: int = 0,
                  device=None) -> torch.Tensor:
    pos = (offset + torch.arange(seq, device=device))[None, :]
    pos = pos.expand(batch, seq)
    if cfg.rope_type == "mrope":
        return pos[..., None].expand(batch, seq, 3)  # text: t = h = w
    return pos


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, init: Init, cfg, dtype):
        super().__init__()
        d, H, K = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = init.dense((d, H, hd), dtype,
                             ("embed", "q_heads", "head_dim"))
        self.wk = init.dense((d, K, hd), dtype,
                             ("embed", "kv_heads", "head_dim"))
        self.wv = init.dense((d, K, hd), dtype,
                             ("embed", "kv_heads", "head_dim"))
        self.wo = init.dense((H, hd, d), dtype,
                             ("q_heads", "head_dim", "embed"))


def kv_repeat_for(cfg, ctx: ShardCtx | None) -> int:
    """Physical KV-head repetition so heads shard on the model axis."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    tp = (ctx or DISABLED).axis_size("q_heads")
    if tp <= 1 or H % tp != 0:
        return 1
    r = 1
    while (K * r) % tp != 0 and (K * r) < H:
        r *= 2
    return r if (K * r) % tp == 0 and H % (K * r) == 0 else 1


# --------------------------------------------------------------------------
# flash attention (blocked; numerics match a plain softmax)
# --------------------------------------------------------------------------
def _block_attend(q, kblk, vblk, m, l, acc, qpos, kpos, *, causal, window,
                  kv_len: int | None = None):
    """One KV block of the streaming softmax.  q: [B,Sq,K,G,hd] float32,
    kblk/vblk: [B,bk,K,hd]; m, l: [B,K,G,Sq]; acc: [B,Sq,K,G,hd].
    Positions below 0, and at or past ``kv_len``, are masked."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bjkh->bkgqj", q, kblk.float()) * scale
    valid = (kpos[None, :] >= 0)
    if kv_len is not None:
        valid = valid & (kpos[None, :] < kv_len)
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqj,bjkh->bqkgh", p.to(vblk.dtype).float(),
                      vblk.float())
    acc_new = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len: int | None = None,
                    kv_positions: torch.Tensor | None = None,
                    block_k: int = 512):
    """q: [B, Sq, H, hd]; k, v: [B, Skv, K, hd] -> [B, Sq, H, hd].

    Streams KV in blocks of ``block_k``.  ``kv_len`` masks a padded cache
    (decode); ``q_offset`` is the absolute position of q[0];
    ``kv_positions`` [Skv] overrides slot positions (ring-buffer caches,
    whose slot order is not chronological; -1 marks empty slots).
    """
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    qg = q.reshape(B, Sq, K, G, hd).float()
    bk = min(block_k, Skv)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
        if kv_len is not None:
            kv_positions = torch.where(kv_positions < kv_len, kv_positions,
                                       -1)
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, K, G, hd), dtype=torch.float32, device=dev)
    for j in range(0, Skv, bk):  # the last block is short: no padding
        m, l, acc = _block_attend(qg, k[:, j:j + bk], v[:, j:j + bk], m, l,
                                  acc, qpos, kv_positions[j:j + bk],
                                  causal=causal, window=window)
    l = torch.clamp_min(l, 1e-30)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------
def attention_apply(p: Attention, x, positions, cfg,
                    ctx: ShardCtx | None = None, *, causal: bool = True,
                    cache: dict | None = None, cache_index: int | None = None,
                    kv_seq_sharded: bool = False,
                    cross_kv: torch.Tensor | None = None):
    """Self- or cross-attention.

    train/prefill: cache is None (or a dict to fill at positions [0, S)).
    decode: x is [B, 1, d], cache holds [B, S_max, K * rep, hd] and is
    updated in place at ``cache_index`` (a Python int: no host sync);
    with ``kv_seq_sharded`` on an enabled ``ctx`` it is attended lane by
    lane (``flash_decode_sharded``).  Returns (out, cache).
    """
    ctx = ctx or DISABLED
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    rep = kv_repeat_for(cfg, ctx)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    kv_src = cross_kv if cross_kv is not None else x
    k = torch.einsum("bsd,dhk->bshk", kv_src, p.wk)
    v = torch.einsum("bsd,dhk->bshk", kv_src, p.wv)
    if cfg.rope_type in ("rope", "partial", "mrope") and cross_kv is None:
        frac = cfg.rope_fraction if cfg.rope_type == "partial" else 1.0
        sections = mrope_sections(hd) if cfg.rope_type == "mrope" else None
        q = apply_rope(q, positions, fraction=frac, theta=cfg.rope_theta,
                       mrope_sections=sections)
        k = apply_rope(k, positions, fraction=frac, theta=cfg.rope_theta,
                       mrope_sections=sections)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    q = ctx.constrain(q, ("batch", "seq", "q_heads", "head_dim"))
    k = ctx.constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    window = cfg.sliding_window

    if cache is not None and cache_index is not None and S == 1:
        # decode: write the new KV into the cache, attend over it
        S_max = cache["k"].shape[1]
        ring = "pos" in cache
        slot = cache_index % S_max if ring else cache_index
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        if ring:
            cache["pos"][slot] = cache_index
            out = flash_attention(q, cache["k"], cache["v"], causal=True,
                                  window=window, q_offset=cache_index,
                                  kv_positions=cache["pos"])
        elif kv_seq_sharded and ctx.enabled:
            out = flash_decode_sharded(q, cache["k"], cache["v"],
                                       cache_index + 1, ctx,
                                       q_offset=cache_index, window=window)
        else:
            out = flash_attention(q, cache["k"], cache["v"], causal=True,
                                  window=window, q_offset=cache_index,
                                  kv_len=cache_index + 1)
    else:
        out = flash_attention(q, k, v, causal=causal and cross_kv is None,
                              window=window)
        if cache is not None:  # prefill fill (keep the last S_max positions)
            S_max = cache["k"].shape[1]
            kept = min(S_max, S)
            cache["k"][:, :kept] = k[:, S - kept:]
            cache["v"][:, :kept] = v[:, S - kept:]
            if "pos" in cache:
                cache["pos"].fill_(-1)
                cache["pos"][:kept] = torch.arange(S - kept, S,
                                                   device=x.device)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return ctx.constrain(y, ("batch", "seq", "embed")), cache


def flash_decode_sharded(q, k_cache, v_cache, kv_len: int, ctx: ShardCtx, *,
                         q_offset: int, window: int = 0):
    """Sequence-parallel decode (long_500k): the KV cache's sequence is
    split over the 'data' lanes; each lane attends its slice as one block
    of ``Sl`` positions, and the partial softmax statistics combine with
    ``pmax`` and ``psum`` over 'data' (flash-decoding, lane by lane)."""
    mesh = ctx.mesh
    axis = "data"
    qs = spmd.shard(q, P(), mesh)
    ks = spmd.shard(k_cache, P(None, axis), mesh)
    vs = spmd.shard(v_cache, P(None, axis), mesh)

    def local(qb, kb, vb, me):
        Sl = kb.shape[1]
        B, Sq, H, hd = qb.shape
        K = kb.shape[2]
        G = H // K
        dev = qb.device
        qg = qb.reshape(B, Sq, K, G, hd).float()
        m0 = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32,
                        device=dev)
        l0 = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
        a0 = torch.zeros((B, Sq, K, G, hd), dtype=torch.float32, device=dev)
        kpos = int(me) * Sl + torch.arange(Sl, device=dev)
        qpos = q_offset + torch.arange(Sq, device=dev)
        return _block_attend(qg, kb, vb, m0, l0, a0, qpos, kpos, causal=True,
                             window=window, kv_len=kv_len)

    m, l, acc = spmd.lanewise(local, qs, ks, vs,
                              spmd.axis_index(mesh, axis))
    # combine the partial softmax statistics across the sequence shards
    m_all = spmd.pmax(m, axis, mesh)
    corr = spmd.lanewise(lambda a, b: torch.exp(a - b), m, m_all)
    l_all = spmd.psum(spmd.lanewise(torch.mul, l, corr), axis, mesh)
    acc_all = spmd.psum(spmd.lanewise(
        lambda a, c: a * c.permute(0, 3, 1, 2)[..., None], acc, corr),
        axis, mesh)

    def finish(a, s):
        out = a / torch.clamp_min(s, 1e-30).permute(0, 3, 1, 2)[..., None]
        return out.reshape(q.shape).to(q.dtype)
    return spmd.unshard(spmd.lanewise(finish, acc_all, l_all), P(), mesh)
