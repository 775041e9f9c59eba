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
axis), so caches hold ``K * rep`` heads.  ``attention_lanes`` is the
layer as the reference's SPMD program runs it, lane by lane: wq is
column-parallel over the q heads, wk and wv (KV heads replicated) give
each lane the repeated heads its q heads read, wo is row-parallel and a
``psum`` over 'model' sums its partial outputs; each weight's FSDP split
of 'embed' is all-gathered before use.  A spec that leaves the q heads
whole (the heads do not divide 'model') leaves the layer whole on every
lane, with no ``psum``.  Long-context decode (``kv_seq_sharded``) shards
the cache's sequence over the 'data' lanes, the whole batch on each, and
combines their partial softmax statistics (``flash_decode_sharded``).
"""
from __future__ import annotations

import torch
from torch import nn

import numpy as np

from repro_torch.dist import spmd
from repro_torch.dist.context import DISABLED, P, ShardCtx
from repro_torch.models.nn import (Init, dense_spec, lane_weights, spec_of,
                                   split_over_model)

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
                    cross_kv: torch.Tensor | None = None):
    """Self- or cross-attention on whole tensors (a mesh runs
    ``attention_lanes``).

    train/prefill: cache is None (or a dict to fill at positions [0, S)).
    decode: x is [B, 1, d], cache holds [B, S_max, K * rep, hd] and is
    updated in place at ``cache_index`` (a Python int: no host sync).
    Returns (out, cache).
    """
    ctx = ctx or DISABLED
    rep = kv_repeat_for(cfg, ctx)
    q, k, v = _project(x, cross_kv, positions, p.wq, p.wk, p.wv, cfg, rep)
    q = ctx.constrain(q, ("batch", "seq", "q_heads", "head_dim"))
    k = ctx.constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    out = _attend(q, k, v, cfg, causal=causal and cross_kv is None,
                  cache=cache, cache_index=cache_index)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return ctx.constrain(y, ("batch", "seq", "embed")), cache


def _project(x, cross_kv, positions, wq, wk, wv, cfg, rep: int):
    """q, k, v (RoPE applied, k and v repeated ``rep`` times)."""
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    kv_src = cross_kv if cross_kv is not None else x
    k = torch.einsum("bsd,dhk->bshk", kv_src, wk)
    v = torch.einsum("bsd,dhk->bshk", kv_src, wv)
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
    return q, k, v


def _write_slot(cache: dict, k, v, cache_index: int, lo: int = 0) -> None:
    """Decode: the new position's k and v into slot ``cache_index - lo``
    of a cache (a ring buffer's slot modulo its length)."""
    S_max = cache["k"].shape[1]
    ring = "pos" in cache
    slot = cache_index % S_max if ring else cache_index - lo
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    if ring:
        cache["pos"][slot] = cache_index


def _attend(q, k, v, cfg, *, causal: bool, cache: dict | None,
            cache_index: int | None, expand=None):
    """The attention of q over k, v; decode (``cache_index`` and one
    query) writes them into ``cache`` and attends over it, prefill fills
    ``cache`` with the last positions.  ``expand`` maps a cache's heads
    to the ones q reads (None: as they are)."""
    window = cfg.sliding_window
    S = q.shape[1]
    expand = expand or (lambda t: t)
    if cache is not None and cache_index is not None and S == 1:
        _write_slot(cache, k, v, cache_index)
        if "pos" in cache:
            return flash_attention(q, expand(cache["k"]), expand(cache["v"]),
                                   causal=True, window=window,
                                   q_offset=cache_index,
                                   kv_positions=cache["pos"])
        return flash_attention(q, expand(cache["k"]), expand(cache["v"]),
                               causal=True, window=window,
                               q_offset=cache_index, kv_len=cache_index + 1)
    out = flash_attention(q, expand(k), expand(v), causal=causal,
                          window=window)
    if cache is not None:  # prefill fill (keep the last S_max positions)
        _fill(cache, k, v, S)
    return out


def _fill(cache: dict, k, v, S: int, lo: int = 0,
          total: int | None = None) -> None:
    """Prefill: a cache of ``total`` slots (default: this one's) keeps
    the last ``min(total, S)`` positions in its first slots; this cache
    holds its slots ``[lo, lo + its length)``."""
    n = cache["k"].shape[1]
    kept = min(total or n, S)
    hi = min(lo + n, kept)
    if hi > lo:
        cache["k"][:, :hi - lo] = k[:, S - kept + lo:S - kept + hi]
        cache["v"][:, :hi - lo] = v[:, S - kept + lo:S - kept + hi]
    if "pos" in cache:
        cache["pos"].fill_(-1)
        cache["pos"][:kept] = torch.arange(S - kept, S, device=k.device)


def attention_lanes(p: Attention, x, positions, cfg, ctx: ShardCtx, *,
                    causal: bool = True, caches=None,
                    cache_index: int | None = None,
                    kv_seq_sharded: bool = False, cross_kv=None):
    """The layer on lanes (module docstring).  ``x``, ``positions`` and
    ``cross_kv`` are lanes arrays split over the batch axes; ``caches``
    a lanes array of each lane's cache dict (its heads, and with
    ``kv_seq_sharded`` its sequence slice of the whole batch).  -> the
    lanes array of the output, whole over 'model'."""
    mesh = ctx.mesh
    w = lane_weights(p, ctx)
    split = split_over_model(dense_spec(spec_of(p.wq, ctx), ctx), 1)
    tp = mesh.shape["model"] if split else 1
    H, rep = cfg.num_heads, kv_repeat_for(cfg, ctx)
    Kr = cfg.num_kv_heads * rep
    Hl = H // tp
    me = (spmd.axis_index(mesh, "model") if split
          else np.zeros(mesh.devices.shape, dtype=np.int64))
    even = Kr % tp == 0
    cross = cross_kv is not None
    decode = cache_index is not None and x.flat[0].shape[1] == 1
    sharded_decode = (kv_seq_sharded and caches is not None and decode
                      and not cfg.sliding_window)

    def project(wl, xl, pos, kv, m):
        # the original KV heads this lane's repeated heads come from
        klo, khi = (m * Kr // tp, (m + 1) * Kr // tp) if even else (0, Kr)
        olo, ohi = klo // rep, (khi - 1) // rep + 1
        q, k, v = _project(xl, kv, pos, wl.wq, wl.wk[:, olo:ohi],
                           wl.wv[:, olo:ohi], cfg, rep)
        off = klo - olo * rep
        return q, k[:, :, off:off + khi - klo], v[:, :, off:off + khi - klo]

    def expand_for(m):
        if even or not split:
            return None
        # heads the q heads of this lane read, one a q head
        return lambda t: torch.repeat_interleave(
            t, H // Kr, dim=2)[:, :, m * Hl:(m + 1) * Hl]

    q, k, v = spmd.lanewise(project, w, x, positions, cross_kv, me)
    if sharded_decode:
        out = _sharded_decode_lanes(q, k, v, caches, cache_index, cfg, ctx)
    else:
        seq_split = kv_seq_sharded and not cfg.sliding_window
        out = spmd.lanewise(
            lambda ql, kl, vl, cache, m: _attend(
                ql, kl, vl, cfg, causal=causal and not cross,
                cache=None if seq_split else cache,
                cache_index=cache_index, expand=expand_for(int(m))),
            q, k, v, caches, me)
        if seq_split and caches is not None:
            _fill_sharded_lanes(k, v, caches, ctx)
    y = spmd.lanewise(lambda o, wl: torch.einsum("bshk,hkd->bsd", o, wl.wo),
                      out, w)
    return spmd.psum(y, "model", mesh) if split else y
def flash_decode_sharded(q, k_cache, v_cache, kv_len: int, ctx: ShardCtx, *,
                         q_offset: int, window: int = 0):
    """Sequence-parallel decode (long_500k): the KV cache's sequence is
    split over the 'data' lanes; each lane attends its slice as one block
    of ``Sl`` positions, and the partial softmax statistics combine with
    ``pmax`` and ``psum`` over 'data' (flash-decoding, lane by lane)."""
    mesh = ctx.mesh
    out = _flash_decode_lanes(spmd.shard(q, P(), mesh),
                              spmd.shard(k_cache, P(None, "data"), mesh),
                              spmd.shard(v_cache, P(None, "data"), mesh),
                              kv_len, ctx, q_offset=q_offset, window=window)
    return spmd.unshard(out, P(), mesh)


def _sharded_decode_lanes(q, k, v, caches, cache_index: int, cfg,
                          ctx: ShardCtx):
    """Long-context decode on lanes: q, k and v of the new position
    gathered over the batch axes, k and v written into the lane whose
    sequence slice holds ``cache_index``, the flash-decode over the
    slices, and each lane's batch rows of the result."""
    mesh = ctx.mesh
    dp = ctx.rules.get("batch")
    qa, ka, va = (spmd.all_gather(t, dp, 0, mesh, label="long-context decode")
                  for t in (q, k, v))
    di = spmd.axis_index(mesh, "data")

    def write(cache, kl, vl, d):
        n = cache["k"].shape[1]
        if int(d) * n <= cache_index < (int(d) + 1) * n:
            _write_slot(cache, kl, vl, cache_index, lo=int(d) * n)
    spmd.lanewise(write, caches, ka, va, di)
    out = _flash_decode_lanes(
        qa, spmd.lanewise(lambda c: c["k"], caches),
        spmd.lanewise(lambda c: c["v"], caches), cache_index + 1, ctx,
        q_offset=cache_index, window=cfg.sliding_window)
    bi = spmd.axis_index(mesh, dp)
    Bl = q.flat[0].shape[0]
    return spmd.lanewise(lambda o, b: o.narrow(0, int(b) * Bl, Bl), out, bi)


def _fill_sharded_lanes(k, v, caches, ctx: ShardCtx) -> None:
    """Long-context prefill: each lane keeps its sequence slice of the
    whole batch's k and v (gathered over the batch axes)."""
    mesh = ctx.mesh
    dp = ctx.rules.get("batch")
    ka, va = (spmd.all_gather(t, dp, 0, mesh, label="long-context prefill")
              for t in (k, v))
    n = mesh.shape["data"]
    spmd.lanewise(lambda c, kl, vl, d: _fill(
        c, kl, vl, kl.shape[1], lo=int(d) * c["k"].shape[1],
        total=n * c["k"].shape[1]), caches, ka, va,
        spmd.axis_index(mesh, "data"))


def _flash_decode_lanes(qs, ks, vs, kv_len: int, ctx: ShardCtx, *,
                        q_offset: int, window: int = 0):
    """The flash-decode of ``flash_decode_sharded`` on lanes arrays: q
    whole on each lane, k and v each lane's sequence slice."""
    mesh = ctx.mesh
    axis = "data"

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

    def finish(a, s, qb):
        out = a / torch.clamp_min(s, 1e-30).permute(0, 3, 1, 2)[..., None]
        return out.reshape(qb.shape).to(qb.dtype)
    return spmd.lanewise(finish, acc_all, l_all, qs)
