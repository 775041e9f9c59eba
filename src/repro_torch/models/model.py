"""Unified model: one composable block stack covering all 10 archs.

A config compiles to *layer groups*: (unit_pattern, repeat) pairs where a
unit is a tuple of (mixer, ffn) block descriptors, mixer in {attn, mamba,
mlstm, slstm} and ffn in {ffn, moe, none}.  The reference stacks each
group's parameters and scans over ``repeat``; here the groups unroll into
one ``nn.ModuleList`` of blocks (``Model.layers``, and ``enc_layers`` for
the encoder), layer ``offset(group) + r * len(unit) + i`` being block
``b{i}`` of repeat ``r``.

Examples:
  gemma-2b        [(attn+ffn,), 18]
  kimi-k2         [(attn+ffn,), 1] + [(attn+moe,), 60]        (first dense)
  jamba           [(mamba+ffn, mamba+moe, ... attn ..., x8), 4]
  xlstm-1.3b      [(mlstm x7, slstm), 6]
  seamless        encoder [(attn+ffn,), 24] + decoder [(attn+xattn+ffn,), 24]

Modes: ``loss_fn`` (training: the masked next-token loss), ``forward``
(teacher-forced logits), ``prefill`` (fill caches, last-position logits)
and ``decode_step`` (one token against the caches and states, updated in
place).  Logits are float32 over the padded vocab.

On a mesh (``ctx``, ``dist.context.make_rules``) every weight is
resident lane by lane as ``ctx.param_sharding`` cuts it
(``nn.ShardedParameter``), and the model runs as the reference's SPMD
program, lane by lane over ``dist.spmd``'s collectives: the activations
are split over the data axes ('batch'); each weight's FSDP split of
'embed' is all-gathered before use; attention and the FFNs are tensor
parallel over 'model' (a ``psum`` after the row-parallel ``wo`` and
``w_down``); the embedding is vocab-parallel (a masked lookup, then a
``psum``), and so are the logits and the loss's log-softmax (``pmax`` and
``psum`` over 'model').  The norms are replicated.  The MoE runs its
expert-parallel paths on the lane's own expert shards.  Mamba, mLSTM and
sLSTM are tensor parallel over 'model' too (``ssm.mamba_lanes``,
``xlstm.mlstm_lanes``, ``slstm_lanes``): each lane computes on its
channels or heads of every weight, with no weight gathered over 'model';
their activations and states are regrouped over 'model' where a layer
needs them laid out otherwise (``nn.RECURRENT`` in the collective
counts).  Caches are one dict a layer whose leaves are
``spmd.Lanes`` laid out as ``launch.shapes.cache_shardings`` lays them
out (a long-context cache's sequence over 'data', the whole batch on each
lane, as ``flash_decode_sharded`` reads it).  The entry points take and
return whole tensors.

Training recomputes each reference *unit* (one block for gemma, the
8-block unit for jamba and xlstm) in the backward pass when ``remat`` is
on, as the reference's ``jax.checkpoint`` of its scan body does; remat
changes memory, never values.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.dist import spmd
from repro_torch.dist.context import DISABLED, P, ShardCtx
from repro_torch.models.attention import (Attention, attention_apply,
                                          attention_lanes, kv_repeat_for,
                                          positions_for)
from repro_torch.models.ffn import FFN, ffn_apply, ffn_lanes
from repro_torch.models.moe import MoE, moe_apply, moe_lanes
from repro_torch.models.nn import (DTYPES, Init, Norm, apply_norm,
                                   dense_spec, gather_to, lane_weights,
                                   named_weights, split_over_model)
from repro_torch.models.ssm import (Mamba, init_mamba_state, mamba_apply,
                                    mamba_lanes)
from repro_torch.models.xlstm import (MLSTM, SLSTM, init_mlstm_state,
                                      init_slstm_state, mlstm_apply,
                                      mlstm_lanes, slstm_apply, slstm_lanes)

VOCAB_PAD_MULTIPLE = 2048  # the reference pads for 16-way vocab sharding


def padded_vocab(cfg: ArchConfig) -> int:
    m = VOCAB_PAD_MULTIPLE
    return ((cfg.vocab_size + m - 1) // m) * m


# --------------------------------------------------------------------------
# layer groups
# --------------------------------------------------------------------------
def layer_groups(cfg: ArchConfig, *,
                 encoder: bool = False) -> list[tuple[tuple, int]]:
    if encoder:
        return [((("attn", "ffn"),), cfg.encoder_layers)]
    if cfg.xlstm is not None:
        k = cfg.xlstm.slstm_every
        unit = tuple([("mlstm", "none")] * (k - 1) + [("slstm", "none")])
        assert cfg.num_layers % k == 0
        return [(unit, cfg.num_layers // k)]
    if cfg.attn_every:  # jamba: one attn per attn_every, MoE every other
        unit = []
        for i in range(cfg.attn_every):
            mixer = "attn" if i == cfg.attn_every // 2 else "mamba"
            ffn = "moe" if (cfg.moe is not None and i % 2 == 1) else "ffn"
            unit.append((mixer, ffn))
        assert cfg.num_layers % cfg.attn_every == 0
        return [(tuple(unit), cfg.num_layers // cfg.attn_every)]
    if cfg.moe is not None:
        groups: list[tuple[tuple, int]] = []
        fk = cfg.moe.first_k_dense
        if fk:
            groups.append(((("attn", "ffn"),), fk))
        groups.append(((("attn", "moe"),), cfg.num_layers - fk))
        return groups
    return [((("attn", "ffn"),), cfg.num_layers)]


def layer_descs(cfg: ArchConfig, *, encoder: bool = False) -> list[tuple]:
    """The (mixer, ffn) descriptor of each layer, in order."""
    return [desc for unit, repeat in layer_groups(cfg, encoder=encoder)
            for _ in range(repeat) for desc in unit]


def layer_paths(cfg: ArchConfig, *, encoder: bool = False) -> list[str]:
    """The reference's tree path of each layer's block ("group1/b0"), in
    the port's layer order."""
    prefix = "enc_group" if encoder else "group"
    return [f"{prefix}{gi}/b{i}" for gi, (unit, repeat)
            in enumerate(layer_groups(cfg, encoder=encoder))
            for _ in range(repeat) for i in range(len(unit))]


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
class Block(nn.Module):
    def __init__(self, init: Init, desc, cfg: ArchConfig, dtype, *,
                 cross: bool):
        super().__init__()
        mixer, ffn = desc
        self.desc = desc
        d = cfg.d_model
        self.norm1 = Norm(init, cfg.norm_type, d)
        if mixer == "attn":
            self.attn = Attention(init, cfg, dtype)
        elif mixer == "mamba":
            self.mamba = Mamba(init, d, cfg.mamba, dtype)
        elif mixer == "mlstm":
            self.mlstm = MLSTM(init, d, cfg.num_heads, cfg.xlstm, dtype)
        elif mixer == "slstm":
            self.slstm = SLSTM(init, d, cfg.num_heads, cfg.xlstm, dtype)
        if cross:
            self.norm_x = Norm(init, cfg.norm_type, d)
            self.xattn = Attention(init, cfg, dtype)
        if ffn == "ffn":
            self.norm2 = Norm(init, cfg.norm_type, d)
            self.ffn = FFN(init, d, cfg.d_ff, cfg.mlp_type, dtype)
        elif ffn == "moe":
            self.norm2 = Norm(init, cfg.norm_type, d)
            self.moe = MoE(init, d, cfg.moe, cfg.mlp_type, dtype)


def _init_cache_block(desc, cfg: ArchConfig, batch: int, cache_len: int,
                      ctx: ShardCtx, dtype, device) -> dict:
    mixer, _ = desc
    c: dict[str, Any] = {}
    if mixer == "attn":
        K = cfg.num_kv_heads * kv_repeat_for(cfg, ctx)
        hd = cfg.resolved_head_dim
        slen = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                else cache_len)
        c["attn"] = {
            "k": torch.zeros((batch, slen, K, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, slen, K, hd), dtype=dtype,
                             device=device),
        }
        if cfg.sliding_window:
            # int32, as the reference's ring positions
            c["attn"]["pos"] = torch.full((slen,), -1, dtype=torch.int32,
                                          device=device)
    elif mixer == "mamba":
        c["mamba"] = init_mamba_state(cfg, batch, dtype, device)
    elif mixer == "mlstm":
        di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
        c["mlstm"] = init_mlstm_state(batch, cfg.num_heads,
                                      di // cfg.num_heads, device)
    elif mixer == "slstm":
        c["slstm"] = init_slstm_state(batch, cfg.d_model, device)
    return c


def cache_spec(mixer: str, key: str, shape, cfg: ArchConfig, ctx: ShardCtx,
               long_context: bool = False) -> P:
    """The spec of one cache leaf on a mesh: ``launch.shapes.
    cache_shardings``' rule (the reference's), but for a long-context
    attention cache of an arch without a sliding window, whose sequence
    splits over 'data' and whose batch stays whole, as
    ``flash_decode_sharded`` reads it (the reference's rule names 'data'
    twice there, which jax refuses)."""
    axes: list = [None] * len(shape)
    dp = ctx.rules.get("batch")
    tp = ctx.rules.get("q_heads")
    tp_n = ctx.axis_size("q_heads")
    if mixer == "attn":
        if key == "pos":
            return P(*axes)
        if long_context and not cfg.sliding_window:
            axes[1] = "data"
        else:
            axes[0] = dp
        if tp is not None and shape[2] % tp_n == 0:
            axes[2] = tp
    elif mixer == "mamba":  # both states split their axis 1 (the rule's)
        axes[0] = dp
        if tp is not None and shape[1] % tp_n == 0:
            axes[1] = tp
    else:
        axes[0] = dp
    return P(*axes)


def _apply_block(p: Block, x, positions, cfg: ArchConfig, ctx: ShardCtx, *,
                 cache, cache_index, enc_out, causal,
                 ssm_dtype: str = "float32", unroll: bool = False):
    mixer, ffn = p.desc
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(x, p.norm1, cfg.norm_type)
    if mixer == "attn":
        a, _ = attention_apply(
            p.attn, h, positions, cfg, ctx, causal=causal,
            cache=None if cache is None else cache["attn"],
            cache_index=cache_index)
    elif mixer == "mamba":
        # unroll: one full-sequence chunk (the reference's roofline mode)
        a, st = mamba_apply(p.mamba, h, cfg.mamba, ctx,
                            state=None if cache is None else cache["mamba"],
                            chunk=x.shape[1] if unroll else 256,
                            scan_dtype=ssm_dtype)
    elif mixer == "mlstm":
        a, st = mlstm_apply(p.mlstm, h, cfg.num_heads, cfg.xlstm, ctx,
                            state=None if cache is None else cache["mlstm"])
    else:
        a, st = slstm_apply(p.slstm, h, cfg.num_heads, ctx,
                            state=None if cache is None else cache["slstm"])
    if cache is not None and mixer != "attn":  # attn updates in place
        cache[mixer] = st
    x = x + a
    if enc_out is not None:
        h = apply_norm(x, p.norm_x, cfg.norm_type)
        a, _ = attention_apply(p.xattn, h, positions, cfg, ctx,
                               causal=False, cross_kv=enc_out)
        x = x + a
    if ffn in ("ffn", "moe"):
        h = apply_norm(x, p.norm2, cfg.norm_type)
        if ffn == "ffn":
            x = x + ffn_apply(p.ffn, h, cfg.mlp_type, ctx)
        else:
            y, aux = moe_apply(p.moe, h, cfg.moe, cfg.mlp_type, ctx)
            x = x + y
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of matmuls without batch
    dimensions (``jax.checkpoint_policies.dots_with_no_batch_dims_
    saveable``); recompute everything else, batched matmuls included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {
    "nothing": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
}


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
class Model(nn.Module):
    """All ten architectures, on one device or a mesh: training and
    serving.

    ``ctx`` (default: the disabled context) is the mesh layout from
    ``dist.context.make_rules``; on an enabled one every weight is
    resident lane by lane, each lane's piece on its lane's device
    (``nn.ShardedParameter``), and the model runs as the reference's SPMD
    program (the module docstring).  ``device=None`` means the lanes'
    devices on a mesh (each weight drawn whole on the first lane's, then
    cut), or ``"cuda"`` without a mesh (raising when there is no GPU);
    ``device="meta"`` allocates nothing (``param_count``).  Parameters are
    drawn from a ``torch.Generator`` seeded by ``seed``: the same values
    with a mesh or without.  The training
    knobs are the reference's: ``remat`` recomputes each unit in the
    backward pass, keeping nothing (``remat_policy="nothing"``) or the
    matmul outputs (``"dots"``); ``unroll`` scans Mamba's whole sequence
    as one chunk.  ``long_context`` shards the KV cache's sequence over
    the 'data' lanes in decode (``attention.flash_decode_sharded``) on an
    enabled context, for archs without a sliding window.
    """

    def __init__(self, cfg: ArchConfig, *, ctx: ShardCtx | None = None,
                 device=None, seed: int = 0, ssm_dtype: str = "float32",
                 remat: bool = True, remat_policy: str = "nothing",
                 unroll: bool = False, long_context: bool = False):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: expected one "
                             f"of {sorted(REMAT_POLICIES)}")
        self.cfg = cfg
        self.ctx = ctx or DISABLED
        self.ssm_dtype = ssm_dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.unroll = unroll
        self.long_context = long_context
        if device is None:
            device = (self.ctx.mesh.first_device if self.ctx.enabled
                      else "cuda")
        dev = resolve_device(device)
        init = Init(dev, seed, self.ctx)
        dtype = self.dtype
        V = padded_vocab(cfg)
        self.embed = init.embed(V, cfg.d_model, dtype)
        self.norm_f = Norm(init, cfg.norm_type, cfg.d_model)
        if not cfg.tie_embeddings:
            self.unembed = init.dense((cfg.d_model, V), dtype,
                                      ("embed", "vocab"))
        self.layers = nn.ModuleList(
            Block(init, desc, cfg, dtype, cross=cfg.is_encdec)
            for desc in layer_descs(cfg))
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(
                Block(init, desc, cfg, dtype, cross=False)
                for desc in layer_descs(cfg, encoder=True))
            self.enc_norm_f = Norm(init, cfg.norm_type, cfg.d_model)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_count(self) -> int:
        return sum(w.numel() for _, w in named_weights(self))
    # ---- stacks ----------------------------------------------------------
    def _run_groups(self, x, positions, *, encoder: bool = False,
                    caches: list | None = None, cache_index: int | None = None,
                    enc_out=None, causal: bool = True):
        """-> (x, aux loss summed over the MoE layers).  ``caches`` (one
        dict per layer) are filled or updated in place."""
        layers = self.enc_layers if encoder else self.layers

        def run_unit(first: int, count: int, x, aux_total):
            for i in range(first, first + count):
                x, aux = _apply_block(
                    layers[i], x, positions, self.cfg, self.ctx,
                    cache=None if caches is None else caches[i],
                    cache_index=cache_index, enc_out=enc_out, causal=causal,
                    ssm_dtype=self.ssm_dtype,
                    unroll=self.unroll)
                aux_total = aux_total + aux
            return x, aux_total

        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._by_units(run_unit, x, aux_total, encoder=encoder,
                              caches=caches)

    def _by_units(self, run_unit, x, aux_total, *, encoder: bool, caches):
        """``run_unit(first, count, x, aux)`` over every layer, each
        reference unit recomputed in the backward under remat."""
        if not (self.remat and caches is None and torch.is_grad_enabled()):
            n = len(self.enc_layers if encoder else self.layers)
            return run_unit(0, n, x, aux_total)
        first = 0
        for unit, repeat in layer_groups(self.cfg, encoder=encoder):
            for _ in range(repeat):
                x, aux_total = checkpoint(
                    run_unit, first, len(unit), x, aux_total,
                    use_reentrant=False,
                    context_fn=REMAT_POLICIES[self.remat_policy])
                first += len(unit)
        return x, aux_total

    def _scale_embed(self, x):
        if self.cfg.name.startswith("gemma"):
            # sqrt(d_model) rounded to the activation dtype first (45.25 in
            # bf16 at d_model 2048), as the reference multiplies
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def _embed_inputs(self, batch: dict):
        """tokens (+ modality stubs) -> (x [B,S,d], positions)."""
        cfg = self.cfg
        x = self._scale_embed(self.embed[batch["tokens"]])
        if cfg.modality_stub == "image_patches" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        B, S = x.shape[0], x.shape[1]
        if cfg.rope_type == "mrope" and "positions" in batch:
            positions = batch["positions"]
        else:
            positions = positions_for(cfg, B, S, device=x.device)
        return x, positions

    def _logits(self, x):
        x = apply_norm(x, self.norm_f, self.cfg.norm_type)
        if self.cfg.tie_embeddings:
            logits = x @ self.embed.T
        else:
            logits = x @ self.unembed
        return logits.float()

    def _encode(self, batch: dict):
        x = batch["frames"].to(self.dtype)  # stub: precomputed embeddings
        positions = positions_for(self.cfg, x.shape[0], x.shape[1],
                                  device=x.device)
        x, _ = self._run_groups(x, positions, encoder=True, causal=False)
        return apply_norm(x, self.enc_norm_f, self.cfg.norm_type)

    def forward(self, batch: dict):
        """Teacher-forced logits [B, S, V] (float32) and the MoE aux loss."""
        if self.ctx.enabled:
            with self._root() as root:
                logits, aux = self._forward_lanes(batch, root)
            return self._unshard_logits(logits), aux.flat[0]
        enc_out = self._encode(batch) if self.cfg.is_encdec else None
        x, positions = self._embed_inputs(batch)
        x, aux = self._run_groups(x, positions, enc_out=enc_out)
        return self._logits(x), aux

    # ---- training --------------------------------------------------------
    def loss_fn(self, batch: dict):
        """-> (loss, {"ce", "aux"}): the mean next-token negative log-
        likelihood over ``targets >= 0``, the log-softmax taken over the
        padded vocabulary, plus ``0.01 * aux`` for MoE configs.  As in the
        reference, ``"ce"`` is that total, the aux term included."""
        if self.ctx.enabled:
            with self._root() as root:
                logits, aux = self._forward_lanes(batch, root)
                loss = self._loss_lanes(logits, batch["targets"], aux)
            loss, aux = loss.flat[0], aux.flat[0]
            return loss, {"ce": loss, "aux": aux}
        logits, aux = self(batch)
        targets = batch["targets"]
        if logits.shape[1] != targets.shape[1]:  # vlm: patches prepended
            logits = logits[:, -targets.shape[1]:]
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, targets.clamp_min(0)[..., None].long())
        mask = (targets >= 0).float()
        loss = -(ll[..., 0] * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        if self.cfg.moe is not None:
            loss = loss + 0.01 * aux
        return loss, {"ce": loss, "aux": aux}

    # ---- serving ---------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int,
                   device=None) -> list[dict]:
        """One cache dict a layer, on ``device`` (default: the model's).
        On a mesh each leaf is an ``spmd.Lanes`` (``cache_spec``), on the
        lanes' devices (``device="meta"``: on ``meta``)."""
        if not self.ctx.enabled:
            return [_init_cache_block(block.desc, self.cfg, batch_size,
                                      cache_len, self.ctx, self.dtype,
                                      self.device if device is None
                                      else device)
                    for block in self.layers]
        mesh = self.ctx.mesh
        if device is not None and torch.device(device).type == "meta":
            mesh = mesh.on_meta()
        out = []
        for block in self.layers:
            mixer = block.desc[0]
            whole_c = _init_cache_block(block.desc, self.cfg, batch_size,
                                        cache_len, self.ctx, self.dtype,
                                        mesh.first_device)
            out.append({m: {k: spmd.Lanes.split(t, cache_spec(
                mixer, k, t.shape, self.cfg, self.ctx, self.long_context),
                mesh) for k, t in leaves.items()}
                for m, leaves in whole_c.items()})
            del whole_c
        return out

    def prefill(self, batch: dict, cache_len: int):
        """-> (last-position logits [B, 1, V], caches, enc_out | None)."""
        if self.ctx.enabled:
            with self._root() as root:
                enc = (self._encode_lanes(batch, root) if self.cfg.is_encdec
                       else None)
                x, positions = self._embed_lanes(batch, root)
                caches = self.init_cache(batch["tokens"].shape[0],
                                         cache_len,
                                         device=batch["tokens"].device)
                x, _ = self._run_lanes(x, positions, caches=caches,
                                       enc_out=enc)
                x = spmd.lanewise(lambda t: t[:, -1:], x)
                logits = self._logits_lanes(x, root)
            return (self._unshard_logits(logits), caches,
                    None if enc is None else self._unshard_batch(enc))
        enc_out = self._encode(batch) if self.cfg.is_encdec else None
        x, positions = self._embed_inputs(batch)
        caches = self.init_cache(x.shape[0], cache_len)
        x, _ = self._run_groups(x, positions, caches=caches, enc_out=enc_out)
        return self._logits(x[:, -1:]), caches, enc_out

    def decode_step(self, caches: list[dict], tokens, pos: int,
                    enc_out=None):
        """tokens: [B, 1]; pos: a Python int (uniform across the batch, so
        no host sync).  Updates ``caches`` in place; -> (logits, caches)."""
        if self.ctx.enabled:
            with self._root() as root:
                enc = (None if enc_out is None else
                       self._split_batch(enc_out.to(self.dtype)))
                x = self._lookup_lanes(self._split_batch(tokens), root)
                positions = spmd.lanewise(
                    lambda t: positions_for(self.cfg, t.shape[0], 1,
                                            offset=pos, device=t.device), x)
                x, _ = self._run_lanes(x, positions, caches=caches,
                                       cache_index=pos, enc_out=enc)
                logits = self._logits_lanes(x, root)
            return self._unshard_logits(logits), caches
        x = self._scale_embed(self.embed[tokens])
        positions = positions_for(self.cfg, x.shape[0], 1, offset=pos,
                                  device=x.device)
        x, _ = self._run_groups(x, positions, caches=caches, cache_index=pos,
                                enc_out=enc_out)
        return self._logits(x), caches



    # ---- the mesh: the reference's SPMD program, lane by lane ------------
    def _root(self):
        return _Root(self.ctx, regather=self.remat and
                     torch.is_grad_enabled())

    def _dp(self):
        return self.ctx.rules.get("batch")

    def _split_batch(self, t):
        """A whole batch tensor split over the batch axes (dim 0)."""
        return spmd.shard(t, P(self._dp()), self.ctx.mesh)

    def _unshard_batch(self, parts):
        return spmd.unshard(parts, P(self._dp()), self.ctx.mesh)

    def _vocab_split(self) -> bool:
        return split_over_model(dense_spec(self.embed.spec, self.ctx), 0)

    def _unshard_logits(self, logits):
        return spmd.unshard(logits, P(self._dp(), None, "model"
                                      if self._vocab_split() else None),
                            self.ctx.mesh)

    def _norm_lanes(self, x, p: Norm):
        w = lane_weights(p, self.ctx)
        return spmd.lanewise(
            lambda wl, t: apply_norm(t, wl, self.cfg.norm_type), w, x)

    def _lookup_lanes(self, tokens, root):
        """The vocab-parallel embedding: each lane looks its tokens up in
        its vocab range (zeros outside it), then a ``psum`` over
        'model'."""
        mesh = self.ctx.mesh
        E = root.gather(self.embed, dense_spec(self.embed.spec, self.ctx))
        if not self._vocab_split():
            x = spmd.lanewise(lambda e, t: e[t], E, tokens)
        else:
            def lookup(e, t, m):
                Vl = e.shape[0]
                i = t - int(m) * Vl
                inside = (i >= 0) & (i < Vl)
                rows = e[torch.where(inside, i, 0)]
                return rows * inside[..., None].to(rows.dtype)
            x = spmd.psum(spmd.lanewise(lookup, E, tokens,
                                        spmd.axis_index(mesh, "model")),
                          "model", mesh)
        return spmd.lanewise(self._scale_embed, x)

    def _embed_lanes(self, batch: dict, root):
        cfg = self.cfg
        x = self._lookup_lanes(self._split_batch(batch["tokens"]), root)
        if cfg.modality_stub == "image_patches" and "patches" in batch:
            x = spmd.lanewise(lambda pt, t: torch.cat([pt.to(t.dtype), t],
                                                      dim=1),
                              self._split_batch(batch["patches"]), x)
        if cfg.rope_type == "mrope" and "positions" in batch:
            positions = self._split_batch(batch["positions"])
        else:
            positions = spmd.lanewise(lambda t: positions_for(
                cfg, t.shape[0], t.shape[1], device=t.device), x)
        return x, positions

    def _logits_lanes(self, x, root):
        x = self._norm_lanes(x, self.norm_f)
        if self.cfg.tie_embeddings:
            W = root.gather(self.embed, dense_spec(self.embed.spec,
                                                   self.ctx))
            return spmd.lanewise(lambda t, w: (t @ w.T).float(), x, W)
        W = root.gather(self.unembed, dense_spec(self.unembed.spec,
                                                 self.ctx))
        return spmd.lanewise(lambda t, w: (t @ w).float(), x, W)

    def _encode_lanes(self, batch: dict, root):
        x = spmd.lanewise(lambda t: t.to(self.dtype),
                          self._split_batch(batch["frames"]))
        positions = spmd.lanewise(lambda t: positions_for(
            self.cfg, t.shape[0], t.shape[1], device=t.device), x)
        x, _ = self._run_lanes(x, positions, encoder=True, causal=False)
        return self._norm_lanes(x, self.enc_norm_f)

    def _forward_lanes(self, batch: dict, root):
        enc = self._encode_lanes(batch, root) if self.cfg.is_encdec else None
        x, positions = self._embed_lanes(batch, root)
        x, aux = self._run_lanes(x, positions, enc_out=enc)
        return self._logits_lanes(x, root), aux

    def _loss_lanes(self, logits, targets, aux):
        """The vocab-parallel masked next-token loss (``loss_fn``): the
        log-softmax's max by ``pmax`` and its sum by ``psum`` over
        'model', the target's logit from the lane that holds it."""
        mesh = self.ctx.mesh
        targets = self._split_batch(targets)
        S = targets.flat[0].shape[1]
        logits = spmd.lanewise(lambda z: z[:, -S:], logits)  # vlm patches
        if self._vocab_split():
            m = spmd.pmax(spmd.lanewise(
                lambda z: z.detach().amax(dim=-1, keepdim=True), logits),
                "model", mesh)
            s = spmd.psum(spmd.lanewise(
                lambda z, mx: torch.exp(z - mx).sum(dim=-1, keepdim=True),
                logits, m), "model", mesh)

            def pick(z, t, mi):
                Vl = z.shape[-1]
                i = t.long() - int(mi) * Vl
                inside = (i >= 0) & (i < Vl)
                got = torch.gather(z, -1, torch.where(inside, i, 0)[..., None])
                return got[..., 0] * inside.to(z.dtype)
            zt = spmd.psum(spmd.lanewise(pick, logits, targets,
                                         spmd.axis_index(mesh, "model")),
                           "model", mesh)
            ll = spmd.lanewise(
                lambda t, mx, sm: (t - mx[..., 0]) - torch.log(sm[..., 0]),
                zt, m, s)
        else:
            ll = spmd.lanewise(lambda z, t: torch.gather(
                torch.log_softmax(z, dim=-1), -1,
                t.clamp_min(0)[..., None].long())[..., 0], logits, targets)
        num = spmd.lanewise(lambda v, t: -(v * (t >= 0).float()).sum(), ll,
                            targets)
        den = spmd.lanewise(lambda t: (t >= 0).float().sum(), targets)
        if self._dp() is not None:
            num = spmd.psum(num, self._dp(), mesh)
            den = spmd.psum(den, self._dp(), mesh)
        loss = spmd.lanewise(lambda a, b: a / torch.clamp_min(b, 1.0), num,
                             den)
        if self.cfg.moe is not None:
            loss = spmd.lanewise(lambda a, b: a + 0.01 * b, loss, aux)
        return loss

    def _run_lanes(self, x, positions, *, encoder: bool = False,
                   caches: list | None = None,
                   cache_index: int | None = None, enc_out=None,
                   causal: bool = True):
        """``_run_groups`` on lanes arrays."""
        layers = self.enc_layers if encoder else self.layers

        def run_unit(first: int, count: int, x, aux_total):
            for i in range(first, first + count):
                x, aux = self._block_lanes(
                    layers[i], x, positions,
                    cache=None if caches is None else caches[i],
                    cache_index=cache_index, enc_out=enc_out, causal=causal)
                aux_total = spmd.lanewise(torch.add, aux_total, aux)
            return x, aux_total

        aux_total = spmd.lanewise(lambda t: torch.zeros(
            (), dtype=torch.float32, device=t.device), x)
        return self._by_units(run_unit, x, aux_total, encoder=encoder,
                              caches=caches)

    def _block_lanes(self, p: Block, x, positions, *, cache, cache_index,
                     enc_out, causal):
        cfg, ctx = self.cfg, self.ctx
        mixer, ffn = p.desc
        state = None if cache is None else cache[mixer]
        h = self._norm_lanes(x, p.norm1)
        if mixer == "attn":
            a = attention_lanes(
                p.attn, h, positions, cfg, ctx, causal=causal,
                caches=None if state is None else _lane_dicts(state),
                cache_index=cache_index,
                kv_seq_sharded=self.long_context and not cfg.sliding_window)
        elif mixer == "mamba":
            # unroll: one full-sequence chunk (the reference's roofline mode)
            a = mamba_lanes(p.mamba, h, cfg.mamba, ctx, cache=state,
                            chunk=h.flat[0].shape[1] if self.unroll else 256,
                            scan_dtype=self.ssm_dtype)
        elif mixer == "mlstm":
            a = mlstm_lanes(p.mlstm, h, cfg.num_heads, cfg.xlstm, ctx,
                            cache=state)
        else:
            a = slstm_lanes(p.slstm, h, cfg.num_heads, ctx, cache=state)
        x = spmd.lanewise(torch.add, x, a)
        if enc_out is not None:
            h = self._norm_lanes(x, p.norm_x)
            a = attention_lanes(p.xattn, h, positions, cfg, ctx,
                                causal=False, cross_kv=enc_out)
            x = spmd.lanewise(torch.add, x, a)
        aux = spmd.lanewise(lambda t: torch.zeros(
            (), dtype=torch.float32, device=t.device), x)
        if ffn in ("ffn", "moe"):
            h = self._norm_lanes(x, p.norm2)
            if ffn == "ffn":
                y = ffn_lanes(p.ffn, h, cfg.mlp_type, ctx)
            else:
                y, aux = moe_lanes(p.moe, h, cfg.moe, cfg.mlp_type, ctx)
            x = spmd.lanewise(torch.add, x, y)
        return x, aux


def _lane_dicts(tree: dict) -> np.ndarray:
    """{key: lanes array or ``spmd.Lanes``} -> a lanes array of dicts."""
    parts = {k: (v.parts if isinstance(v, spmd.Lanes) else v)
             for k, v in tree.items()}
    shape = next(iter(parts.values())).shape
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        out[idx] = {k: v[idx] for k, v in parts.items()}
    return out


class _Root:
    """FSDP's root unit, the weights used outside the layer stack (the
    embedding, the unembedding): gathered once a forward (``gather``)
    and, for the backward, once more.  Under ``regather`` a saved tensor
    that is (a view of) one of them is kept as a recipe, not a tensor;
    the first one the backward unpacks gathers every root weight again
    (``dist.spmd`` counts it), and the recipes read that."""

    def __init__(self, ctx: ShardCtx, regather: bool):
        self.ctx = ctx
        self.regather = regather
        self.gathered: dict = {}   # storage key -> (weight, target, idx)
        self.weights: dict = {}    # id(weight) -> (weight, target)
        self.again: dict | None = None

    def __enter__(self):
        if self.regather:
            self._hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack)
            self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        if self.regather:
            self._hooks.__exit__(*exc)
        return False

    def gather(self, w, target):
        key = (id(w), tuple(target))
        if key in self.weights:
            return self.weights[key][2]
        parts = gather_to(w, target, self.ctx)
        self.weights[key] = (w, target, parts)
        if self.regather:
            for idx in np.ndindex(parts.shape):
                self.gathered[_storage(parts[idx])] = (key, idx)
        return parts

    def _pack(self, t):
        hit = self.gathered.get(_storage(t))
        if hit is None:
            return t
        return (hit, t.size(), t.stride(), t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        (key, idx), size, stride, offset = packed
        if self.again is None:
            with torch.no_grad():
                self.again = {k: gather_to(w, target, self.ctx)
                              for k, (w, target, _) in self.weights.items()}
        return self.again[key][idx].as_strided(size, stride, offset)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def build_model(cfg: ArchConfig, ctx: ShardCtx | None = None, *,
                device=None, seed: int = 0, **kw) -> Model:
    return Model(cfg, ctx=ctx, device=device, seed=seed, **kw)


def param_count(cfg: ArchConfig) -> int:
    """The parameter count of ``cfg``, counted on the meta device."""
    return Model(cfg, device="meta").param_count()
