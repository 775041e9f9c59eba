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

On a mesh (``ctx``, ``dist.context.make_rules``) the parameters and the
dense layers stay whole on the mesh's first lane; the expert-parallel MoE
and the sequence-sharded decode run lane by lane, as the reference's
``shard_map`` code does, and the KV caches repeat their heads for tensor
parallelism (``kv_repeat_for``).

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

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.dist.context import DISABLED, ShardCtx
from repro_torch.models.attention import (Attention, attention_apply,
                                          kv_repeat_for, positions_for)
from repro_torch.models.ffn import FFN, ffn_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.nn import DTYPES, Init, Norm, apply_norm
from repro_torch.models.ssm import Mamba, init_mamba_state, mamba_apply
from repro_torch.models.xlstm import (MLSTM, SLSTM, init_mlstm_state,
                                      init_slstm_state, mlstm_apply,
                                      slstm_apply)

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


def _apply_block(p: Block, x, positions, cfg: ArchConfig, ctx: ShardCtx, *,
                 cache, cache_index, enc_out, causal, long_context: bool,
                 ssm_dtype: str = "float32", unroll: bool = False):
    mixer, ffn = p.desc
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(x, p.norm1, cfg.norm_type)
    if mixer == "attn":
        a, _ = attention_apply(
            p.attn, h, positions, cfg, ctx, causal=causal,
            cache=None if cache is None else cache["attn"],
            cache_index=cache_index,
            kv_seq_sharded=long_context and not cfg.sliding_window)
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
    ``dist.context.make_rules``.  ``device=None`` means the mesh's first
    lane, or ``"cuda"`` without a mesh (raising when there is no GPU);
    ``device="meta"`` allocates nothing (``param_count``).  Parameters are
    drawn from a ``torch.Generator`` seeded by ``seed``.  The training
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
        init = Init(dev, seed)
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
        return sum(p.numel() for p in self.parameters())

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
                    long_context=self.long_context, ssm_dtype=self.ssm_dtype,
                    unroll=self.unroll)
                aux_total = aux_total + aux
            return x, aux_total

        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if not (self.remat and caches is None and torch.is_grad_enabled()):
            return run_unit(0, len(layers), x, aux_total)
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
        """One cache dict a layer, on ``device`` (default: the model's)."""
        return [_init_cache_block(block.desc, self.cfg, batch_size,
                                  cache_len, self.ctx, self.dtype,
                                  self.device if device is None else device)
                for block in self.layers]

    def prefill(self, batch: dict, cache_len: int):
        """-> (last-position logits [B, 1, V], caches, enc_out | None)."""
        enc_out = self._encode(batch) if self.cfg.is_encdec else None
        x, positions = self._embed_inputs(batch)
        caches = self.init_cache(x.shape[0], cache_len)
        x, _ = self._run_groups(x, positions, caches=caches, enc_out=enc_out)
        return self._logits(x[:, -1:]), caches, enc_out

    def decode_step(self, caches: list[dict], tokens, pos: int,
                    enc_out=None):
        """tokens: [B, 1]; pos: a Python int (uniform across the batch, so
        no host sync).  Updates ``caches`` in place; -> (logits, caches)."""
        x = self._scale_embed(self.embed[tokens])
        positions = positions_for(self.cfg, x.shape[0], 1, offset=pos,
                                  device=x.device)
        x, _ = self._run_groups(x, positions, caches=caches, cache_index=pos,
                                enc_out=enc_out)
        return self._logits(x), caches


def build_model(cfg: ArchConfig, ctx: ShardCtx | None = None, *,
                device=None, seed: int = 0, **kw) -> Model:
    return Model(cfg, ctx=ctx, device=device, seed=seed, **kw)


def param_count(cfg: ArchConfig) -> int:
    """The parameter count of ``cfg``, counted on the meta device."""
    return Model(cfg, device="meta").param_count()
