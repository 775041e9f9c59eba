"""The assigned input shapes, per-cell applicability, and their specs.

All four shapes come from the assignment table; ``decode_*``/``long_*``
are one token against a ``seq_len`` KV cache, not a training step.
``long_500k`` runs only for sub-quadratic archs; the modality frontends
are stubs (precomputed frame or patch embeddings in the inputs).  Specs
are ``meta`` tensors: shapes and dtypes, no storage.

The reference stacks each layer group's caches on a leading [L] axis; the
port keeps one cache dict a layer, so ``cache_shardings`` applies the
reference's rules by each leaf's reference path with every axis index one
lower.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.context import NamedSharding, P, ShardCtx
from repro_torch.models.model import _init_cache_block, layer_paths


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    long: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, long=True),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.long and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch"
    return True, ""


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The token batch as ``meta`` tensors."""
    B = shape.global_batch
    if shape.kind == "train":
        S = shape.seq_len
        out = {"tokens": _i32(B, S), "targets": _i32(B, S)}
    elif shape.kind == "prefill":
        S = shape.seq_len
        out = {"tokens": _i32(B, S)}
    else:  # decode: one new token; the cache covers seq_len
        out = {"tokens": _i32(B, 1)}
        return _add_modality(cfg, out, B, 1, decode=True)
    return _add_modality(cfg, out, B, S, decode=False)


def _add_modality(cfg: ArchConfig, out: dict, B: int, S: int, *,
                  decode: bool) -> dict:
    if cfg.modality_stub == "audio_frames" and not decode:
        out["frames"] = _f32(B, cfg.stub_frames, cfg.d_model)
    if cfg.modality_stub == "image_patches" and not decode:
        # patches are part of the sequence budget: text tokens = S - patches
        pp = min(cfg.img_patches, S // 2)
        out["tokens"] = _i32(B, S - pp)
        out["patches"] = _f32(B, pp, cfg.d_model)
        out["positions"] = _i32(B, S, 3)
    return out


def batch_shardings(cfg: ArchConfig, shape: ShapeSpec, ctx: ShardCtx) -> dict:
    def spec(leaf_name):
        if leaf_name in ("frames", "patches", "positions"):
            return ctx.logical_sharding(("batch", "seq", None))
        return ctx.logical_sharding(("batch", "seq"))

    return {k: (spec(k) if v.dim() > 1 else ctx.logical_sharding(("batch",)))
            for k, v in batch_specs(cfg, shape).items()}


# --------------------------------------------------------------------------
# cache shardings (path-matched: robust across heterogeneous arch families)
# --------------------------------------------------------------------------
def reference_path(layer_path: str, keys: tuple[str, ...]) -> str:
    """A cache leaf's path as the reference spells it for its rules
    (``jax.tree_util`` dict keys, "['group0']/['b0']/['attn']/['k']")."""
    return "/".join(f"['{k}']" for k in (*layer_path.split("/"), *keys))


def _leaves(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def cache_shardings(caches: list[dict], cfg: ArchConfig,
                    ctx: ShardCtx) -> list[dict]:
    """One cache dict a layer -> the same structure of NamedShardings, by
    each leaf's reference path."""
    mesh = ctx.mesh

    def rule(path_str: str, leaf) -> NamedSharding:
        ndim = leaf.dim()
        dp = ctx.rules.get("batch")
        tp = ctx.rules.get("q_heads")
        kvseq = ctx.rules.get("kv_seq")
        axes: list = [None] * ndim
        if "attn" in path_str and "pos" in path_str.rsplit("/", 1)[-1]:
            pass  # replicated ring positions
        elif "attn" in path_str:  # [B, S, K, hd]
            axes[0] = dp
            if kvseq is not None and not cfg.sliding_window:
                axes[1] = kvseq
            if tp is not None and \
                    leaf.shape[2] % ctx.axis_size("q_heads") == 0:
                axes[2] = tp
        elif "mamba" in path_str:  # conv [B, dc, di] | ssm [B, di, N]
            axes[0] = dp
            # as the reference: its path ends "['conv']", never "conv", so
            # both states split their axis 1 here (its axis 2)
            di_axis = 2 if path_str.endswith("conv") else 1
            if tp is not None and \
                    leaf.shape[di_axis] % ctx.axis_size("q_heads") == 0:
                axes[di_axis] = tp
        elif "mlstm" in path_str or "slstm" in path_str:
            axes[0] = dp  # [B, ...]: batch-shard recurrent states
        return NamedSharding(mesh, P(*axes))

    out = []
    for layer, cache in zip(layer_paths(cfg), caches):
        one: dict = {}
        for keys, leaf in _leaves(cache):
            node = one
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = rule(reference_path(layer, keys), leaf)
        out.append(one)
    return out


def decode_input_specs(model, cfg: ArchConfig, shape: ShapeSpec):
    """(caches, tokens, pos, enc_out) of one decode step, as ``meta``
    tensors; the caches whole (the global arrays), also on a mesh."""
    B, S = shape.global_batch, shape.seq_len
    caches = [_init_cache_block(block.desc, cfg, B, S, model.ctx,
                                model.dtype, "meta")
              for block in model.layers]
    toks = _i32(B, 1)
    pos = _i32()
    enc_out = None
    if cfg.is_encdec:
        enc_out = torch.empty((B, cfg.stub_frames, cfg.d_model),
                              dtype=(torch.bfloat16
                                     if cfg.dtype == "bfloat16"
                                     else torch.float32), device="meta")
    return caches, toks, pos, enc_out


def make_concrete(spec_tree, rng: np.random.Generator, vocab: int):
    """Spec trees (dicts, lists, tuples of ``meta`` tensors) with values
    from ``rng`` on the CPU: int32 ids below ``vocab``, normal floats."""
    def one(s):
        if s is None:
            return None
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(one(v) for v in s)
        if s.dtype == torch.int32:
            arr = rng.integers(0, vocab, tuple(s.shape)).astype(np.int32)
            return torch.from_numpy(arr)
        arr = rng.standard_normal(tuple(s.shape))
        return torch.from_numpy(arr).to(s.dtype)

    return one(spec_tree)
