"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id>
[--reduced] [--device cuda|cpu]``.

Builds the model from a seeded ``torch.Generator``, prefills a batch of
random prompts and decodes with the batched ``ServeEngine``.  Runs on the
GPU unless ``--device cpu`` is given; without a GPU it raises.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine


def make_batch(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """Random prompts (and the stubbed modalities' inputs) from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.stub_frames, cfg.d_model)).astype(np.float32)
    if cfg.modality_stub == "image_patches":
        out["patches"] = rng.standard_normal(
            (batch, cfg.img_patches, cfg.d_model)).astype(np.float32)
        S = prompt_len + cfg.img_patches
        out["positions"] = np.broadcast_to(
            np.arange(S)[None, :, None], (batch, S, 3)).astype(np.int32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, seed=args.seed)
    engine = ServeEngine(model, device=device)
    toks, stats = engine.generate(
        make_batch(cfg, args.batch, args.prompt_len, args.seed),
        num_tokens=args.tokens, temperature=args.temperature, seed=args.seed)
    print(f"generated {toks.shape} tokens on {device}; prefill "
          f"{stats.prefill_seconds:.2f}s; decode {stats.decode_seconds:.2f}s; "
          f"{stats.tokens_per_second:.1f} tok/s")
    print("first sequence:", toks[0][:16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
