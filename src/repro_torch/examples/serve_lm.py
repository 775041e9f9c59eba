"""Serve a small model with batched requests: prefill + batched greedy
decode through the KV-cache engine (contiguous or ring-buffer SWA cache
depending on the arch).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        [--arch mixtral-8x22b] [--device cpu]
(archs run at reduced scale so this works on CPU)

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises.
The prompts are the reference example's (numpy seed 0), but the weights
come from the port's seeded ``torch.Generator``, so the tokens differ from
the reference example's; the model itself is held to the reference, with
its weights carried across, in ``tests/test_torch_serve_engine.py``.
``main`` returns the generated tokens.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=device, remat=False)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (args.batch, 24))}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (args.batch, cfg.stub_frames, cfg.d_model)).astype(np.float32)
    if cfg.modality_stub == "image_patches":
        batch["patches"] = rng.standard_normal(
            (args.batch, cfg.img_patches, cfg.d_model)).astype(np.float32)
        S = 24 + cfg.img_patches
        batch["positions"] = np.broadcast_to(
            np.arange(S)[None, :, None], (args.batch, S, 3)).astype(np.int32)
    engine = ServeEngine(model, device=device)
    toks, stats = engine.generate(batch, num_tokens=args.tokens)
    # greedy decode is deterministic: same prompt rows -> same outputs
    toks2, _ = engine.generate(batch, num_tokens=args.tokens)
    assert (toks == toks2).all()
    print(f"{args.arch} (reduced): batch={args.batch} generated "
          f"{stats.tokens_generated} tokens, "
          f"prefill {stats.prefill_seconds:.2f}s, "
          f"{stats.tokens_per_second:.0f} tok/s decode")
    print("sample:", toks[0][:12].tolist())
    return toks


if __name__ == "__main__":
    main()
