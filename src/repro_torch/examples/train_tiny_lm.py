"""Train a small LM end-to-end: a scaled-down stablelm-family config
(~25M params by default; --full trains ~110M) for a few hundred steps with
checkpointing, demonstrating the training substrate on real hardware.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm \
        [--steps 300] [--full] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises.
Checkpoints are written in the reference's format every 100 steps.
``main`` returns the losses, one a step.
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train import OptConfig, make_init_state, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLM


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true", help="~110M params")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = get_config("stablelm-1.6b")
    if args.full:
        cfg = dataclasses.replace(base, num_layers=8, d_model=768, num_heads=12,
                                  num_kv_heads=12, d_ff=2048, vocab_size=32768)
    else:
        cfg = dataclasses.replace(base, num_layers=6, d_model=384, num_heads=6,
                                  num_kv_heads=6, d_ff=1024, vocab_size=8192)
    model = build_model(cfg, device=device)
    n = model.param_count()
    print(f"model: {n/1e6:.1f}M params, {cfg.num_layers}L x d{cfg.d_model}")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=args.steps // 10,
                    decay_steps=args.steps)
    state = make_init_state(model, opt)()
    step_fn = make_train_step(model, opt)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    pf = Prefetcher(data)
    losses = []
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        ck = CheckpointManager(td)
        try:
            for step in range(args.steps):
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in pf.next().items()}
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                if (step + 1) % 25 == 0:
                    tok_s = args.batch * args.seq * (step + 1) / (time.time() - t0)
                    print(f"step {step+1:4d} loss {losses[-1]:.4f} "
                          f"({tok_s:.0f} tok/s)")
                if (step + 1) % 100 == 0:
                    ck.save(step + 1, state)
        finally:
            pf.close()
            ck.close()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.time()-t0:.0f}s)")
    assert losses[-1] < losses[0], "training did not reduce loss"
    return losses


if __name__ == "__main__":
    main()
