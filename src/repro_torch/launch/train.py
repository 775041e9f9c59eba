"""Training CLI: ``python -m repro_torch.launch.train --arch <id>
[options] [--device cuda|cpu]``.

Production behaviours wired in:
  * checkpoint/restart — atomic keep-N checkpoints in the reference's
    file format, ``--resume`` picks up the latest (a checkpoint of
    ``python -m repro.launch.train`` resumes here, and the other way);
  * emergency checkpoint on SIGTERM/SIGINT;
  * deterministic host-local data (restart-safe, straggler-free);
  * optional int8 error-feedback gradient compression (--grad-compression);
  * ``--mesh dxm``: a (data, model) mesh of d * m lanes in this process
    (``dist.context.make_rules``'s layout): every weight and its optimizer
    state resident lane by lane, the model run as the reference's SPMD
    program (FSDP and batch over 'data', tensor parallel over 'model',
    the MoE expert-parallel).

``--device`` names the device: the GPU unless ``--device cpu`` is given
(without a GPU it raises).  With ``--mesh`` it names the lanes' devices:
``cuda`` wants one GPU a lane and raises with fewer, ``cpu`` gives CPU
lanes, and a comma-separated list names each lane's device, so
``--mesh 2x2 --device cuda:0,cuda:0,cuda:0,cuda:0`` puts the four lanes on
one card.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.dist.context import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.train import OptConfig, make_init_state, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLM


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 => (data, model)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = None
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        lanes = args.device.split(",")
        mesh = make_mesh((d, m), ("data", "model"),
                         lanes if len(lanes) > 1 else lanes[0])
        # the whole batch lands on the first lane, which splits it
        device = mesh.first_device
    else:
        device = resolve_device(args.device)
    model = build_model(cfg, make_rules(mesh, cfg),
                        device=None if mesh else device, seed=args.seed)
    opt = OptConfig(name=args.optimizer, peak_lr=args.lr,
                    warmup_steps=max(args.steps // 20, 1),
                    decay_steps=args.steps)
    state = make_init_state(model, opt,
                            grad_compression=args.grad_compression)()
    step_fn = make_train_step(model, opt,
                              grad_compression=args.grad_compression)

    ck = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ck and args.resume:
        restored = ck.restore(state)
        if restored is not None:
            state, start = restored
            print(f"resumed from step {start}")
    if start >= args.steps:  # interrupted after the final step: nothing to do
        print(f"done: {args.steps} steps (already complete at resume)")
        return 0

    stop = {"flag": False}

    def _sig(_s, _f):  # emergency checkpoint, then exit cleanly
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    pf = Prefetcher(data, start_step=start)
    t0 = time.time()
    tokens = 0
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(device).long()
                     for k, v in pf.next().items()}
            if cfg.is_encdec:
                batch["frames"] = torch.zeros(
                    (args.batch, cfg.stub_frames, cfg.d_model),
                    dtype=torch.float32, device=device)
            state, metrics = step_fn(state, batch)
            tokens += args.batch * args.seq
            if (step + 1) % args.log_every == 0:
                dt = time.time() - t0
                print(f"step {step+1} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"tok/s {tokens/dt:.0f}", flush=True)
            if ck and ((step + 1) % args.ckpt_every == 0 or stop["flag"]):
                ck.save(step + 1, state, sync=stop["flag"])
            if stop["flag"]:
                print(f"signal received: emergency checkpoint at {step+1}")
                return 0
        if ck:
            ck.save(args.steps, state, sync=True)
    finally:
        pf.close()
        if ck:
            ck.close()
    print(f"done: {args.steps} steps, final loss "
          f"{float(metrics['loss']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
