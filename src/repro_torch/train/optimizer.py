"""Optimizers by hand: AdamW and Adafactor, the reference's arithmetic.

``torch.optim.AdamW`` computes something else (no float32 master copy;
decay and bias correction in another order), so the update is written
out as ``repro.train.optimizer`` writes it.  The state is kept in the
reference's layout: one entry per leaf of its parameter tree
(``models.convert.reference_leaves``), a layer group's leaf stacked on a
leading [repeat] axis.  So the three statistics the reference takes over
a whole stacked leaf span all the layers of the group here too:
Adafactor's update-RMS clip, its factoring test (decided on the stacked
shape) and, in ``train_step``, the int8 error feedback's scale.

Each leaf's gradients arrive stacked (``Leaf.stack``); the new values are
written into the model's parameters in place (``Leaf.write``).  The
schedule and the bias corrections are float32 tensors, as in the
reference, so no step rounds in float64.

On a mesh (a leaf of ``nn.ShardedParameter``s) the state is resident as
the parameters are: each of ``m``, ``v``, ``master``, ``vr``, ``vc`` an
``spmd.Lanes`` of the lane's shard of the stacked leaf.  AdamW is
elementwise on each shard.  What spans a leaf becomes a reduction over
the lanes that split it: the global norm sums each leaf's ``psum`` of
the lanes' sums of squares, in leaf order; Adafactor's row and column
means ``psum`` over the axes that split the reduced dim, and its RMS clip
over every axis that splits the leaf.  A shard held by several lanes is
updated the same way on each.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.dist import spmd
from repro_torch.dist.context import NamedSharding, P, _axes_tuple, spec_axes
from repro_torch.models.convert import Leaf


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # mixed precision: keep fp32 master weights when params are bf16
    master_fp32: bool = True
    # adafactor
    factored_min_dim: int = 128


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The warmup-then-cosine learning rate at ``step``, a float32 tensor
    (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps, 1),
                       0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def init_opt_state(leaves: list[Leaf], cfg: OptConfig) -> dict:
    """-> {"step": int32 0-d tensor, "ema": {leaf path: {"m", "v",
    "master"} or {"vr", "vc" or "v", "master"}}}, float32 tensors of the
    reference's stacked shapes on the leaves' device."""
    dev = leaves[0].tensors[0].device
    ema = {}
    for leaf in leaves:
        sh = leaf.shape
        spec = leaf.spec if leaf.sharded else None
        zeros = (_lane_zeros(leaf) if leaf.sharded else
                 lambda shape, spec: torch.zeros(shape, dtype=torch.float32,
                                                 device=dev))
        if cfg.name == "adamw":
            st = {"m": zeros(sh, spec), "v": zeros(sh, spec)}
        elif _factored(sh, cfg.factored_min_dim):
            st = {"vr": zeros(sh[:-1], spec and P(*spec[:-1])),
                  "vc": zeros(sh[:-2] + sh[-1:],
                              spec and P(*spec[:-2], spec[-1]))}
        else:
            st = {"v": zeros(sh, spec)}
        if cfg.master_fp32 and leaf.dtype != torch.float32:
            st["master"] = (
                spmd.Lanes(spmd.lanewise(lambda t: t.to(torch.float32),
                                         leaf.lanes()), spec,
                           leaf.tensors[0].mesh, sh, torch.float32)
                if leaf.sharded else leaf.stack().to(torch.float32))
        ema[leaf.path] = st
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "ema": ema}


def _lane_zeros(leaf: Leaf):
    mesh = leaf.tensors[0].mesh

    def zeros(shape, spec):
        local = NamedSharding(mesh, spec).shard_shape(shape)
        parts = np.empty(mesh.devices.shape, dtype=object)
        for idx in np.ndindex(parts.shape):
            parts[idx] = torch.zeros(local, dtype=torch.float32,
                                     device=mesh.devices[idx]
                                     if leaf.tensors[0].device.type != "meta"
                                     else "meta")
        return spmd.Lanes(parts, spec, mesh, shape, torch.float32)
    return zeros


def _lane_sum(parts, axes, mesh):
    """Each lane's local sum, summed over the lanes that split it."""
    return spmd.psum(parts, axes, mesh) if axes else parts


def clip_by_global_norm(grads: list, max_norm: float):
    """-> (scale, gnorm): the global norm of ``grads`` (each leaf's sum of
    squares in float32, summed in leaf order) and the clip factor
    ``min(1, max_norm / gnorm)``.  ``apply_updates`` scales each leaf as
    the reference does (``g.float() * scale``) when it comes to it, so
    no float32 copy of every gradient is held at once.  A gradient on a
    mesh (``spmd.Lanes``) adds its lanes' sums over the axes that split
    it; the result is the first lane's (every lane holds it)."""
    def sumsq(g):
        if not isinstance(g, spmd.Lanes):
            return torch.sum(torch.square(g.to(torch.float32)))
        ss = spmd.lanewise(lambda t: torch.sum(torch.square(
            t.to(torch.float32))), g.parts)
        return _lane_sum(ss, spec_axes(g.spec), g.mesh).flat[0]
    total = None
    for g in grads:
        s = sumsq(g)
        total = s if total is None else total + s.to(total.device)
    gnorm = torch.sqrt(total)
    # a true division: ``float / tensor`` would be a reciprocal, then a
    # product (two roundings)
    limit = torch.full_like(gnorm, max_norm)
    scale = torch.clamp(limit / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return scale, gnorm


def _adam(gf, st: dict, master, cfg: OptConfig, lr, step):
    """The reference's AdamW leaf update, in place where it can be (same
    operations, same order).  Returns the new master value."""
    b1, b2 = cfg.b1, cfg.b2
    m, v = st["m"], st["v"]
    m.mul_(b1).add_((1 - b1) * gf)
    v.mul_(b2).add_(gf.square_().mul_(1 - b2))
    del gf
    upd = m / (1 - torch.pow(b1, step))                   # mh
    vh = v / (1 - torch.pow(b2, step))
    upd.div_(vh.sqrt_().add_(cfg.eps))
    del vh
    upd.add_(cfg.weight_decay * master)
    return master.sub_(upd.mul_(lr))


def _adafactor(gf, st: dict, master, cfg: OptConfig, lr):
    """The reference's Adafactor leaf update, over the whole stacked leaf
    (its RMS clip spans every layer of the group)."""
    b2 = cfg.b2
    g2 = torch.square(gf) + 1e-30
    if "vr" in st:
        st["vr"].mul_(b2).add_((1 - b2) * g2.mean(dim=-1))
        st["vc"].mul_(b2).add_((1 - b2) * g2.mean(dim=-2))
        vr, vc = st["vr"], st["vc"]
        denom = (vr / torch.clamp_min(vr.mean(dim=-1, keepdim=True),
                                      1e-30))[..., None] * vc[..., None, :]
        upd = gf * torch.rsqrt(denom + 1e-30)
    else:
        st["v"].mul_(b2).add_((1 - b2) * g2)
        upd = gf * torch.rsqrt(st["v"] + 1e-30)
    # update clipping (Adafactor's d=1.0 RMS rule)
    rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
    upd = upd / torch.clamp_min(rms, 1.0)
    return master.sub_(lr * (upd + cfg.weight_decay * master))


def _adafactor_lanes(g: spmd.Lanes, st: dict, master: spmd.Lanes,
                     cfg: OptConfig, lr, scale):
    """``_adafactor`` on a sharded leaf: the means over a dim split over
    lanes add the lanes' local sums (``psum`` over its axes) before the
    division by its global size."""
    mesh, spec, shape = g.mesh, tuple(g.spec), g.shape
    spec += (None,) * (len(shape) - len(spec))
    b2 = cfg.b2

    def mean(parts, dim, axes_of, n):
        local = spmd.lanewise(
            lambda t: t.sum(dim=dim) if isinstance(dim, int) else t.sum(),
            parts)
        return spmd.lanewise(lambda t: t / n,
                             _lane_sum(local, axes_of, mesh))
    gf = spmd.lanewise(lambda t: t.to(torch.float32) * scale.to(t.device),
                       g.parts)
    g2 = spmd.lanewise(lambda t: torch.square(t) + 1e-30, gf)
    if "vr" in st:
        row = mean(g2, -1, _axes_tuple(spec[-1]), shape[-1])
        col = mean(g2, -2, _axes_tuple(spec[-2]), shape[-2])
        spmd.lanewise(lambda v, r: v.mul_(b2).add_((1 - b2) * r),
                      st["vr"].parts, row)
        spmd.lanewise(lambda v, c: v.mul_(b2).add_((1 - b2) * c),
                      st["vc"].parts, col)
        vr_mean = mean(st["vr"].parts, -1, _axes_tuple(spec[-2]),
                       shape[-2])
        upd = spmd.lanewise(
            lambda t, vr, vc, vm: t * torch.rsqrt(
                (vr / torch.clamp_min(vm[..., None], 1e-30))[..., None]
                * vc[..., None, :] + 1e-30),
            gf, st["vr"].parts, st["vc"].parts, vr_mean)
    else:
        spmd.lanewise(lambda v, t: v.mul_(b2).add_((1 - b2) * t),
                      st["v"].parts, g2)
        upd = spmd.lanewise(lambda t, v: t * torch.rsqrt(v + 1e-30), gf,
                            st["v"].parts)
    del gf, g2
    ms = mean(spmd.lanewise(torch.square, upd), None, spec_axes(spec),
              math.prod(shape))
    return spmd.lanewise(
        lambda u, m, w: w.sub_(lr.to(w.device) * (
            u / torch.clamp_min(torch.sqrt(m + 1e-30), 1.0)
            + cfg.weight_decay * w)), upd, ms, master)


def _update_lanes(leaf: Leaf, g: spmd.Lanes, st: dict, cfg: OptConfig, lr,
                  stepf, scale):
    """One sharded leaf's update, lane by lane; writes the pieces."""
    mesh, spec = g.mesh, leaf.spec
    master = (st["master"] if "master" in st else spmd.Lanes(
        spmd.lanewise(lambda t: t.to(torch.float32, copy=True),
                      leaf.lanes()), spec, mesh, leaf.shape, torch.float32))
    if cfg.name == "adamw":
        new = spmd.lanewise(
            lambda t, m, v, w: _adam(
                t.to(torch.float32) * scale.to(t.device), {"m": m, "v": v},
                w, cfg, lr.to(t.device), stepf.to(t.device)),
            g.parts, st["m"].parts, st["v"].parts, master.parts)
    else:
        new = _adafactor_lanes(g, st, master.parts, cfg, lr, scale)
    leaf.write_lanes(new)


@torch.no_grad()
def apply_updates(leaves: list[Leaf], grads: list, state: dict,
                  cfg: OptConfig):
    """One optimizer step: ``grads`` (one stacked tensor per leaf, in
    ``leaves``' order; on a mesh an ``spmd.Lanes`` of each lane's
    shard) clipped by their global norm, then AdamW or Adafactor.
    Writes the new values into the leaves' parameters and updates
    ``state`` in place; -> (state, {"lr", "grad_norm"})."""
    step = state["step"].add_(1)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    scale, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    for leaf, g in zip(leaves, grads):
        st = state["ema"][leaf.path]
        if isinstance(g, spmd.Lanes):
            _update_lanes(leaf, g, st, cfg, lr, stepf, scale)
            continue
        gf = g.to(torch.float32) * scale
        master = st["master"] if "master" in st else \
            leaf.stack().to(torch.float32, copy=True)
        if cfg.name == "adamw":
            new = _adam(gf, st, master, cfg, lr, stepf)
        else:
            new = _adafactor(gf, st, master, cfg, lr)
        leaf.write(new)
    return state, {"lr": lr, "grad_norm": gnorm}
