"""Train step: loss, backward, optional int8 error-feedback gradient
compression, optimizer update — the reference's ``repro.train.train_step``
in eager PyTorch.

One step runs ``loss.backward()``, stacks each leaf's gradients into the
reference's layout (``models.convert.Leaf``), optionally compresses them
(``ef_compress_grads``, with one int8 scale over the whole stacked leaf,
as the reference's), and calls ``apply_updates``, which writes the new
values into the model's parameters in place.  The step updates the
``TrainState`` in place too and returns it, so a state stays bound to its
model (the reference returns a new state).

On a mesh each leaf's gradient is an ``spmd.Lanes`` of the lanes'
stacked shards: a piece's own gradient (the FSDP gathers' backward has
reduce-scattered it over the data axes), summed by a ``psum`` over the
axes the leaf is replicated on (the gradient all-reduce); the int8
scale is a ``pmax`` over the axes that split the leaf.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import spmd
from repro_torch.dist.context import spec_axes
from repro_torch.models.convert import Leaf, reference_leaves
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)


@dataclasses.dataclass
class TrainState:
    params: list[Leaf]   # the model's parameters, as the reference's leaves
    opt: dict            # optimizer state (reference layout, by leaf path)
    ef: dict | None      # error-feedback buffers by leaf path (or None)
    step: torch.Tensor   # int32 0-d


# ---- int8 error-feedback compression ---------------------------------------
def quantize_int8(x: torch.Tensor):
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _ef_lanes(g: spmd.Lanes, e: spmd.Lanes):
    """``ef_compress_grads`` of one sharded leaf: the scale's maximum
    over the lanes that split it."""
    gf = spmd.lanewise(lambda a, b: a.to(torch.float32) + b, g.parts, e.parts)
    axes = spec_axes(g.spec)
    top = spmd.lanewise(lambda t: torch.amax(torch.abs(t)), gf)
    if axes:
        top = spmd.pmax(top, axes, g.mesh)

    def one(t, m, like):
        scale = m / 127.0 + 1e-30
        q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
        deq = dequantize_int8(q, scale)
        return deq.to(like.dtype), t - deq
    deq, err = spmd.lanewise(one, gf, top, g.parts)
    return (spmd.Lanes(deq, g.spec, g.mesh, g.shape, g.dtype),
            spmd.Lanes(err, e.spec, e.mesh, e.shape, e.dtype))


def ef_compress_grads(grads: list, ef: list):
    """Error-feedback int8 over stacked leaves: g' = deq(quant(g + e)),
    e' = (g + e) - g'.  -> (grads, ef) as new lists."""
    new_g, new_e = [], []
    for g, e in zip(grads, ef):
        if isinstance(g, spmd.Lanes):
            dg, de = _ef_lanes(g, e)
            new_g.append(dg)
            new_e.append(de)
            continue
        gf = g.to(torch.float32) + e
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        new_g.append(deq.to(g.dtype))
        new_e.append(gf - deq)
    return new_g, new_e


def init_ef(leaves: list[Leaf]) -> dict:
    out = {}
    for leaf in leaves:
        if leaf.sharded:
            out[leaf.path] = spmd.Lanes(
                spmd.lanewise(lambda t: torch.zeros(
                    t.shape, dtype=torch.float32, device=t.device),
                    leaf.lanes()), leaf.spec, leaf.tensors[0].mesh,
                leaf.shape, torch.float32)
        else:
            out[leaf.path] = torch.zeros(leaf.shape, dtype=torch.float32,
                                         device=leaf.tensors[0].device)
    return out


# ---- step factory ----------------------------------------------------------
def make_init_state(model: Model, opt_cfg: OptConfig, *,
                    grad_compression: bool = False):
    """-> ``init_state()``: a fresh state over ``model``'s current
    parameters (its ``torch.Generator`` initialisation)."""
    def init_state() -> TrainState:
        leaves = reference_leaves(model)
        return TrainState(
            params=leaves,
            opt=init_opt_state(leaves, opt_cfg),
            ef=init_ef(leaves) if grad_compression else None,
            step=torch.zeros((), dtype=torch.int32, device=model.device),
        )
    return init_state


def stacked_grads(leaves: list[Leaf]) -> list[torch.Tensor]:
    """Each leaf's gradients in the reference's layout; the parameters'
    own ``.grad`` is released as it goes (zeros for a parameter the loss
    did not reach)."""
    out = []
    for leaf in leaves:
        if leaf.sharded:
            out.append(_lane_grads(leaf))
            continue
        parts = [torch.zeros_like(t) if t.grad is None else t.grad
                 for t in leaf.tensors]
        out.append(leaf.stack(parts))
        for t in leaf.tensors:
            t.grad = None
    return out


def _lane_grads(leaf: Leaf) -> spmd.Lanes:
    """A sharded leaf's gradient: each lane's stacked piece gradients,
    summed over the axes the leaf is replicated on."""
    mesh = leaf.tensors[0].mesh

    def grads(t):
        if spmd.representative():  # one lane's program (dist/spmd.py)
            p = t.pieces[0]
            return [torch.zeros_like(p) if p.grad is None else p.grad] \
                * len(t.pieces)
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in t.pieces]
    parts = [t.lanes(grads(t)) for t in leaf.tensors]
    for t in leaf.tensors:
        for p in t.pieces:
            p.grad = None
    g = leaf.lanes(parts)
    used = spec_axes(leaf.spec)
    rest = tuple(a for a in mesh.axis_names if a not in used)
    if rest:
        g = spmd.psum(g, rest, mesh)
    return spmd.Lanes(g, leaf.spec, mesh, leaf.shape, leaf.dtype)


def make_train_step(model: Model, opt_cfg: OptConfig, *,
                    grad_compression: bool = False):
    """-> ``train_step(state, batch) -> (state, metrics)``: ``batch``
    holds tensors on the model's device; ``state`` is updated in place
    and returned; the metrics are 0-d tensors (reading one waits for the
    device)."""
    def train_step(state: TrainState, batch: dict):
        with torch.enable_grad():
            loss, metrics = model.loss_fn(batch)
            loss.backward()
        grads = stacked_grads(state.params)
        ef = state.ef
        if grad_compression:
            paths = [leaf.path for leaf in state.params]
            grads, new_e = ef_compress_grads(grads, [ef[p] for p in paths])
            ef = dict(zip(paths, new_e))
        state.opt, opt_metrics = apply_updates(state.params, grads,
                                               state.opt, opt_cfg)
        state.ef = ef
        state.step.add_(1)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics}
        return state, metrics

    return train_step
