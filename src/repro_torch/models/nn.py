"""Parameter initialisation and the numerics shared by every block.

Weights live in ``nn.Module``s.  ``Init`` makes each ``nn.Parameter``
directly on its device, filled from one explicit ``torch.Generator`` (the
role of the reference's ``KeyGen``): the same shapes, dtypes and
distributions as the reference's initialisers, not the same values.  Each
parameter carries the reference's logical axes as ``param.axes``.  On
the ``meta`` device it allocates nothing, which is how ``param_count``
counts a full-size model.

On an enabled ``ShardCtx`` a weight is resident lane by lane: ``Init``
makes it whole on the mesh's first lane (the same values as without a
mesh, from the same seed), cuts it by ``ctx.param_sharding`` and copies
each lane's piece to that lane's device into storage of its own; the
whole is then freed.  The weight is a ``ShardedParameter``: a module
whose ``pieces`` (one ``nn.Parameter`` a lane, row-major over the mesh)
are what the optimizer updates, and which carries the global ``shape``,
``dtype``, ``axes`` and the ``sharding``, so the reference's leaf is
still seen whole (``models.convert.Leaf``).  A module, not a parameter
list beside the weight: it sits where the parameter sat, under the same
name, so the state-dict path of a piece is the weight's path plus
``pieces.<lane>``, and ``named_weights`` walks a model's weights the same
way with a mesh or without.  ``lane_weights`` hands a block's weights to
its lanes, all-gathering the dims a layer needs whole (the FSDP split of
'embed' over the data axes).

The numerics follow the reference exactly where torch's defaults differ:
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default), the layer
norm's variance is the population variance, and both norms compute in
float32 and cast back to the input's dtype.  The activations run op by op
in their input's dtype, with each Python constant first rounded to that
dtype, as the reference's weakly typed constants are: in bfloat16 that
gives the reference's bits, where torch's fused ``F.gelu``/``F.silu``/
``F.softplus`` (one rounding, float32 constants) differ in the last bit.
"""
from __future__ import annotations

import math
import types

import numpy as np
import torch
from torch import nn

from repro_torch.dist import spmd
from repro_torch.dist.context import (DISABLED, NamedSharding, P, ShardCtx,
                                      _axes_tuple, spec_axes)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# a parameter's logical axes, one name (or None) a dim: the reference's
# ``Param.axes``, which ``dist.context.ShardCtx.param_sharding`` maps
Axes = tuple


def const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant rounded to ``like``'s dtype (a 0-dim tensor)."""
    return torch.tensor(c, dtype=like.dtype, device=like.device)


def gelu(x):
    """The tanh approximation of GELU (``jax.nn.gelu``'s default)."""
    inner = const(math.sqrt(2 / math.pi), x) * (
        x + const(0.044715, x) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def softplus(x):
    """log(1 + e^x) as ``jnp.logaddexp(x, 0)`` computes it."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


class ShardedParameter(nn.Module):
    """A weight resident lane by lane (module docstring): ``pieces[i]``
    is lane ``i``'s (row-major over ``sharding.mesh``), of
    ``sharding.shard_shape(shape)``."""

    def __init__(self, pieces: np.ndarray, sharding: NamedSharding, shape,
                 dtype: torch.dtype, axes):
        super().__init__()
        self.pieces = nn.ParameterList(list(pieces.flat))
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.axes = tuple(axes)

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    def numel(self) -> int:
        return math.prod(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def lanes(self, values=None) -> np.ndarray:
        """The pieces (or ``values``, one a lane) as a lanes array."""
        out = np.empty(self.mesh.devices.shape, dtype=object)
        flat = out.reshape(-1)
        for i, t in enumerate(self.pieces if values is None else values):
            flat[i] = t
        return out

    def full(self, device=None) -> torch.Tensor:
        """The whole weight (detached), on ``device`` (the first lane's)."""
        return spmd.unshard(self.lanes([t.detach() for t in self.pieces]),
                            self.spec, self.mesh, device)

    @property
    def grad(self) -> torch.Tensor | None:
        """The whole gradient of the weight, or None before any: each
        piece's, summed over the lanes that hold the same piece (the
        gradient all-reduce ``train_step.stacked_grads`` runs)."""
        if all(t.grad is None for t in self.pieces):
            return None
        g = self.lanes([torch.zeros_like(t) if t.grad is None else t.grad
                        for t in self.pieces])
        used = spec_axes(self.spec)
        rest = tuple(a for a in self.mesh.axis_names if a not in used)
        if rest:
            g = spmd._reduce(g, rest, self.mesh, torch.add)
        return spmd.unshard(g, self.spec, self.mesh)

    def extra_repr(self) -> str:
        return f"{tuple(self.shape)}, {self.dtype}, {self.spec}"


def named_weights(module: nn.Module, prefix: str = ""):
    """(dotted name, weight) of every weight under ``module``, in
    registration order: an ``nn.Parameter``, or a ``ShardedParameter``
    whose pieces are not listed apart."""
    for name, p in module._parameters.items():
        if p is not None:
            yield prefix + name, p
    for name, child in module._modules.items():
        if isinstance(child, ShardedParameter):
            yield prefix + name, child
        elif child is not None:
            yield from named_weights(child, f"{prefix}{name}.")


def whole(t) -> torch.Tensor:
    """A weight's (or a ``spmd.Lanes``') whole value, detached."""
    if isinstance(t, (ShardedParameter, spmd.Lanes)):
        return t.full()
    return t.detach()


@torch.no_grad()
def assign(t, value: torch.Tensor) -> None:
    """Copy the whole ``value`` into a weight or a ``spmd.Lanes`` (each
    lane its part), cast to its dtype."""
    if not isinstance(t, (ShardedParameter, spmd.Lanes)):
        t.copy_(value)
        return
    parts = t.pieces if isinstance(t, ShardedParameter) else t.parts.flat
    for part, v in zip(parts, spmd.shard(value, t.spec, t.mesh).flat):
        part.copy_(v)


class Init:
    """Makes parameters on ``device`` from a generator seeded by ``seed``;
    on an enabled ``ctx``, resident lane by lane (the module docstring),
    ``device`` then being where each weight is made whole (``meta``:
    every piece on ``meta``, nothing allocated)."""

    def __init__(self, device: torch.device, seed: int = 0,
                 ctx: ShardCtx | None = None):
        self.device = device
        self.ctx = ctx or DISABLED
        self.generator = (None if device.type == "meta"
                          else torch.Generator(device).manual_seed(seed))

    def _param(self, shape, dtype, axes, fill):
        axes = tuple(axes)
        if self.ctx.enabled:
            return self._sharded(shape, dtype, axes, fill)
        if self.generator is None:
            p = nn.Parameter(torch.empty(shape, dtype=dtype,
                                         device=self.device))
        else:
            p = nn.Parameter(fill().to(dtype))
        p.axes = axes  # logical axes (dist.context.ShardCtx)
        return p

    def _sharded(self, shape, dtype, axes, fill) -> ShardedParameter:
        sh = self.ctx.param_sharding(types.SimpleNamespace(
            shape=tuple(shape), axes=axes))
        mesh = sh.mesh
        pieces = np.empty(mesh.devices.shape, dtype=object)
        if self.generator is None:
            local = sh.shard_shape(shape)
            for idx in np.ndindex(pieces.shape):
                pieces[idx] = nn.Parameter(torch.empty(
                    local, dtype=dtype, device="meta"))
        else:
            # cut the float32 draw and cast each piece as it is copied
            # (the cast is elementwise: the same values as casting the
            # whole first), so no whole copy in ``dtype`` is ever made
            parts = spmd.own(spmd.shard(fill(), sh.spec, mesh), dtype)
            for idx in np.ndindex(pieces.shape):
                pieces[idx] = nn.Parameter(parts[idx])
        return ShardedParameter(pieces, sh, shape, dtype, axes)

    def dense(self, shape: tuple[int, ...], dtype, axes: Axes,
              scale: float | None = None) -> nn.Parameter:
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
        std = scale if scale is not None else fan_in ** -0.5
        # scaled in place: one float32 buffer at a time (a 384-expert
        # weight is 22 GB in float32)
        return self._param(shape, dtype, axes, lambda: torch.randn(
            shape, generator=self.generator, device=self.device).mul_(std))

    def embed(self, vocab: int, d: int, dtype) -> nn.Parameter:
        return self.dense((vocab, d), dtype, ("vocab", "embed"),
                          scale=d ** -0.5)

    def full(self, shape: tuple[int, ...], value: float, dtype,
             axes: Axes) -> nn.Parameter:
        return self._param(shape, dtype, axes, lambda: torch.full(
            shape, value, device=self.device))

    def tensor(self, make, shape: tuple[int, ...], dtype,
               axes: Axes) -> nn.Parameter:
        """A deterministic parameter: ``make(device)`` builds its value."""
        return self._param(shape, dtype, axes, lambda: make(self.device))


def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


class Norm(nn.Module):
    """RMSNorm in the ``(1 + gamma)`` form (gamma starts at 0), or
    LayerNorm; float32 parameters whatever the model's dtype."""

    def __init__(self, init: Init, norm_type: str, d: int):
        super().__init__()
        if norm_type == "layernorm":
            self.gamma = init.full((d,), 1.0, torch.float32, (None,))
            self.beta = init.full((d,), 0.0, torch.float32, (None,))
        else:
            self.gamma = init.full((d,), 0.0, torch.float32, (None,))


def apply_norm(x, p: Norm, norm_type: str):
    if norm_type == "layernorm":
        return layer_norm(x, p.gamma, p.beta)
    return rms_norm(x, p.gamma)


# --------------------------------------------------------------------------
# a block's weights on its lanes
# --------------------------------------------------------------------------
def dense_spec(spec: P, ctx: ShardCtx) -> P:
    """What a dense layer computes on: ``spec`` with every split over the
    FSDP axes (``weight_rules["embed"]``) gathered, the tensor-parallel
    splits kept."""
    fsdp = set(_axes_tuple(ctx.weight_rules.get("embed")))
    return P(*(None if set(_axes_tuple(e)) & fsdp else e for e in spec))


TP_GATHER = "weights gathered over their tensor-parallel split"


def gather_to(w, target: P, ctx: ShardCtx, *,
              label: str = TP_GATHER) -> np.ndarray:
    """A weight's lanes array laid out by ``target``: a
    ``ShardedParameter``'s pieces with every dim whose split differs
    all-gathered (``spmd.all_gather``, whose backward reduce-scatters the
    gradient into the pieces), a whole parameter split by ``target``
    (views).  A gather over the FSDP axes is the one every FSDP leaf
    runs; any other (a tensor-parallel split the layer needs whole)
    carries ``label`` in the collective counts."""
    mesh = ctx.mesh
    if not isinstance(w, ShardedParameter):
        return spmd.shard(w, target, mesh)
    fsdp = set(_axes_tuple(ctx.weight_rules.get("embed")))
    parts = w.lanes()
    spec = tuple(w.spec) + (None,) * (w.dim() - len(w.spec))
    target = tuple(target) + (None,) * (w.dim() - len(target))
    todo = []
    for dim, (have, want) in enumerate(zip(spec, target)):
        if _axes_tuple(have) == _axes_tuple(want):
            continue
        if want is not None:
            raise ValueError(f"gather_to: dim {dim} of {w} is split over "
                             f"{have}, wanted over {want}")
        todo.append((not set(_axes_tuple(have)) <= fsdp, dim, have))
    # the FSDP gathers first: their result is what every FSDP leaf moves
    for tp_split, dim, have in sorted(todo):
        parts = spmd.all_gather(parts, have, dim, mesh,
                                label=label if tp_split else None)
    return parts


def spec_of(w, ctx: ShardCtx) -> P:
    """A weight's spec: its pieces' (sharded), else the rules'."""
    if isinstance(w, ShardedParameter):
        return w.spec
    return ctx.param_sharding(w).spec


def lane_weights(module: nn.Module, ctx: ShardCtx, target=None, *,
                 names=None, label: str = TP_GATHER) -> np.ndarray:
    """A lanes array of ``SimpleNamespace``s, one a lane, holding
    ``module``'s own weights (not its submodules') as that lane computes
    on them: ``target(name, spec) -> spec`` (default ``dense_spec``)."""
    target = target or (lambda name, spec: dense_spec(spec, ctx))
    weights = {name: w for name, w in named_weights(module)
               if "." not in name and (names is None or name in names)}
    lanes = {name: gather_to(w, target(name, spec_of(w, ctx)), ctx,
                             label=label)
             for name, w in weights.items()}
    out = np.empty(ctx.mesh.devices.shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = types.SimpleNamespace(
            **{name: parts[idx] for name, parts in lanes.items()})
    return out


def split_over_model(spec: P, dim: int) -> bool:
    """Whether ``spec`` splits ``dim`` over the 'model' axis."""
    return dim < len(spec) and "model" in _axes_tuple(spec[dim])


def model_split(w, ctx: ShardCtx, dim: int) -> bool:
    """Whether a layer computes on its lane's 'model' slice of ``w``'s
    ``dim`` (the rules split it there)."""
    return split_over_model(dense_spec(spec_of(w, ctx), ctx), dim)


# --------------------------------------------------------------------------
# the recurrent blocks' activations and states on lanes
# --------------------------------------------------------------------------
# the label of the 'model' collectives Mamba, mLSTM and sLSTM run on
# activations and states (never on a weight): counted apart from the
# FSDP rule's
RECURRENT = "recurrent activations and states regrouped over 'model'"


def model_index(mesh) -> np.ndarray:
    """Each lane's index along 'model' (0 on a mesh without it)."""
    if "model" not in mesh.axis_names:
        return np.zeros(mesh.devices.shape, dtype=np.int64)
    return spmd.axis_index(mesh, "model")


def model_lanes(mesh) -> int:
    return mesh.shape.get("model", 1)


def own_slice(t: torch.Tensor, dim: int, m, n: int) -> torch.Tensor:
    """Lane ``m``'s slice of ``t``'s ``dim`` cut ``n`` ways."""
    size = t.shape[dim] // n
    return t.narrow(dim, int(m) * size, size)


def regroup_halves(y: np.ndarray, weight_split: bool, own: bool,
                   ctx: ShardCtx) -> tuple[np.ndarray, np.ndarray]:
    """The output of ``x @ w`` for a ``w`` whose columns are two halves
    ``[a | b]`` side by side (Mamba's ``in_proj``, the xLSTM ``up``s), on
    lanes: each lane holds its block of the columns when ``w`` is split
    over 'model' (``weight_split``), else all of them.  -> (a, b), each
    lane's own 1/tp of each half's columns (``own``), else the whole
    halves.  With two 'model' lanes each holds one half, and one
    ``all_to_all`` hands each lane its columns of both; with more, the
    halves span several lanes unevenly, and an ``all_gather`` makes them
    whole before the lane takes its columns."""
    mesh = ctx.mesh
    tp = model_lanes(mesh)
    last = y.flat[0].dim() - 1
    if weight_split and own and tp == 2:
        y = spmd.all_to_all(y, "model", last, last, mesh, label=RECURRENT)
        return spmd.lanewise(lambda t: tuple(t.chunk(2, dim=-1)), y)
    if weight_split:
        y = spmd.all_gather(y, "model", last, mesh, label=RECURRENT)

    def halves(t, m):
        a, b = t.chunk(2, dim=-1)
        if not own:
            return a, b
        return own_slice(a, -1, m, tp), own_slice(b, -1, m, tp)
    return spmd.lanewise(halves, y, model_index(mesh))


def _model_dim(spec: P) -> int | None:
    return next((d for d, e in enumerate(spec)
                 if "model" in _axes_tuple(e)), None)


def state_in(state: spmd.Lanes, dim: int, own: bool,
             ctx: ShardCtx) -> np.ndarray:
    """A recurrent state's parts as its layer computes on them: each
    lane's own slice of ``dim`` (its channels or heads) when ``own``,
    else whole over 'model'; from the cache's layout (``cache_spec``),
    which may split another dim over 'model' (Mamba's conv state, its
    time axis) or none."""
    mesh = ctx.mesh
    have, want = _model_dim(state.spec), (dim if own else None)
    parts = state.parts
    if have == want:
        return parts
    if have is None:
        tp = model_lanes(mesh)
        return spmd.lanewise(lambda t, m: own_slice(t, want, m, tp), parts,
                             model_index(mesh))
    if want is None:
        return spmd.all_gather(parts, "model", have, mesh, label=RECURRENT)
    return spmd.all_to_all(parts, "model", want, have, mesh,
                           label=RECURRENT)


def state_out(state: spmd.Lanes, new: np.ndarray, dim: int, own: bool,
              ctx: ShardCtx) -> None:
    """``state_in``'s inverse: the new state, laid out as the layer
    computed it, written into the cache's parts in place."""
    mesh = ctx.mesh
    have, want = _model_dim(state.spec), (dim if own else None)
    if have != want:
        if want is None:
            tp = model_lanes(mesh)
            new = spmd.lanewise(lambda t, m: own_slice(t, have, m, tp), new,
                                model_index(mesh))
        elif have is None:
            new = spmd.all_gather(new, "model", want, mesh, label=RECURRENT)
        else:
            new = spmd.all_to_all(new, "model", have, want, mesh,
                                  label=RECURRENT)
    spmd.lanewise(lambda part, t: part.copy_(t), state.parts, new)
