"""Parameter initialisation and the numerics shared by every block.

Weights live in ``nn.Module``s.  ``Init`` makes each ``nn.Parameter``
directly on its device, filled from one explicit ``torch.Generator`` (the
role of the reference's ``KeyGen``): the same shapes, dtypes and
distributions as the reference's initialisers, not the same values.  Each
parameter carries the reference's logical axes as ``param.axes``.  On
the ``meta`` device it allocates nothing, which is how ``param_count``
counts a full-size model.

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

import torch
from torch import nn

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


class Init:
    """Makes parameters on ``device`` from a generator seeded by ``seed``."""

    def __init__(self, device: torch.device, seed: int = 0):
        self.device = device
        self.generator = (None if device.type == "meta"
                          else torch.Generator(device).manual_seed(seed))

    def _param(self, shape, dtype, axes, fill) -> nn.Parameter:
        if self.generator is None:
            p = nn.Parameter(torch.empty(shape, dtype=dtype,
                                         device=self.device))
        else:
            p = nn.Parameter(fill().to(dtype))
        p.axes = tuple(axes)  # logical axes (dist.context.ShardCtx)
        return p

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
