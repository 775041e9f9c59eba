"""Engine state across the two packages.

A graph system has no weights: what a run carries is the preprocessed store
(on disk, read by both packages through the same codec) and the engine's
``(values, active, iteration)`` state.  The reference package keeps that
state as numpy arrays of ``n`` rows — ``[n]`` for one frontier, ``[n, K]``
for a batch of K (in checkpoints and ``RunResult``); this package keeps
``values`` on the device padded to ``n_pad`` rows, so that every shard's
``[start, start + R)`` slice is in bounds.  These two
functions convert between the forms; checkpoints themselves use the same npz
format in both packages (``core/engine.py``), so a run checkpointed by one
resumes in the other.
"""
from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(values: np.ndarray, active: np.ndarray,
                     device: torch.device | str,
                     n_pad: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """numpy ``values`` / ``active``, both ``[n]`` or both ``[n, K]`` ->
    device tensors ``values [n_pad(, K)]`` float32 (rows past ``n`` are 0)
    and ``active [n(, K)]`` bool."""
    values = np.asarray(values, dtype=np.float32)
    active = np.asarray(active, dtype=bool)
    n = values.shape[0]
    if values.ndim not in (1, 2) or active.shape != values.shape:
        raise ValueError(f"values and active must both be [n] or both "
                         f"[n, K], got {values.shape} / {active.shape}")
    n_pad = n if n_pad is None else int(n_pad)
    if n_pad < n:
        raise ValueError(f"n_pad={n_pad} is smaller than n={n}")
    padded = np.zeros((n_pad,) + values.shape[1:], dtype=np.float32)
    padded[:n] = values
    return (torch.from_numpy(padded).to(device),
            torch.from_numpy(active.copy()).to(device))


def state_to_numpy(values: torch.Tensor, active: torch.Tensor | np.ndarray,
                   n: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`state_from_numpy`: the first ``n`` rows (of
    ``[n_pad]`` or ``[n_pad, K]``) as numpy ``float32`` values and ``bool``
    active mask."""
    if isinstance(active, torch.Tensor):
        active = active.detach().cpu().numpy()
    return (values[:n].detach().cpu().numpy().astype(np.float32, copy=True),
            np.asarray(active, dtype=bool)[:n].copy())
