"""Meshes of the LLM stack: ``make_mesh`` for runs and tests,
``make_production_mesh`` for rules and shapes only.  Functions, not
module-level constants, so importing this module touches no device."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.dist.context import DeviceSpec, Mesh, make_data_devices


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices: DeviceSpec | Sequence[DeviceSpec] = "cuda") -> Mesh:
    """A mesh of ``prod(shape)`` lanes, laid out row-major.

    ``devices`` follows ``make_data_devices``: ``"cuda"`` wants one GPU a
    lane and raises with fewer; an explicit list names each lane's device
    and may repeat one (``["cuda:0"] * 4`` puts four lanes on one card);
    ``"cpu"`` gives CPU lanes.
    """
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    lanes = make_data_devices(math.prod(shape), devices)
    grid = np.empty(len(lanes), dtype=object)
    grid[:] = lanes
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout, 16 x 16 (data, model) or
    2 x 16 x 16 (pod, data, model), of ``meta`` lanes: for the sharding
    rules and the shapes they give, never for running."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(math.prod(shape), dtype=object)
    grid[:] = [torch.device("meta")] * grid.size
    return Mesh(grid.reshape(shape), axes)
