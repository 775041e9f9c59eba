"""Device lanes and meshes: the port's counterpart of jax's meshes.

The graph engines: the reference lays them over a one-axis jax mesh
(``make_data_mesh``).  Here that mesh is a plain list of ``torch.device``,
one entry per lane: lane ``d`` owns the destination intervals the engine
assigns to device ``d`` of the mesh.  A list may name one device more than
once, so D lanes can share one card (each lane keeps its own CUDA stream)
or the CPU; nothing maps D lanes onto fewer GPUs unless the list says so.

The LLM stack: a ``Mesh`` is a named grid of such lanes in one process,
like jax's single-controller mesh, and ``ShardCtx``/``make_rules`` are the
reference's layout policy, line for line.  A model built on an enabled
context holds each weight as one piece a lane, cut by ``param_sharding``
(``models.nn.ShardedParameter``), and runs as the reference's SPMD
program lane by lane over ``dist.spmd``'s explicit collectives: what
GSPMD derives from the shardings (the FSDP all-gathers, the tensor
parallel ``psum``s) and what the reference writes with
``jax.shard_map`` alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device

DeviceSpec = torch.device | str


def make_data_devices(num_devices: int,
                      device: DeviceSpec | Sequence[DeviceSpec] = "cuda"
                      ) -> list[torch.device]:
    """The ``num_devices`` lanes of a multi-device engine.

    * an explicit list (or tuple) of devices: taken as it is, one lane per
      entry; it must hold ``num_devices`` entries and may repeat a device
      (``["cpu"] * D``, ``[torch.device("cuda:0")] * D``);
    * ``"cuda"`` (no index): ``cuda:0 … cuda:D-1``; raises when fewer
      GPUs are visible (pass an explicit list to put lanes on fewer cards);
    * ``"cpu"``: D lanes on the CPU, which is one device however many
      lanes share it;
    * a device with an index (``"cuda:1"``): one lane only.

    Every CUDA entry must be usable: nothing falls back to the CPU.
    """
    if isinstance(num_devices, bool) or not isinstance(num_devices, int) \
            or num_devices < 1:
        raise ValueError(f"num_devices must be an int >= 1, got "
                         f"{num_devices!r}")
    if isinstance(device, (list, tuple)):
        if len(device) != num_devices:
            raise ValueError(f"num_devices={num_devices} but the device list "
                             f"names {len(device)} lanes: {list(device)}")
        return [resolve_device(d) for d in device]
    dev = torch.device(device)
    if num_devices == 1:
        return [resolve_device(dev)]
    if dev.type == "cpu":
        return [dev] * num_devices
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_devices > visible:
            raise RuntimeError(
                f"num_devices={num_devices} needs {num_devices} CUDA devices "
                f"but {visible} are visible; to run {num_devices} lanes on "
                f"fewer cards pass an explicit device list, e.g. "
                f"device=['cuda:0'] * {num_devices}")
        return [torch.device("cuda", i) for i in range(num_devices)]
    raise ValueError(
        f"device {str(dev)!r} names one device but num_devices="
        f"{num_devices}; pass a list of {num_devices} devices (it may repeat "
        f"{str(dev)!r})")


# ---------------------------------------------------------------------------
# the mesh of the LLM stack
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them (split
    over their product, the first major), or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A named grid of ``torch.device`` lanes, in one process.

    ``devices`` is a numpy object array whose dims are the ``axis_names``;
    a device may repeat (four lanes on ``cuda:0``, or on the CPU), and
    ``torch.device("meta")`` lanes make an abstract mesh for rules and
    shapes only.  ``shape`` maps each axis name to its size, in order.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} distinct axis names, got "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def on_meta(self) -> "Mesh":
        """The same grid of lanes, all ``meta``."""
        grid = np.empty(self.devices.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device("meta")
        return Mesh(grid, self.axis_names)

    @property
    def first_device(self) -> torch.device:
        """The first lane's device: where a weight is made whole before
        it is cut, and where whole values are assembled."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


class DuplicateSpecError(ValueError):
    """A spec maps one mesh axis to more than one dim (jax's error of the
    same name)."""


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh.  As jax's, it refuses a spec that names an
    axis the mesh lacks (``ValueError``), or one axis for more than one
    dim (``DuplicateSpecError``)."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        used = [a for entry in self.spec for a in _axes_tuple(entry)]
        unknown = set(used) - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"spec {self.spec} over mesh axes "
                             f"{self.mesh.axis_names}: unknown axes "
                             f"{sorted(unknown)}")
        if len(used) != len(set(used)):
            raise DuplicateSpecError(f"spec {self.spec} over mesh axes "
                                     f"{self.mesh.axis_names}: an axis maps "
                                     f"more than one dim")

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """One lane's shape of a ``global_shape`` array under this spec,
        as jax's ``NamedSharding.shard_shape``: a dim split over axes of
        total size n is divided by n, and a dim that n does not divide
        raises ``ValueError``."""
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {global_shape} has dims")
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in _axes_tuple(entry))
            if out[i] % n:
                raise ValueError(
                    f"sharding {self.spec} over mesh {self.mesh.shape} "
                    f"splits dim {i} of {global_shape} {n} ways, which "
                    f"does not divide it")
            out[i] //= n
        return tuple(out)


# a rule value: one mesh axis name, a tuple of them (e.g. ('pod', 'data')),
# or None for replicated
Rule = Any


def _axes_tuple(rule: Rule) -> tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis a spec splits over, in its order."""
    return tuple(a for entry in spec for a in _axes_tuple(entry))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The logical-axis sharding context: the one place mesh layout
    policy lives.  Models annotate tensors with *logical* axes ('batch',
    'ffn', 'experts', ...) and ask the context to map them; ``make_rules``
    builds the mapping for a mesh and an arch.  ``ShardCtx(None, {}, {})``
    is the disabled one-device context: ``constrain`` is the identity and
    every ``axis_size`` is 1."""
    mesh: Mesh | None
    rules: Mapping[str, Rule]         # activation logical axis -> mesh axes
    weight_rules: Mapping[str, Rule]  # parameter logical axis -> mesh axes
    ep_mode: str = "a2a"              # 'a2a' | 'replicated' (models/moe.py)

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    # -- sizes -----------------------------------------------------------
    def axis_size(self, logical: str) -> int:
        """Total lane count the logical axis is split over (1 if
        replicated)."""
        if not self.enabled:
            return 1
        return math.prod(self.mesh.shape[a]
                         for a in _axes_tuple(self.rules.get(logical)))

    # -- spec construction ----------------------------------------------
    def _spec(self, logical_axes, rules: Mapping[str, Rule],
              shape=None) -> PartitionSpec:
        """Map logical dim names to a PartitionSpec.

        A mesh axis may appear at most once in a spec; when ``shape`` is
        known, a dim that the mesh axis does not divide evenly stays
        replicated (reduced test configs have tiny dims).
        """
        used: set[str] = set()
        out: list[Rule] = []
        for i, name in enumerate(logical_axes):
            rule = rules.get(name) if name is not None else None
            axes = _axes_tuple(rule)
            if axes and not (used & set(axes)):
                size = math.prod(self.mesh.shape[a] for a in axes)
                if shape is None or (size and shape[i] % size == 0):
                    used.update(axes)
                    out.append(rule if isinstance(rule, str) else tuple(axes))
                    continue
            out.append(None)
        return P(*out)

    def logical_sharding(self, logical_axes) -> NamedSharding | None:
        """The sharding of an activation or input (None if disabled)."""
        if not self.enabled:
            return None
        return NamedSharding(self.mesh, self._spec(logical_axes, self.rules))

    def param_sharding(self, param) -> NamedSharding | None:
        """The sharding of a weight by its logical ``axes`` (a parameter
        made by ``models.nn.Init``, or a ``models.convert.Leaf``)."""
        if not self.enabled:
            return None
        axes = tuple(getattr(param, "axes", None) or ())
        shape = tuple(param.shape)
        if len(axes) != len(shape):
            axes = axes + (None,) * (len(shape) - len(axes))
        return NamedSharding(
            self.mesh, self._spec(axes[: len(shape)], self.weight_rules,
                                  shape))

    def constrain(self, x, logical_axes):
        """The reference places ``x`` by its logical axes here and never
        changes its value.  The port's layers on a mesh hold each lane's
        part of an activation already (``models.model``'s lanes program),
        so a whole tensor that reaches this (a layer called whole, as the
        layer tests call it) is returned as it is."""
        del logical_axes
        return x


DISABLED = ShardCtx(None, {}, {})


def make_rules(mesh: Mesh | None, cfg, *, long_context: bool = False,
               ep_mode: str = "a2a", serve_fsdp: bool = True) -> ShardCtx:
    """Derive the logical->mesh mapping for one (mesh, arch, variant) cell.

    * activation rules (``ctx.rules``): batch over the data axes (and
      'pod' when present), tensor-parallel dims over 'model', the KV-cache
      sequence dim over 'data' only for long-context serving;
    * weight rules (``ctx.weight_rules``): TP dims over 'model', plus FSDP
      of the embed dim over the data axes when ``serve_fsdp`` (always on
      for training);
    * the serve 2-D MoE layout (``serve_fsdp=False``) puts the experts on
      the token ('data') axis with second-level TP on the expert ff dim
      (``models/moe.py``).

    ``mesh=None`` yields the disabled one-device context."""
    if mesh is None:
        return ShardCtx(None, {}, {}, ep_mode=ep_mode)
    names = tuple(mesh.axis_names)
    model = "model" if "model" in names else None
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    batch: Rule = (data_axes if len(data_axes) > 1
                   else (data_axes[0] if data_axes else None))
    data = "data" if "data" in names else None

    rules: dict[str, Rule] = {
        "batch": batch,
        "seq": None,                 # activations keep seq replicated;
        "kv_seq": (data if long_context else None),  # ...KV caches may not
        "embed": None,
        "ffn": model,
        "swiglu": model,
        "geglu": model,
        "q_heads": model,
        "kv_heads": None,            # few KV heads: replicate, repeat for TP
        "head_dim": None,
        "lstm_heads": model,
        "mamba_inner": model,
        "vocab": model,
        "experts": model,
    }

    weight_rules: dict[str, Rule] = {
        "layers": None,
        # FSDP over the data axes: on for training and the default serve
        # layout, off for the 2-D expert serve variant
        "embed": (batch if serve_fsdp else None),
        "ffn": model,
        "swiglu": model,
        "geglu": model,
        "q_heads": model,
        "kv_heads": None,
        "head_dim": None,
        "lstm_heads": model,
        "mamba_inner": model,
        "vocab": model,
        "experts": model,
        "expert_ff": None,
    }
    if not serve_fsdp and data is not None and model is not None:
        # serve 2-D MoE layout: experts over the token axis, second-level TP
        # on the expert ff dim (models/moe.py routes around the a2a for it)
        rules["experts"] = data
        weight_rules["experts"] = data
        weight_rules["expert_ff"] = model

    return ShardCtx(mesh, rules, weight_rules, ep_mode=ep_mode)
