"""Device lanes: the port's counterpart of a 1-D ``data`` mesh.

The reference lays its multi-device graph engines over a one-axis jax mesh
(``make_data_mesh``).  Here a mesh is a plain list of ``torch.device``, one
entry per lane: lane ``d`` owns the destination intervals the engine assigns
to device ``d`` of the mesh.  A list may name one device more than once,
so D lanes can share one card (each lane keeps its own CUDA stream) or the
CPU; nothing maps D lanes onto fewer GPUs unless the list says so.
"""
from __future__ import annotations

from typing import Sequence

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
