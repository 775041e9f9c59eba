"""Carry the reference package's weights into the port's ``Model``.

``values`` is the reference's parameter tree with the annotations peeled
off (the first tree ``repro.models.nn.split_params`` returns), as nested
dicts of numpy arrays (or anything ``np.asarray`` takes).  The reference
stacks each layer group with a leading ``repeat`` axis; layer ``r`` of
group ``gi``, block ``b{i}`` of a unit of length ``u``, is the port's layer
``offset(gi) + r * u + i`` (the encoder's groups the same way).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model, layer_groups


def to_tensor(a) -> torch.Tensor:
    """numpy -> torch, bfloat16 included (numpy has no bfloat16: the
    reference hands out ``ml_dtypes.bfloat16`` arrays, which torch refuses,
    so their bits travel as uint16)."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")  # torch refuses to alias read-only memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + ".")
        else:
            yield path, val


def reference_state(model: Model, values: dict) -> dict[str, torch.Tensor]:
    """The reference's tree -> the port's state-dict keys and tensors."""
    cfg = model.cfg
    out: dict[str, torch.Tensor] = {}
    stacked = {}  # reference group -> (unit, repeat, port stack, offset)
    for stack, prefix, encoder in (("layers", "group", False),
                                   ("enc_layers", "enc_group", True)):
        if encoder and not cfg.is_encdec:
            continue
        offset = 0
        for gi, (unit, repeat) in enumerate(layer_groups(cfg,
                                                         encoder=encoder)):
            stacked[f"{prefix}{gi}"] = (unit, repeat, stack, offset)
            offset += len(unit) * repeat
    for key, sub in values.items():
        if key not in stacked:
            for path, val in (_leaves(sub, key + ".") if isinstance(sub, dict)
                              else [(key, sub)]):
                out[path] = to_tensor(val)
            continue
        unit, repeat, stack, offset = stacked[key]
        for path, val in _leaves(sub):
            block, rest = path.split(".", 1)   # "b{i}", the leaf inside it
            i = int(block[1:])
            arr = np.asarray(val)
            if arr.shape[0] != repeat or i >= len(unit):
                raise ValueError(f"{key}.{path}: shape {arr.shape} does not "
                                 f"fit {repeat} repeats of a {len(unit)}-"
                                 "block unit")
            for r in range(repeat):
                layer = offset + r * len(unit) + i
                out[f"{stack}.{layer}.{rest}"] = to_tensor(arr[r])
    return out


def load_reference_params(model: Model, values: dict) -> Model:
    """Copy the reference's weights into ``model`` (in place; returned).
    A missing or extra leaf, or a shape or dtype that differs, raises
    naming its path."""
    state = reference_state(model, values)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"reference weights do not fit {model.cfg.name}: "
                         f"missing {missing}, extra {extra}")
    for key, val in state.items():
        if val.shape != own[key].shape or val.dtype != own[key].dtype:
            raise ValueError(f"{key}: reference {tuple(val.shape)} "
                             f"{val.dtype}, port {tuple(own[key].shape)} "
                             f"{own[key].dtype}")
    with torch.no_grad():
        for key, param in own.items():
            param.copy_(state[key])
    return model
