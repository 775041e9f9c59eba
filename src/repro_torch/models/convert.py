"""Carry weights and training state between the reference's layout and
the port's ``Model``.

``values`` is the reference's parameter tree with the annotations peeled
off (the first tree ``repro.models.nn.split_params`` returns), as nested
dicts of numpy arrays (or anything ``np.asarray`` takes).  The reference
stacks each layer group with a leading ``repeat`` axis; layer ``r`` of
group ``gi``, block ``b{i}`` of a unit of length ``u``, is the port's layer
``offset(gi) + r * u + i`` (the encoder's groups the same way).

``reference_leaves`` turns that rule around: one ``Leaf`` for each leaf
of the reference's tree, holding the port's parameters that make it up.
The optimizer, the error feedback and the checkpoints work leaf by leaf,
so a statistic the reference takes over a stacked leaf spans every layer
of its group here too.  ``to_reference`` and ``state_to_reference``/
``state_from_reference`` convert the parameters and the optimizer and
error-feedback state (``m``, ``v``, ``master``, ``vr``, ``vc``, ``ef``)
to and from the reference's trees of numpy arrays.
"""
from __future__ import annotations

import dataclasses

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


def _stacked_groups(model: Model) -> dict[str, tuple]:
    """reference group ("group0", "enc_group1") -> (unit, repeat, port
    stack, offset of its first layer there)."""
    cfg = model.cfg
    stacked = {}
    for stack, prefix, encoder in (("layers", "group", False),
                                   ("enc_layers", "enc_group", True)):
        if encoder and not cfg.is_encdec:
            continue
        offset = 0
        for gi, (unit, repeat) in enumerate(layer_groups(cfg,
                                                         encoder=encoder)):
            stacked[f"{prefix}{gi}"] = (unit, repeat, stack, offset)
            offset += len(unit) * repeat
    return stacked


def reference_state(model: Model, values: dict) -> dict[str, torch.Tensor]:
    """The reference's tree -> the port's state-dict keys and tensors."""
    out: dict[str, torch.Tensor] = {}
    stacked = _stacked_groups(model)
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


# --------------------------------------------------------------------------
# the reference's leaves over the port's parameters
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Leaf:
    """One leaf of the reference's parameter tree.

    ``path`` is its tree path ("group0/b0/attn/wq"); ``tensors`` are the
    port's parameters that make it up, in ``r`` order; ``stacked``: the
    reference stacks them on a leading [repeat] axis (a layer group's
    leaf), else it is the one tensor (``embed``, ``norm_f``, ...).
    """
    path: str
    tensors: tuple[torch.Tensor, ...]
    stacked: bool

    @property
    def shape(self) -> tuple[int, ...]:
        one = tuple(self.tensors[0].shape)
        return (len(self.tensors),) + one if self.stacked else one

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype

    @property
    def axes(self) -> tuple:
        """The reference's logical axes: a stacked leaf's first is
        "layers" (``repro.models.nn.add_leading_axis``)."""
        one = tuple(self.tensors[0].axes)
        return ("layers",) + one if self.stacked else one

    def stack(self, parts=None) -> torch.Tensor:
        """``parts`` (default: the parameters' values), one per tensor, as
        the reference's array of this leaf."""
        parts = [t.detach() for t in self.tensors] if parts is None else parts
        return torch.stack(parts) if self.stacked else parts[0]

    @torch.no_grad()
    def write(self, value: torch.Tensor) -> None:
        """Copy the reference-shaped ``value`` into the parameters, casting
        to their dtype."""
        for t, v in zip(self.tensors,
                        value.unbind(0) if self.stacked else (value,)):
            t.copy_(v)


def reference_leaves(model: Model) -> list[Leaf]:
    """One ``Leaf`` for each leaf of the reference's parameter tree, in
    the order ``jax.tree_util`` flattens it (dict keys sorted at every
    level), by ``reference_state``'s index rule."""
    params = dict(model.named_parameters())
    stacked = _stacked_groups(model)
    out = []
    for name, t in params.items():
        if not name.startswith(("layers.", "enc_layers.")):
            out.append(Leaf(name.replace(".", "/"), (t,), False))
    for key, (unit, repeat, stack, offset) in stacked.items():
        for i in range(len(unit)):
            prefix = f"{stack}.{offset + i}."
            for name in params:
                if not name.startswith(prefix):
                    continue
                rest = name[len(prefix):]
                out.append(Leaf(
                    f"{key}/b{i}/{rest.replace('.', '/')}",
                    tuple(params[f"{stack}.{offset + r * len(unit) + i}."
                                 f"{rest}"] for r in range(repeat)),
                    True))
    return sorted(out, key=lambda leaf: leaf.path.split("/"))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 comes out as float32 (exact), as the
    reference's checkpoints store it (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _nest(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def _get(tree: dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def to_reference(model: Model) -> dict:
    """The inverse of ``reference_state``: the port's parameters as the
    reference's stacked tree of numpy arrays (bfloat16 as float32)."""
    return _nest({leaf.path: to_numpy(leaf.stack())
                  for leaf in reference_leaves(model)})


def state_to_reference(opt: dict, ef: dict | None = None) -> tuple:
    """The port's optimizer and error-feedback state (already in the
    reference's stacked layout, keyed by leaf path) -> the reference's
    ``(opt, ef)`` trees of numpy arrays (``ef`` None without one)."""
    ema = _nest({f"{path}/{k}": to_numpy(t)
                 for path, st in opt["ema"].items() for k, t in st.items()})
    ref_opt = {"step": to_numpy(opt["step"]), "ema": ema}
    ref_ef = (None if ef is None else
              _nest({path: to_numpy(t) for path, t in ef.items()}))
    return ref_opt, ref_ef


@torch.no_grad()
def state_from_reference(opt: dict, ef: dict | None, ref_opt: dict,
                         ref_ef: dict | None = None) -> None:
    """Copy the reference's ``(opt, ef)`` trees into the port's state in
    place (onto its tensors' devices and dtypes); a missing leaf raises
    ``KeyError``."""
    opt["step"].copy_(to_tensor(ref_opt["step"]))
    for path, st in opt["ema"].items():
        for k, t in st.items():
            t.copy_(to_tensor(_get(ref_opt["ema"], f"{path}/{k}")))
    for path, t in (ef or {}).items():
        t.copy_(to_tensor(_get(ref_ef, path)))
