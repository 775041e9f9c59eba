"""Fault-tolerant checkpointing of a ``TrainState``, in the reference's
file format.

  * atomic publish — write to a temp name, fsync, os.replace; a crash
    mid-save never corrupts the latest checkpoint;
  * keep-N GC, and ``latest.json`` naming the newest step;
  * async save — the host copy is taken before ``save`` returns, the
    serialization runs on one worker thread so the train loop keeps
    stepping (emergency saves on SIGTERM flush synchronously, after a
    pending save); ``close`` finishes it and stops the thread;
  * restore copies into an existing state's tensors, on whatever device
    its model lives; with ``shardings`` (elastic re-sharding) it also
    splits each full array over the lanes of its mesh by its spec, which
    need not be the mesh it was saved from.

The npz holds what the reference's ``CheckpointManager`` writes for the
same state: its leaf names, its stacked shapes, its dtypes (bf16 stored
as float32, exact).  A name is the reference's pytree path with
``[]'.`` dropped, as ``jax.tree_util`` spells it for a ``TrainState``
(children params, opt, ef, step, each a ``<flat index i>``) of
``Param``s (one child, ``<flat index 0>``):
``<flat index 0>/group0/b0/attn/wq/<flat index 0>``,
``<flat index 1>/ema/embed/m/<flat index 0>``, ``<flat index 1>/step``,
``<flat index 2>/<leaf path>/<flat index 0>`` and ``<flat index 3>``.
So a checkpoint written by either package restores in the other.  A
plain nested dict of arrays or tensors is stored under its keys joined
by ``/``.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist import spmd
from repro_torch.models.convert import to_numpy, to_tensor
from repro_torch.train.train_step import TrainState


def _index(i: int) -> str:
    return f"<flat index {i}>"


def _entries(state) -> dict[str, tuple[tuple, bool]]:
    """name -> (the tensors or arrays it covers, stacked?)."""
    if not isinstance(state, TrainState):
        out = {}

        def walk(tree, prefix):
            for key, val in tree.items():
                if isinstance(val, dict):
                    walk(val, f"{prefix}{key}/")
                else:
                    out[f"{prefix}{key}"] = ((val,), False)
        walk(state, "")
        return out
    param, opt, ef, step = (_index(i) for i in range(4))
    leaf_end = _index(0)
    out = {f"{param}/{leaf.path}/{leaf_end}": (leaf.tensors, leaf.stacked)
           for leaf in state.params}
    out[f"{opt}/step"] = ((state.opt["step"],), False)
    for path, st in state.opt["ema"].items():
        for k, t in st.items():
            out[f"{opt}/ema/{path}/{k}/{leaf_end}"] = ((t,), False)
    for path, t in (state.ef or {}).items():
        out[f"{ef}/{path}/{leaf_end}"] = ((t,), False)
    out[step] = ((state.step,), False)
    return out


def _flatten_named(state) -> dict[str, np.ndarray]:
    """Host copies of every leaf (taken now: the tensors keep changing)."""
    flat = {}
    for name, (parts, stacked) in _entries(state).items():
        if isinstance(parts[0], torch.Tensor):
            arr = to_numpy(torch.stack([t.detach() for t in parts])
                           if stacked else parts[0])
        else:
            arr = np.array(parts[0])
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
        flat[name] = arr
    return flat


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None

    # ---- save -----------------------------------------------------------
    def save(self, step: int, state, extra: dict | None = None, *,
             sync: bool = False):
        # pull to host synchronously (cheap vs serialization), serialize
        # async; a pending save finishes first, so two never write
        # latest.json at once
        flat = _flatten_named(state)
        self.wait()
        if sync:
            self._write(step, flat, extra or {})
        else:
            self._pending = self._pool.submit(self._write, step, flat,
                                              extra or {})

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        """Finish a pending save and stop the worker thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = self.dir / f".tmp_step_{step:08d}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.dir / f"step_{step:08d}.npz")
        meta_tmp = self.dir / "latest.json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump({"step": step, **extra}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(meta_tmp, self.dir / "latest.json")
        self._gc()

    def _gc(self):
        cks = sorted(self.dir.glob("step_*.npz"))
        for old in cks[: -self.keep]:
            old.unlink()

    # ---- restore ---------------------------------------------------------
    def latest_step(self) -> int | None:
        meta = self.dir / "latest.json"
        if not meta.exists():
            return None
        with open(meta) as f:
            return int(json.load(f)["step"])

    @torch.no_grad()
    def restore(self, state, step: int | None = None, shardings=None):
        """Copy checkpoint ``step`` (default: the latest) into ``state``'s
        tensors in place, casting to their dtypes; -> (state, step), or
        None when there is no checkpoint.  A leaf missing from the file
        raises ``KeyError``; leaves the state lacks are ignored.

        ``shardings``: for a nested dict ``state``, a tree of the same
        keys whose leaves are ``dist.context.NamedSharding`` (or None).
        Each such leaf comes back split over its mesh's lanes
        (``dist.spmd.shard``: a lanes array) instead of whole: the
        elastic re-sharding of the reference's ``restore``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        if shardings is not None and isinstance(state, TrainState):
            raise TypeError("shardings re-split a nested dict state; a "
                            "TrainState lives on its model's device")
        path = self.dir / f"step_{step:08d}.npz"
        with np.load(path) as z:
            for name, (parts, stacked) in _entries(state).items():
                arr = to_tensor(z[name])
                for t, v in zip(parts, arr.unbind(0) if stacked else (arr,)):
                    if v.shape != t.shape:
                        raise ValueError(f"{name}: checkpoint "
                                         f"{tuple(v.shape)}, state "
                                         f"{tuple(t.shape)}")
                    t.copy_(v)
        if shardings is None:
            return state, step
        return _split(state, shardings), step


def _split(tree: dict, shardings: dict) -> dict:
    """``tree``'s leaves split by the same keys' NamedShardings."""
    out = {}
    for key, val in tree.items():
        sh = shardings.get(key)
        if isinstance(val, dict):
            out[key] = _split(val, sh or {})
        elif sh is None:
            out[key] = val
        else:
            out[key] = spmd.shard(val, sh.spec, sh.mesh)
    return out
