"""The port's checkpoints and its training CLI under faults, on the CPU,
held against the reference package.

Checkpoints: atomic publish, keep-N GC, async save, and a resumed run equal
to an uninterrupted one (the reference's tests/test_train.py, on the
port); and compatibility both ways: for the same state the port writes
the reference's key set, shapes and dtypes, a reference checkpoint
restores in the port and training goes on as the reference's does, and a
port checkpoint restores with the reference's ``CheckpointManager``.
The reference runs in this process in float32 (bf16 only where it is
stored, not computed).  Tolerances: a resumed run equals the
uninterrupted one to ``rtol = 1e-5`` (the reference's own); the port's
continuation of a reference checkpoint equals the reference's to
``rtol = 1e-4`` (float32, ``tests/test_torch_train.py``); stored values
bitwise.

The CLI: ``python -m repro_torch.launch.train --device cpu`` killed with
SIGTERM after its first checkpoint and resumed, as the reference's
``tests/test_fault_tolerance.py`` kills ``repro.launch.train``; and an
uninterrupted run.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model import build_model as ref_build
from repro.models.nn import Param
from repro.train import OptConfig as RefOptConfig
from repro.train import make_init_state as ref_init_state
from repro.train import make_train_step as ref_train_step
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.checkpoint import _flatten_named as ref_flatten
from repro_torch.configs import get_config
from repro_torch.models.convert import (load_reference_params,
                                        state_from_reference,
                                        state_to_reference, to_reference)
from repro_torch.models.model import Model
from repro_torch.train import OptConfig, make_init_state, make_train_step
from repro_torch.train.checkpoint import CheckpointManager, _flatten_named
from repro_torch.train.data import SyntheticLM

REPO = Path(__file__).resolve().parents[1]
ARCH = "stablelm-1.6b"
SEQ, BATCH = 32, 8
KW = dict(peak_lr=3e-3, warmup_steps=5, decay_steps=200)


def _batches(cfg, start: int, n: int, cycle: int = 4):
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH)
    return [data.get_batch(s % cycle) for s in range(start, start + n)]


def _port_run(state, step, cfg, start, n):
    losses = []
    for b in _batches(cfg, start, n):
        state, metrics = step(state, {k: torch.from_numpy(v).long()
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return state, losses


def _ref_run(state, step, cfg, start, n):
    losses = []
    for b in _batches(cfg, start, n):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return state, losses


def _port_setup(dtype=None, seed=0, **kw):
    cfg = get_config(ARCH).reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Model(cfg, device="cpu", seed=seed)
    opt = OptConfig(**KW, **kw.pop("opt", {}))
    state = make_init_state(model, opt, **kw)()
    return cfg, model, state, make_train_step(model, opt, **kw)


def _ref_setup(dtype=None, **kw):
    cfg = ref_config(ARCH).reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    m = ref_build(cfg)
    opt = RefOptConfig(**KW, **kw.pop("opt", {}))
    state = ref_init_state(m, opt, **kw)(jax.random.PRNGKey(0))
    return cfg, state, jax.jit(ref_train_step(m, opt, **kw))


def _values(tree, f=np.asarray):
    """A reference tree with its ``Param`` wrappers peeled off, ``f`` of
    each array."""
    return jax.tree_util.tree_map(
        lambda x: f(x.value if isinstance(x, Param) else x), tree,
        is_leaf=lambda x: isinstance(x, Param))


def _port_like(ref_state, grad_compression=False, opt=None):
    """A port state over the reference's parameters, optimizer and
    error-feedback state (``convert.state_from_reference``)."""
    cfg, model, state, step = _port_setup(
        grad_compression=grad_compression, opt=opt or {})
    load_reference_params(model, _values(ref_state.params))
    state_from_reference(state.opt, state.ef, _values(ref_state.opt),
                         None if ref_state.ef is None
                         else _values(ref_state.ef))
    state.step.fill_(int(ref_state.step))
    return cfg, model, state, step


# --------------------------------------------------------------------------
# the reference's checkpoint tests, on the port
# --------------------------------------------------------------------------
def test_checkpoint_atomicity_and_gc(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": np.arange(s)}, sync=True)
    files = sorted(p.name for p in tmp_path.glob("step_*.npz"))
    assert files == ["step_00000003.npz", "step_00000004.npz"]
    assert ck.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_*"))
    ck.close()


def test_checkpoint_async_save(tmp_path):
    ck = CheckpointManager(tmp_path)
    ck.save(7, {"x": np.ones(10)})
    ck.wait()
    assert ck.latest_step() == 7
    ck.close()


def test_async_save_takes_its_copy_before_returning(tmp_path):
    """The state keeps changing in place after ``save`` returns (here, on
    the CPU, the tensors' memory is the state itself): the file holds the
    values at the call."""
    t = torch.zeros(1000)
    ck = CheckpointManager(tmp_path)
    ck.save(1, {"t": t})
    t.fill_(1.0)
    ck.close()
    with np.load(tmp_path / "step_00000001.npz") as z:
        assert not z["t"].any()
    assert ck.restore({"t": t}) == ({"t": t}, 1)
    assert not t.any()


def test_checkpoint_resume_training_equivalence(tmp_path):
    """bf16 (the reduced config's dtype): 10 steps, save, restore into a
    fresh state (another seed), 5 more steps each: equal losses."""
    cfg, _, state, step = _port_setup()
    state, _ = _port_run(state, step, cfg, 0, 10)
    ck = CheckpointManager(tmp_path)
    ck.save(10, state, sync=True)
    _, _, fresh, fresh_step = _port_setup(seed=1)
    restored, s0 = ck.restore(fresh)
    assert s0 == 10 and int(restored.step) == 10
    _, la = _port_run(state, step, cfg, 10, 5)
    _, lb = _port_run(restored, fresh_step, cfg, 10, 5)
    np.testing.assert_allclose(la, lb, rtol=1e-5)


def test_restore_without_a_checkpoint_or_with_a_missing_leaf(tmp_path):
    _, _, state, _ = _port_setup()
    ck = CheckpointManager(tmp_path)
    assert ck.restore(state) is None
    ck.save(1, {"<flat index 3>": np.zeros(3, np.int32)}, sync=True)
    with pytest.raises(KeyError):
        ck.restore(state)
    ck.close()


# --------------------------------------------------------------------------
# compatibility with the reference's checkpoints
# --------------------------------------------------------------------------
@pytest.mark.parametrize("opt,gc", [("adamw", True), ("adafactor", False)])
def test_file_has_the_references_keys_shapes_and_dtypes(tmp_path, opt, gc):
    """The same state (the reference's initial one, carried across) gives
    the same npz: key set, shapes, dtypes and values."""
    _, ref_state, _ = _ref_setup(grad_compression=gc, opt={"name": opt})
    _, _, state, _ = _port_like(ref_state, grad_compression=gc,
                                opt={"name": opt})
    RefCheckpointManager(tmp_path / "ref").save(0, ref_state, sync=True)
    CheckpointManager(tmp_path / "port").save(0, state, sync=True)
    with np.load(tmp_path / "ref" / "step_00000000.npz") as r, \
            np.load(tmp_path / "port" / "step_00000000.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for name in r.files:
            assert r[name].shape == p[name].shape, name
            assert r[name].dtype == p[name].dtype, name
            np.testing.assert_array_equal(p[name], r[name], err_msg=name)
    assert sorted(_flatten_named(state)) == sorted(ref_flatten(ref_state))


def test_reference_checkpoint_restores_and_training_goes_on(tmp_path):
    """float32: the reference trains 3 steps and saves; the port restores
    that file into a fresh state (its own seed) and trains 3 more steps,
    equal to the reference's own continuation."""
    cfg, ref_state, ref_step = _ref_setup(dtype="float32")
    ref_state, _ = _ref_run(ref_state, ref_step, cfg, 0, 3)
    RefCheckpointManager(tmp_path).save(3, ref_state, sync=True)
    _, want = _ref_run(ref_state, ref_step, cfg, 3, 3)
    pcfg, _, state, step = _port_setup(dtype="float32", seed=5)
    state, s0 = CheckpointManager(tmp_path).restore(state)
    assert s0 == 3 and int(state.step) == 3 == int(state.opt["step"])
    _, got = _port_run(state, step, pcfg, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """bf16 with int8 error feedback: the port trains 3 steps and saves;
    the reference's ``CheckpointManager.restore`` reads every leaf, equal
    to the port's state bitwise (``convert.state_to_reference``)."""
    cfg, model, state, step = _port_setup(grad_compression=True)
    state, _ = _port_run(state, step, cfg, 0, 3)
    CheckpointManager(tmp_path).save(3, state, sync=True)
    _, ref_state, _ = _ref_setup(grad_compression=True)
    restored, s0 = RefCheckpointManager(tmp_path).restore(
        jax.eval_shape(lambda: ref_state))
    assert s0 == 3 and int(restored.step) == 3
    ref_opt, ref_ef = state_to_reference(state.opt, state.ef)
    want = {"params": to_reference(model), "opt": ref_opt, "ef": ref_ef}
    got = {k: _values(getattr(restored, k), lambda x: np.asarray(
        x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x))
        for k in ("params", "opt", "ef")}
    for k in ("params", "opt", "ef"):
        flat_w = jax.tree_util.tree_leaves_with_path(want[k])
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got[k]))
        assert len(flat_w) == len(flat_g), k
        for path, w in flat_w:
            np.testing.assert_array_equal(flat_g[path], w,
                                          err_msg=f"{k} {path}")


# --------------------------------------------------------------------------
# the CLI, killed and resumed
# --------------------------------------------------------------------------
def _cmd(ckpt_dir, steps, *extra):
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", ARCH, "--reduced", "--steps", str(steps),
            "--batch", "4", "--seq", "32", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "5", "--lr", "3e-3", "--device", "cpu", *extra]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def _run_killed(ckpt_dir, steps, after_step: int):
    """Run with ``--log-every 1`` and send SIGTERM once step ``after_step``
    (past the first checkpoint) is printed."""
    proc = subprocess.Popen(_cmd(ckpt_dir, steps, "--log-every", "1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())
    lines = []
    deadline = time.time() + 300
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(f"step {after_step} "):
                proc.send_signal(signal.SIGTERM)
                break
            if time.time() > deadline:
                break
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode, "".join(lines) + out, err


def test_kill_and_resume_continues_training(tmp_path):
    ck = tmp_path / "ck"
    rc, out, err = _run_killed(ck, 40, after_step=6)
    assert rc == 0, err[-2000:]
    assert "signal received: emergency checkpoint at" in out, out
    killed_at = int(out.split("emergency checkpoint at")[1].split()[0])
    assert 6 <= killed_at < 40
    assert CheckpointManager(ck).latest_step() == killed_at
    r2 = subprocess.run(_cmd(ck, 40, "--resume", "--log-every", "5"),
                        capture_output=True, text=True, timeout=300,
                        env=_env())
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert f"resumed from step {killed_at}" in r2.stdout
    assert "done: 40 steps" in r2.stdout
    final = float(r2.stdout.strip().splitlines()[-1].split()[-1])
    assert final < 7.0


def test_uninterrupted_run_completes(tmp_path):
    r = subprocess.run(_cmd(tmp_path / "ck2", 15, "--log-every", "5"),
                       capture_output=True, text=True, timeout=300,
                       env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 15 steps" in r.stdout
    assert CheckpointManager(tmp_path / "ck2").latest_step() == 15
    r2 = subprocess.run(_cmd(tmp_path / "ck2", 15, "--resume"),
                        capture_output=True, text=True, timeout=300,
                        env=_env())
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "done: 15 steps (already complete at resume)" in r2.stdout
