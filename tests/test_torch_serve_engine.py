"""The port's ``ServeEngine`` and ``python -m repro_torch.launch.serve`` on
the CPU, held against the reference's ``ServeEngine``.

Greedy tokens must equal the reference's, in float32 at ``reduced()``
size, with the reference's weights.  The port's logits agree with the
reference's to ~5e-6 (tests/test_torch_models.py); where the reference's
top two logits at a step are closer than ``MARGIN`` (1e-4), either token
is a right answer and the comparison of that row stops at that step.
Sampling at ``temperature > 0`` cannot reproduce ``jax.random``: it is
held to determinism for a seed and to the vocabulary's range.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import nn as ref_nn
from repro.models.model import build_model as ref_build
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch.serve import make_batch
from repro_torch.models.convert import load_reference_params
from repro_torch.models.model import Model, padded_vocab
from repro_torch.serve import ServeEngine

REPO = Path(__file__).resolve().parents[1]
MARGIN = 1e-4
TOKENS = 8


def _pair(arch: str, seed: int = 0):
    """The reference's model and params, and the port's model carrying the
    same weights (float32, reduced)."""
    ref_cfg = dataclasses.replace(ref_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    m = ref_build(ref_cfg, remat=False)
    params = m.init(jax.random.PRNGKey(seed))
    values = jax.tree_util.tree_map(np.asarray,
                                    ref_nn.split_params(params)[0])
    return m, params, load_reference_params(Model(cfg, device="cpu"), values)


def _ref_margins(m, params, batch, toks) -> np.ndarray:
    """[B, TOKENS]: the reference's top-two logit gap at each generated
    step, teacher-forced over the prompt and its own tokens."""
    full = dict(batch)
    full["tokens"] = np.concatenate([batch["tokens"], toks[:, :-1]], axis=1)
    if "positions" in batch:
        S = full["tokens"].shape[1] + m.cfg.img_patches
        full["positions"] = np.broadcast_to(
            np.arange(S)[None, :, None], (toks.shape[0], S, 3)).astype(
                np.int32)
    jb = {k: jnp.asarray(v) for k, v in full.items()}
    enc = m._encode(params, jb) if m.cfg.is_encdec else None
    x, positions = m._embed_inputs(params, jb)
    x, _, _ = m._run_groups(params, x, positions, enc_out=enc)
    logits = np.asarray(m._logits(params, x))[:, -toks.shape[1]:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("arch", ["gemma-2b", "stablelm-1.6b",
                                  "jamba-v0.1-52b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2"])
def test_greedy_generate_matches_reference(arch):
    m, params, model = _pair(arch)
    batch = make_batch(m.cfg, 2, 12, seed=1)
    want, _ = RefEngine(m, params).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, num_tokens=TOKENS)
    got, stats = ServeEngine(model, device="cpu").generate(
        batch, num_tokens=TOKENS)
    assert got.shape == want.shape == (2, TOKENS) and got.dtype == np.int32
    assert stats.tokens_generated == 2 * TOKENS
    if (got == want).all():
        return
    margins = _ref_margins(m, params, batch, want)
    for row in range(got.shape[0]):
        differ = np.flatnonzero(got[row] != want[row])
        if differ.size:  # a near tie at the first difference: stop there
            step = differ[0]
            assert margins[row, step] < MARGIN, (arch, row, step,
                                                 got[row], want[row])


def test_sampling_is_deterministic_for_a_seed():
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="float32")
    engine = ServeEngine(Model(cfg, device="cpu", seed=3), device="cpu")
    batch = make_batch(cfg, 3, 10, seed=2)
    a, _ = engine.generate(batch, num_tokens=12, temperature=0.8, seed=5)
    b, _ = engine.generate(batch, num_tokens=12, temperature=0.8, seed=5)
    c, _ = engine.generate(batch, num_tokens=12, temperature=0.8, seed=6)
    greedy, _ = engine.generate(batch, num_tokens=12)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and (a != greedy).any()
    assert a.min() >= 0 and a.max() < padded_vocab(cfg)


def test_engine_and_model_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(model, device="cuda:0")
    assert model.device.type == "cpu"  # nothing moved


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-1.6b", "--reduced", *args], capture_output=True,
        text=True, timeout=300, env=env)


def test_serve_cli_runs_on_the_cpu_when_asked():
    out = _cli("--device", "cpu", "--batch", "2", "--tokens", "6")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated (2, 6) tokens on cpu" in out.stdout


def test_serve_cli_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    out = _cli("--tokens", "2")
    assert out.returncode != 0
    assert "cuda" in out.stderr
