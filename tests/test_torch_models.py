"""The port's LLM stack on the CPU, held against the reference package.

All ten architectures at ``reduced()`` size, with the reference's weights
carried across by ``load_reference_params``: the teacher-forced logits, the
prefill logits and one decode step's logits, in float32 and in the default
bfloat16.  The reference runs in one subprocess, this file as a script:

    XLA_FLAGS=--xla_allow_excess_precision=false \\
        python tests/test_torch_models.py OUT_DIR

By default XLA may keep float32 between the fused bf16 operations of a
compiled scan body ("excess precision"), so where a bf16 value is rounded
depends on its fusion decisions; with the flag off every operation rounds
to bf16, as the reference does when it runs op by op and as the port
does.  Float32 is unaffected.  Each file ``{arch}-{dtype}.npz`` holds the
weights (``w.<path>``; bf16 as its uint16 bits under ``w16.<path>``), the
inputs (``in.<key>``) and the logits of the teacher-forced forward over
S + 1 tokens (``fwd``), of the prefill of the first S (``pre``) and of one
decode step (``dec``).

Tolerances: float32, ``atol = rtol = 1e-4`` (the port agrees to ~5e-6: the
same operations, summed in another order).  bfloat16, ``atol = 5e-2`` and
``rtol = 2**-7``.  The logits are bf16 values cast to float32, so one
rounding that falls the other way in the last matmul moves a logit of
magnitude 4 to 8 by one bf16 step (2**-5 = 0.031; ``rtol`` covers it).
Inside the stack, torch and XLA sum a row (a norm's mean square, an
attention score) in another order; the float32 results differ in the last
bit, and a few bf16 roundings after them fall the other way (0.05% to 4%
of a layer's outputs on the same input), which the following layers
carry: the largest difference measured at a small logit is 0.035
(kimi-k2's forward), beyond the 2e-2 of the reference's own prefill/decode
test, which compares one package with itself and holds here too
(``test_prefill_decode_matches_forward``).

Also: the full configs' parameter counts against the reference's, counted
on the meta device; the sliding-window ring buffer against the reference;
gemma's embedding scale, bitwise.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import nn as ref_nn
from repro.models.model import build_model as ref_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import make_batch
from repro_torch.models.convert import load_reference_params
from repro_torch.models.model import Model, param_count

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 16
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=2 ** -7)}


def flat_weights(values, prefix: str = "") -> dict:
    out = {}
    for key, val in values.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flat_weights(val, path + "."))
            continue
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":
            out[f"w16.{path}"] = arr.view(np.uint16)
        else:
            out[f"w.{path}"] = arr
    return out


def reference_run(arch: str, dtype: str, seed: int = 0) -> dict:
    """The reference side, run in a subprocess (see the module's doc)."""
    cfg = dataclasses.replace(ref_config(arch).reduced(), dtype=dtype)
    m = ref_build(cfg, remat=False)
    params = m.init(jax.random.PRNGKey(seed))
    batch = make_batch(cfg, B, S + 1, seed=0)
    extra = cfg.img_patches if cfg.modality_stub == "image_patches" else 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc_out = m._encode(params, jb) if cfg.is_encdec else None
    x, positions = m._embed_inputs(params, jb)
    x, _, _ = m._run_groups(params, x, positions, enc_out=enc_out)
    fwd = m._logits(params, x)
    pre = dict(jb)
    pre["tokens"] = jb["tokens"][:, :S]
    if extra:
        pre["positions"] = jb["positions"][:, : S + extra]
    logits0, caches, enc = m.prefill(params, pre, cache_len=S + 1 + extra)
    logits1, _ = m.decode_step(params, caches, jb["tokens"][:, S:S + 1],
                               jnp.asarray(S + extra, jnp.int32),
                               enc_out=enc)
    out = flat_weights(ref_nn.split_params(params)[0])
    out.update({f"in.{k}": np.asarray(v) for k, v in batch.items()})
    out.update(fwd=np.asarray(fwd), pre=np.asarray(logits0),
               dec=np.asarray(logits1))
    return out


def torch_batch(batch: dict) -> dict:
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        out[key] = t.long() if key in ("tokens", "positions") else t
    return out


def unflatten(npz) -> tuple[dict, dict, dict]:
    """-> (weights tree, numpy inputs, logits) from a runner file."""
    values, batch, logits = {}, {}, {}
    for key in npz.files:
        kind, _, path = key.partition(".")
        if kind in ("w", "w16"):
            arr = npz[key]
            if kind == "w16":
                arr = arr.view(ml_dtypes.bfloat16)
            node = values
            *parents, leaf = path.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
        elif kind == "in":
            batch[path] = npz[key]
        else:
            logits[key] = npz[key]
    return values, batch, logits


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("llm_reference")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}
    r = subprocess.run([sys.executable, __file__, str(out)],
                       capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    return out


@pytest.fixture(scope="module")
def runs(reference):
    """(arch, dtype) -> (reference logits, port logits), computed once."""
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            with np.load(reference / f"{arch}-{dtype}.npz") as npz:
                values, batch, want = unflatten(npz)
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
            model = load_reference_params(Model(cfg, device="cpu"), values)
            memo[arch, dtype] = want, port_logits(model, cfg, batch)
        return memo[arch, dtype]
    return get


@torch.inference_mode()
def port_logits(model, cfg, batch: dict) -> dict:
    extra = cfg.img_patches if cfg.modality_stub == "image_patches" else 0
    tb = torch_batch(batch)
    fwd, _ = model(tb)
    pre = dict(tb)
    pre["tokens"] = tb["tokens"][:, :S]
    if extra:
        pre["positions"] = tb["positions"][:, : S + extra]
    logits0, caches, enc = model.prefill(pre, cache_len=S + 1 + extra)
    logits1, _ = model.decode_step(caches, tb["tokens"][:, S:S + 1],
                                   S + extra, enc_out=enc)
    return {"fwd": fwd.numpy(), "pre": logits0.numpy(),
            "dec": logits1.numpy()}


@pytest.mark.parametrize("mode", ["fwd", "pre", "dec"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logits_match_reference(runs, arch, dtype, mode):
    want, got = runs(arch, dtype)
    assert got[mode].shape == want[mode].shape
    assert np.isfinite(got[mode]).all()
    np.testing.assert_allclose(got[mode], want[mode], **TOL[dtype],
                               err_msg=f"{arch} {dtype} {mode}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_forward(runs, arch):
    """The reference's own check (atol 2e-2, bf16), on the port alone."""
    _, got = runs(arch, "bfloat16")
    cfg = get_config(arch).reduced()
    extra = cfg.img_patches if cfg.modality_stub == "image_patches" else 0
    np.testing.assert_allclose(got["pre"][:, 0], got["fwd"][:, S - 1 + extra],
                               atol=2e-2)
    np.testing.assert_allclose(got["dec"][:, 0], got["fwd"][:, S + extra],
                               atol=2e-2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count(arch):
    """Counted on the meta device (nothing allocated), equal to the
    reference's abstract count."""
    assert param_count(get_config(arch)) == ref_build(
        ref_config(arch)).param_count()
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_config(arch))


def _ring_case(window: int, steps: int = 4, S: int = 24):
    """Both packages' mixtral (reduced, float32) with a sliding window:
    the reference's teacher-forced logits and decode logits through its
    ring buffer, and the port's decode logits through its own."""
    ref_cfg = dataclasses.replace(ref_config("mixtral-8x22b").reduced(),
                                  sliding_window=window, dtype="float32")
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                              sliding_window=window, dtype="float32")
    m = ref_build(ref_cfg, remat=False)
    params = m.init(jax.random.PRNGKey(1))
    batch = make_batch(ref_cfg, 1, S + steps, seed=0)
    tokens = jnp.asarray(batch["tokens"])
    x, positions = m._embed_inputs(params, {"tokens": tokens})
    xx, _, _ = m._run_groups(params, x, positions)
    ref_fwd = np.asarray(m._logits(params, xx))
    logits, caches, _ = m.prefill(params, {"tokens": tokens[:, :S]},
                                  cache_len=S + steps)
    ref_dec = []
    for i in range(steps):
        logits, caches = m.decode_step(params, caches,
                                       tokens[:, S + i:S + i + 1],
                                       jnp.asarray(S + i, jnp.int32))
        ref_dec.append(np.asarray(logits[:, 0]))
    values = jax.tree_util.tree_map(np.asarray,
                                    ref_nn.split_params(params)[0])
    model = load_reference_params(Model(cfg, device="cpu"), values)
    got = []
    with torch.inference_mode():
        t = torch.from_numpy(batch["tokens"])
        logits, caches, _ = model.prefill({"tokens": t[:, :S]},
                                          cache_len=S + steps)
        assert caches[0]["attn"]["k"].shape[1] == min(window, S + steps)
        for i in range(steps):
            logits, caches = model.decode_step(caches, t[:, S + i:S + i + 1],
                                               S + i)
            got.append(logits[:, 0].numpy())
    return ref_fwd[:, S:S + steps].transpose(1, 0, 2), np.stack(ref_dec), \
        np.stack(got)


def test_sliding_window_ring_buffer_matches_full_cache():
    """The window (64) covers everything: decode through the ring buffer
    equals the teacher-forced forward, in the port as in the reference."""
    ref_fwd, ref_dec, got = _ring_case(window=64)
    np.testing.assert_allclose(got, ref_fwd, **TOL["float32"])
    np.testing.assert_allclose(got, ref_dec, **TOL["float32"])


def test_ring_buffer_after_prefill_longer_than_window():
    """A prefill of 24 positions into a 16-slot ring keeps the last 16
    (slot i holds position 8 + i) and decode writes slot ``pos % 16``: the
    port's decode logits equal the reference's step by step."""
    _, ref_dec, got = _ring_case(window=16)
    np.testing.assert_allclose(got, ref_dec, **TOL["float32"])


def test_gemma_embedding_scale_is_rounded_to_bf16():
    """sqrt(d_model) is cast to the activation dtype before the multiply
    (45.25 in bf16 at d_model 2048, not 45.2548): bitwise."""
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(),
                              d_model=2048)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((2048, 2048)).astype(ml_dtypes.bfloat16)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    m = ref_build(dataclasses.replace(ref_config("gemma-2b").reduced(),
                                      d_model=2048))
    want, _ = m._embed_inputs(
        {"embed": ref_nn.Param(jnp.asarray(emb), ("vocab", "embed"))},
        {"tokens": jnp.asarray(tokens)})
    model = Model(cfg, device="meta")
    with torch.no_grad():
        model.embed = torch.nn.Parameter(
            torch.from_numpy(emb.view(np.uint16)).view(torch.bfloat16))
        got, _ = model._embed_inputs({"tokens": torch.from_numpy(tokens)})
    assert float(torch.tensor(math.sqrt(2048), dtype=torch.bfloat16)) == 45.25
    np.testing.assert_array_equal(
        got.view(torch.uint16).numpy(),
        np.asarray(want).view(np.uint16))


def main(out_dir: str) -> int:
    out = Path(out_dir)
    for dtype in ("float32", "bfloat16"):
        for arch in ARCH_IDS:
            np.savez(out / f"{arch}-{dtype}.npz", **reference_run(arch, dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
