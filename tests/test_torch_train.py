"""The port's training path on the CPU, held against the reference package.

The reference runs in two subprocesses side by side, this file as a
script, with ``XLA_FLAGS=--xla_allow_excess_precision=false`` so its bf16
rounds at every operation as the port's does (see
``tests/test_torch_models.py``):

    XLA_FLAGS=--xla_allow_excess_precision=false \\
        python tests/test_torch_train.py OUT_DIR {0,1}

It writes ``grads-{arch}-{dtype}.npz`` (the weights, the batch, the loss,
the aux loss and ``jax.value_and_grad``'s gradients of ``Model.loss_fn``)
for the ten architectures at ``reduced()`` size in float32 and for
gemma-2b and mixtral in bf16, and ``traj-{dtype}.npz`` (stablelm-1.6b
reduced: the initial weights and ten AdamW steps' losses and gradient
norms).  The optimizer, the error feedback and the data pipeline are
float32 or integer work, compared in this process.

Tolerances, and why:
- loss and gradients, float32: ``rtol = 1e-4``, and ``atol = 1e-4`` times
  the leaf's largest |gradient| (a gradient near 0 is a difference of
  larger terms, and its error scales with them).  Measured: ~1e-6 of the
  leaf's largest |gradient|, 2.5e-6 for jamba.
- loss and gradients, bf16: the loss to ``test_torch_models.py``'s logit
  bound (``atol = 5e-2``, ``rtol = 2**-7``; measured 0 and 2.6e-4); the
  gradients to ``BF16_GRAD_TOL`` of the leaf's largest |gradient|: a bf16
  rounding that falls the other way in the forward changes a gradient
  element by about one bf16 step (2**-8) of the terms summed into it
  (measured 1.1e-2 for gemma-2b, 1.0e-2 for mixtral).
- the optimizer: ``ULPS`` float32 ulps of the leaf's largest magnitude,
  elementwise (XLA contracts ``a * b + c`` into one rounding where torch
  rounds twice, and sums a mean in another order); bf16 parameters equal;
  the global gradient norm to ``NORM_ULPS`` (a sum of thousands of
  squares in another order; measured up to 10).
- ``lr_at``: 1 ulp (``cos``); error feedback: bitwise.
- the float32 trajectory: each loss and gradient norm to ``rtol = 1e-4``
  (measured 2.7e-7); bf16: each loss to ``BF16_LOSS_RTOL`` (measured
  2.4e-4: the bf16 forward's flips, carried through ten updates).
"""
import dataclasses
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
from torch.utils.checkpoint import noop_context_fn

from repro.configs import get_config as ref_config
from repro.models import nn as ref_nn
from repro.models.model import build_model as ref_build
from repro.models.nn import Param
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro.train.data import Prefetcher as RefPrefetcher
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import make_batch
from repro_torch.models import model as model_mod
from repro_torch.models.convert import (Leaf, load_reference_params,
                                        reference_leaves, reference_state,
                                        to_reference)
from repro_torch.models.model import Model
from repro_torch.train import OptConfig, lr_at, make_init_state, \
    make_train_step
from repro_torch.train import optimizer as port_opt
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.train_step import (dequantize_int8, ef_compress_grads,
                                          quantize_int8)

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 16
BF16_ARCHS = ("gemma-2b", "mixtral-8x22b")
TRAJ_STEPS, TRAJ_BATCH, TRAJ_SEQ = 10, 8, 32
F32_TOL = 1e-4
BF16_LOSS = dict(atol=5e-2, rtol=2 ** -7)
BF16_GRAD_TOL = 3e-2
BF16_LOSS_RTOL = 2e-3
ULPS = 4
NORM_ULPS = 16
EPS32 = 2.0 ** -23


def train_cfg() -> OptConfig:
    """tests/test_train.py's settings."""
    return OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=200)


def train_batch(cfg) -> dict:
    """Numpy inputs from seed 0: S tokens, their next tokens as targets
    (the first three of row 0 masked with -1), and the stubs' inputs."""
    full = make_batch(cfg, B, S + 1, seed=0)
    out = dict(full, tokens=full["tokens"][:, :S],
               targets=full["tokens"][:, 1:].copy())
    out["targets"][0, :3] = -1
    if "positions" in out:
        out["positions"] = out["positions"][:, : S + cfg.img_patches]
    return out


def torch_batch(batch: dict) -> dict:
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        out[key] = (t.long() if key in ("tokens", "targets", "positions")
                    else t)
    return out


def flat_tree(tree, prefix: str) -> dict:
    """Nested numpy tree -> npz entries ``{prefix}.{path}`` (bf16 as its
    uint16 bits under ``{prefix}16.{path}``)."""
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{path}{key}/")
                continue
            arr = np.asarray(val)
            if arr.dtype.name == "bfloat16":
                out[f"{prefix}16.{path}{key}"] = arr.view(np.uint16)
            else:
                out[f"{prefix}.{path}{key}"] = arr
    walk(tree, "")
    return out


def tree_of(npz, prefix: str) -> dict:
    out: dict = {}
    for key in npz.files:
        kind, _, path = key.partition(".")
        if kind not in (prefix, prefix + "16"):
            continue
        arr = npz[key]
        if kind.endswith("16"):
            arr = arr.view(ml_dtypes.bfloat16)
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def get(tree: dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def values_of(tree):
    return jax.tree_util.tree_map(np.asarray, ref_nn.split_params(tree)[0])


# --------------------------------------------------------------------------
# the reference side (run in a subprocess)
# --------------------------------------------------------------------------
def reference_grads(arch: str, dtype: str) -> dict:
    cfg = dataclasses.replace(ref_config(arch).reduced(), dtype=dtype)
    m = ref_build(cfg, remat=False)
    params = m.init(jax.random.PRNGKey(0))
    batch = train_batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        m.loss_fn, has_aux=True))(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    out = flat_tree(values_of(params), "w")
    out.update(flat_tree(values_of(grads), "g"))
    out.update({f"in.{k}": np.asarray(v) for k, v in batch.items()})
    out.update(loss=np.asarray(loss), aux=np.asarray(metrics["aux"]))
    return out


def reference_trajectory(dtype: str) -> dict:
    cfg = dataclasses.replace(ref_config("stablelm-1.6b").reduced(),
                              dtype=dtype)
    m = ref_build(cfg)
    opt = ref_opt.OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=200)
    state = ref_step.make_init_state(m, opt)(jax.random.PRNGKey(0))
    out = flat_tree(values_of(state.params), "w")
    step = jax.jit(ref_step.make_train_step(m, opt))
    data = RefSyntheticLM(cfg.vocab_size, TRAJ_SEQ, TRAJ_BATCH)
    losses, gnorms = [], []
    for s in range(TRAJ_STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.get_batch(s % 4).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    out.update(losses=np.asarray(losses), gnorms=np.asarray(gnorms))
    return out


# the reference's work, in two parts run side by side
PARTS = (
    [("grads", a, "float32") for a in ARCH_IDS[:5]]
    + [("traj", None, "float32"), ("traj", None, "bfloat16")],
    [("grads", a, "float32") for a in ARCH_IDS[5:]]
    + [("grads", a, "bfloat16") for a in BF16_ARCHS])


def main(out_dir: str, part: str) -> int:
    out = Path(out_dir)
    for kind, arch, dtype in PARTS[int(part)]:
        if kind == "grads":
            np.savez(out / f"grads-{arch}-{dtype}.npz",
                     **reference_grads(arch, dtype))
        else:
            np.savez(out / f"traj-{dtype}.npz", **reference_trajectory(dtype))
    return 0


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start the reference's two subprocesses; -> (out dir, processes)."""
    out = tmp_path_factory.mktemp("train_reference")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}
    procs = [subprocess.Popen([sys.executable, __file__, str(out), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for i in range(len(PARTS))]
    try:
        yield out, procs
    finally:
        for proc in procs:
            if proc.poll() is None:  # the module's tests never waited
                proc.kill()
                proc.communicate(timeout=60)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    out, procs = _reference_runs
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
    return out


def port_model(arch: str, dtype: str, values: dict, **kw) -> Model:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return load_reference_params(Model(cfg, device="cpu", **kw), values)


def port_grads(model: Model, batch: dict):
    """-> (loss, aux, {leaf path: stacked float32 gradient})."""
    loss, metrics = model.loss_fn(torch_batch(batch))
    loss.backward()
    grads = {leaf.path: leaf.stack([t.grad for t in leaf.tensors])
             .float().numpy() for leaf in reference_leaves(model)}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), float(metrics["aux"].detach()), grads


# --------------------------------------------------------------------------
# (ii) the optimizer alone
# --------------------------------------------------------------------------
def _ulp_check(got, want, what: str, ulps: int = ULPS):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = np.abs(got - want)
    assert (err <= ulps * EPS32 * scale).all(), (
        f"{what}: {float(err.max()):.3g} > {ulps} ulps of {scale:.3g}")


def _opt_case(name, dtype, shapes, grad_scale, steps, layer_scales=None,
              ulps=ULPS):
    """Both packages' optimizers on the same params and ``steps`` grads
    (numpy seed 0); ``layer_scales[path][step]`` multiplies a stacked
    leaf's layers.  Compares params, state, lr and grad norm each step,
    the float32 values to ``ulps``."""
    rng = np.random.default_rng(0)
    kw = dict(name=name, peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    rcfg, pcfg = ref_opt.OptConfig(**kw), OptConfig(**kw)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    vals = {p: rng.standard_normal(s).astype(np.float32)
            for p, s in shapes.items()}

    def ref_tree(arrays):
        tree: dict = {}
        for path, arr in arrays.items():
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = Param(jnp.asarray(arr).astype(jd),
                               (None,) * arr.ndim)
        return tree

    params = ref_tree(vals)
    # the port's parameters get storage of their own (``torch.tensor``
    # copies): ``jnp.asarray`` may alias a 64-byte-aligned numpy array,
    # and the reference's jitted update reads it asynchronously, so an
    # in-place write by the port into shared memory could land before
    # that read
    leaves = sorted(
        (Leaf(p, tuple(torch.nn.Parameter(torch.tensor(x, dtype=td))
                       for x in (v if p.startswith("group") else [v])),
              p.startswith("group")) for p, v in vals.items()),
        key=lambda leaf: leaf.path.split("/"))
    rstate = ref_opt.init_opt_state(params, rcfg)
    pstate = port_opt.init_opt_state(leaves, pcfg)
    update = jax.jit(lambda p, g, s: ref_opt.apply_updates(p, g, s, rcfg))
    for step in range(steps):
        grads = {}
        for p, s in shapes.items():
            g = rng.standard_normal(s).astype(np.float32) * grad_scale
            if layer_scales and p in layer_scales:
                g *= np.asarray(layer_scales[p][step],
                                np.float32).reshape((-1,) + (1,) * (g.ndim - 1))
            grads[p] = g
        params, rstate, rm = update(params, ref_tree(grads), rstate)
        pstate, pm = port_opt.apply_updates(
            leaves, [torch.from_numpy(grads[leaf.path]).to(td)
                     for leaf in leaves], pstate, pcfg)
        _ulp_check(pm["lr"], rm["lr"], f"lr at step {step}", ulps=1)
        _ulp_check(pm["grad_norm"], rm["grad_norm"], "grad norm",
                   ulps=NORM_ULPS)
        for leaf in leaves:
            want = np.asarray(get(params, leaf.path).value.astype(jnp.float32))
            got = leaf.stack().float().numpy()
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got, want, err_msg=leaf.path)
            else:
                _ulp_check(got, want, f"{leaf.path} step {step}", ulps)
            ref_st = get(rstate["ema"], leaf.path)
            assert set(pstate["ema"][leaf.path]) == set(ref_st), leaf.path
            for k, t in pstate["ema"][leaf.path].items():
                _ulp_check(t.numpy(), np.asarray(ref_st[k].value),
                           f"{leaf.path}/{k} step {step}", ulps)
        assert int(pstate["step"]) == int(rstate["step"]) == step + 1


SHAPES = {"embed": (64, 32), "group0/b0/w": (3, 16, 8),
          "group0/b1/norm/gamma": (3, 8), "norm_f/gamma": (32,)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,ulps", [(1e-3, ULPS),
                                             (1.0, ULPS + NORM_ULPS)],
                         ids=["unclipped", "clipped"])
def test_adamw_matches_reference(dtype, grad_scale, ulps):
    """AdamW over a plain and a stacked leaf; bf16 with float32 masters.
    Clipped (global norm above 1), the clip factor carries the norm's
    error into every update: ``ULPS + NORM_ULPS``."""
    _opt_case("adamw", dtype, SHAPES, grad_scale, steps=3, ulps=ulps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_matches_reference(dtype):
    """A factored stacked leaf (3 x 128 x 160), unfactored ones, bf16 with
    masters."""
    shapes = dict(SHAPES, **{"group0/b0/big": (3, 128, 160)})
    _opt_case("adafactor", dtype, shapes, 1e-3, steps=3)


def test_adafactor_rms_clip_spans_the_group():
    """The update-RMS clip is one statistic over the stacked leaf: layer 0's
    gradients shrink tenfold after step 1 (its own update RMS falls below
    1, no clip), layer 1's stay (RMS above 1).  Taken per layer, layer 0
    would not be clipped and the parameters would differ."""
    scales = {"group0/b0/w": [[10.0, 1.0], [1.0, 1.0], [1.0, 1.0]]}
    _opt_case("adafactor", "float32", {"group0/b0/w": (2, 16, 8)}, 1e-3,
              steps=3, layer_scales=scales)


def test_adafactor_factoring_decided_on_the_stacked_shape():
    """128 layers of a 128-vector stack to (128, 128): factored (``vr``
    [128], ``vc`` [128] shared by the layers); each layer alone is 1-D and
    would not be."""
    _opt_case("adafactor", "float32", {"group0/b0/norm/gamma": (128, 128),
                                       "embed": (8, 8)}, 1e-3, steps=2)


@pytest.mark.parametrize("step", [0, 5, 10, 110, 500])
def test_lr_at_matches_reference(step):
    kw = dict(peak_lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    _ulp_check(lr_at(OptConfig(**kw), step).numpy(),
               np.asarray(ref_opt.lr_at(ref_opt.OptConfig(**kw), step)),
               f"lr_at({step})", ulps=1)
    assert lr_at(OptConfig(**kw), torch.tensor(step, dtype=torch.int32)
                 ).dtype == torch.float32


def test_lr_schedule_shape():
    """The reference's own schedule test (tests/test_train.py)."""
    opt = OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                    min_lr_ratio=0.1)
    assert float(lr_at(opt, 0)) == 0.0
    assert abs(float(lr_at(opt, 10)) - 1.0) < 1e-6
    assert float(lr_at(opt, 5)) == 0.5
    assert float(lr_at(opt, 110)) <= 0.11
    assert float(lr_at(opt, 500)) >= 0.0999


# --------------------------------------------------------------------------
# (iii) int8 error feedback
# --------------------------------------------------------------------------
def test_ef_compress_grads_bitwise_with_one_scale_per_group():
    """A stacked leaf whose layers' largest |g + e| differ 100-fold: one
    scale over the group, as the reference's; bitwise equal."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 32, 16)).astype(np.float32) * 1e-2
    g[1] *= 100.0
    e = rng.standard_normal((3, 32, 16)).astype(np.float32) * 1e-4
    ref_g, ref_e = ref_step.ef_compress_grads(
        {"w": Param(jnp.asarray(g), (None,) * 3)},
        {"w": Param(jnp.asarray(e), (None,) * 3)})
    got_g, got_e = ef_compress_grads([torch.from_numpy(g)],
                                     [torch.from_numpy(e)])
    np.testing.assert_array_equal(got_g[0].numpy(),
                                  np.asarray(ref_g["w"].value))
    np.testing.assert_array_equal(got_e[0].numpy(),
                                  np.asarray(ref_e["w"].value))


def test_train_step_compresses_each_stacked_leaf_with_one_scale(
        monkeypatch):
    """Through the train step: a stacked leaf's compressed gradient is a
    multiple of one quantum, its group's largest |g| / 127, in every
    layer (per-layer scales would give each layer its own)."""
    import repro_torch.train.train_step as ts
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              dtype="float32")
    model = Model(cfg, device="cpu")
    seen = {}
    real = ts.apply_updates

    def spy(leaves, grads, state, ocfg):
        seen.update({leaf.path: g.clone() for leaf, g in zip(leaves, grads)})
        return real(leaves, grads, state, ocfg)
    monkeypatch.setattr(ts, "apply_updates", spy)
    step = make_train_step(model, train_cfg(), grad_compression=True)
    state = make_init_state(model, train_cfg(), grad_compression=True)()
    batch = {k: torch.from_numpy(v).long() for k, v in
             SyntheticLM(cfg.vocab_size, 16, 2).get_batch(0).items()}
    step(state, batch)
    g = seen["group0/b0/ffn/w_up"]
    assert g.shape[0] == 2
    units = (g / (g.abs().max() / 127)).numpy()
    np.testing.assert_allclose(units, np.round(units), atol=1e-3)


def test_quantize_int8_matches_reference():
    x = np.random.default_rng(4).standard_normal(1000).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_step.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_step.dequantize_int8(rq, rs)))


def test_quantize_int8_range():
    """The reference's range test (tests/test_train.py)."""
    q, _ = quantize_int8(torch.tensor([-3.0, 0.0, 3.0]))
    assert q.dtype == torch.int8
    assert int(q[0]) == -127 and int(q[2]) == 127


def test_quantize_int8_error_feedback_converges():
    """The reference's convergence test: the accumulated compressed signal
    tracks the true one."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32)) * 0.01
    ef = [torch.zeros_like(g)]
    total = torch.zeros_like(g)
    for _ in range(50):
        cg, ef = ef_compress_grads([g], ef)
        total = total + cg[0]
    want = g * 50
    rel = float((total - want).abs().max() / want.abs().max())
    assert rel < 0.05, rel


# --------------------------------------------------------------------------
# (v) remat and the other training knobs
# --------------------------------------------------------------------------
def _loss_and_grads(arch: str, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = Model(cfg, device="cpu", seed=1, **kw)
    return port_grads(model, train_batch(cfg))


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("kw", [dict(remat=False),
                                dict(remat=True, remat_policy="dots"),
                                dict(long_context=True)],
                         ids=["no-remat", "dots", "long_context"])
def test_remat_changes_memory_not_values(arch, kw):
    """Against ``remat=True, remat_policy="nothing"`` (the default): equal
    loss, aux and gradients, bitwise, on the CPU (the recomputation runs
    the same kernels on the same inputs)."""
    base = _loss_and_grads(arch)
    other = _loss_and_grads(arch, **kw)
    assert other[:2] == base[:2]
    for path, g in base[2].items():
        np.testing.assert_array_equal(other[2][path], g, err_msg=path)


def test_remat_recomputes_each_unit(monkeypatch):
    """remat wraps each reference unit: jamba reduced has one group of
    2 repeats of a 2-block unit, so 2 checkpointed calls a forward; and
    ``"dots"`` passes a selective-checkpoint context."""
    calls = []
    real = model_mod.checkpoint

    def spy(fn, *args, **kw):
        calls.append((args[1], kw["context_fn"] is not noop_context_fn))
        return real(fn, *args, **kw)
    monkeypatch.setattr(model_mod, "checkpoint", spy)
    for policy in ("nothing", "dots"):
        _loss_and_grads("jamba-v0.1-52b", remat_policy=policy)
    assert calls == [(2, False), (2, False), (2, True), (2, True)]
    with pytest.raises(ValueError, match="remat_policy"):
        Model(get_config("gemma-2b").reduced(), device="meta",
              remat_policy="everything")


def test_unroll_scans_mamba_in_one_chunk(monkeypatch):
    """``unroll=True`` hands Mamba the whole sequence as one chunk (the
    reference's ``chunk=x.shape[1]``); 256 otherwise.  Same loss to
    float32 rounding (another grouping of the same scan)."""
    chunks = []
    real = model_mod.mamba_apply

    def spy(*args, chunk, **kw):
        chunks.append(chunk)
        return real(*args, chunk=chunk, **kw)
    monkeypatch.setattr(model_mod, "mamba_apply", spy)
    rolled = _loss_and_grads("jamba-v0.1-52b")
    assert set(chunks) == {256}
    chunks.clear()
    unrolled = _loss_and_grads("jamba-v0.1-52b", unroll=True)
    assert set(chunks) == {S}
    np.testing.assert_allclose(unrolled[0], rolled[0], rtol=1e-6)


def test_to_reference_inverts_reference_state():
    """``to_reference`` stacks the port's layers back into the reference's
    tree (its shapes), and ``reference_state`` of it gives the same
    parameters, bitwise (bf16 comes out as float32, exact)."""
    arch = "jamba-v0.1-52b"
    model = Model(get_config(arch).reduced(), device="cpu", seed=3)
    tree = to_reference(model)
    want = jax.tree_util.tree_map(
        lambda p: tuple(p.value.shape),
        ref_build(ref_config(arch).reduced()).abstract_params(),
        is_leaf=lambda x: isinstance(x, Param))
    assert jax.tree_util.tree_map(lambda a: a.shape, tree) == want
    back = reference_state(model, tree)
    own = model.state_dict()
    assert back.keys() == own.keys()
    for key, val in own.items():
        assert torch.equal(back[key], val.float()), key


# --------------------------------------------------------------------------
# (vii) data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("host", [0, 3])
def test_synthetic_lm_batches_are_the_references(host):
    ours = SyntheticLM(1000, 16, 4, host_id=host, seed=5)
    ref = RefSyntheticLM(1000, 16, 4, host_id=host, seed=5)
    for step in (0, 1, 42):
        a, b = ours.get_batch(step), ref.get_batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    corpus = np.arange(5000) * 7
    a = SyntheticLM(300, 8, 2, corpus=corpus).get_batch(3)
    b = RefSyntheticLM(300, 8, 2, corpus=corpus).get_batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_prefetcher_keeps_order_and_closes():
    data = SyntheticLM(1000, 16, 4, host_id=3)
    pf, ref = Prefetcher(data, start_step=7, depth=2), \
        RefPrefetcher(RefSyntheticLM(1000, 16, 4, host_id=3), start_step=7)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(pf.next()["tokens"],
                                          ref.next()["tokens"])
    finally:
        pf.close()
        ref.close()
    assert not pf._thread.is_alive()


# The tests below wait for the reference's subprocesses, which the module
# starts before its first test, so the tests above run meanwhile.
# --------------------------------------------------------------------------
# (i) loss and gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype",
                         [(a, "float32") for a in ARCH_IDS]
                         + [(a, "bfloat16") for a in BF16_ARCHS])
def test_loss_and_gradients_match_reference(reference, arch, dtype):
    with np.load(reference / f"grads-{arch}-{dtype}.npz") as npz:
        values, want = tree_of(npz, "w"), tree_of(npz, "g")
        batch = {k[3:]: npz[k] for k in npz.files if k.startswith("in.")}
        ref_loss, ref_aux = float(npz["loss"]), float(npz["aux"])
    loss, aux, grads = port_grads(port_model(arch, dtype, values), batch)
    if dtype == "float32":
        np.testing.assert_allclose(loss, ref_loss, rtol=F32_TOL)
        np.testing.assert_allclose(aux, ref_aux, rtol=F32_TOL, atol=1e-6)
    else:
        np.testing.assert_allclose(loss, ref_loss, **BF16_LOSS)
    tol = F32_TOL if dtype == "float32" else BF16_GRAD_TOL
    assert set(grads) == {p for p in _paths(want)}
    for path, got in grads.items():
        ref = np.asarray(get(want, path), np.float32)
        assert got.shape == ref.shape, path
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(
            got, ref, rtol=tol if dtype == "float32" else 0,
            atol=tol * scale, err_msg=f"{arch} {dtype} {path}")


def _paths(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _paths(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}"


def test_ce_includes_the_aux_loss(reference):
    """The reference reports ``"ce"`` after adding ``0.01 * aux``: the
    port mirrors that (mixtral, a MoE config)."""
    with np.load(reference / "grads-mixtral-8x22b-float32.npz") as npz:
        values = tree_of(npz, "w")
        batch = {k[3:]: npz[k] for k in npz.files if k.startswith("in.")}
    model = port_model("mixtral-8x22b", "float32", values)
    with torch.no_grad():
        loss, metrics = model.loss_fn(torch_batch(batch))
        logits, aux = model(torch_batch(batch))
    assert float(metrics["ce"]) == float(loss)
    assert float(aux) > 0
    targets = torch.from_numpy(batch["targets"]).long()
    mask = targets >= 0
    ll = torch.log_softmax(logits, -1).gather(
        -1, targets.clamp_min(0)[..., None])[..., 0]
    plain = -(ll * mask).sum() / mask.sum()
    np.testing.assert_allclose(float(loss), float(plain + 0.01 * aux),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# (iv) a training trajectory
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trajectory_matches_reference(reference, dtype):
    """stablelm-1.6b reduced, ten AdamW steps over four batches of
    ``SyntheticLM``, from the reference's initial weights."""
    with np.load(reference / f"traj-{dtype}.npz") as npz:
        values = tree_of(npz, "w")
        want_loss, want_gnorm = npz["losses"], npz["gnorms"]
    model = port_model("stablelm-1.6b", dtype, values)
    state = make_init_state(model, train_cfg())()
    step = make_train_step(model, train_cfg())
    data = SyntheticLM(model.cfg.vocab_size, TRAJ_SEQ, TRAJ_BATCH)
    losses, gnorms = [], []
    for s in range(TRAJ_STEPS):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.get_batch(s % 4).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    assert int(state.step) == TRAJ_STEPS
    assert losses[-1] < losses[0] - 1.0
    if dtype == "float32":
        np.testing.assert_allclose(losses, want_loss, rtol=F32_TOL)
        np.testing.assert_allclose(gnorms, want_gnorm, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(losses, want_loss, rtol=BF16_LOSS_RTOL)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
