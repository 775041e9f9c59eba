"""The port's mesh paths on CPU lanes, held against the reference on a jax
mesh: the MoE's expert-parallel modes, the sequence-sharded decode, whole
models on 2 x 2, their loss and gradients, and ``launch.train --mesh``.

The reference runs in four subprocesses side by side, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8
--xla_allow_excess_precision=false`` (eight host devices for its meshes;
bf16 rounded at every operation, as the port rounds it):

    python tests/test_torch_mesh_layers.py OUT_DIR {layers,fwd0,fwd1,cli}

The first three write ``{part}.npz``: each case's weights
(``w.<case>.<path>``), its inputs and the reference's outputs (the
layers, gradients and decodes; half the forward cases each).  ``cli``
runs ``python -m repro.launch.train --mesh 2x2`` with a checkpoint at
step 3 and writes its losses.  The port computes the same in this process, on
``["cpu"] * n`` lanes, with the reference's weights
(``load_reference_params``).

Cases and tolerances (float32 unless named):
- ``moe_apply`` on (data 2, model 2) in the 'a2a', 'replicated' and serve
  2-D layouts, and 'a2a' on (pod 2, data 2, model 2), without drops
  (capacity factor 8) and with (1.0, so each data shard's capacity is
  ceil(T_local * k / E) = 4 slots): ``y`` to ``atol = rtol = 1e-5`` (the
  same products summed in another order: ``tests/test_torch_layers.py``'s
  bound), ``aux`` to ``rtol = 1e-6`` (a mean of softmax probabilities,
  whose ``exp`` differs in the last bit).
- ``flash_decode_sharded`` on data = 4 and on 2 x 2, with random values
  past ``kv_len`` in the cache, ``kv_len`` one past the query's position
  and below it: ``atol = rtol = 1e-5``.
- whole models on 2 x 2, the ten archs' forward logits, the MoE archs in
  every EP mode and kimi with capacity factor 1.0: ``atol = rtol = 1e-4``
  (``tests/test_torch_models.py``'s float32 bound); gemma-2b's prefill
  and decode on 2 x 2 (its one KV head repeated to two); long-context
  prefill and decode on (data 4, model 1): the same bound.
- the loss and gradients of mixtral and kimi on 2 x 2: ``rtol = 1e-4``,
  and ``atol = 1e-4`` times the leaf's largest |gradient|
  (``tests/test_torch_train.py``'s).
- the CLI, bf16: the port resumes the reference's step-3 checkpoint with
  ``--mesh 2x2 --device cpu`` and logs steps 4 to 6; each loss to
  ``rtol = 2e-3``, ``test_torch_train.py``'s bf16 trajectory bound (a
  bf16 rounding that falls the other way in the forward, carried through
  the updates), beside the 5e-5 of the 4-decimal print.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import MoEConfig as RMoEConfig
from repro.dist.context import make_rules as ref_rules
from repro.models import attention as r_att
from repro.models import moe as r_moe
from repro.models import nn as r_nn
from repro.models.model import build_model as ref_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.dist.context import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import make_batch
from repro_torch.models import attention as p_att
from repro_torch.models import moe as p_moe
from repro_torch.models.convert import (load_reference_params,
                                        reference_leaves, to_tensor)
from repro_torch.models.model import Model
from repro_torch.models.nn import Init

REPO = Path(__file__).resolve().parents[1]
F32 = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4
CLI_RTOL = 2e-3
MOE_D, MOE_X = 32, (4, 8, 32)
MOE_CASES = [(mode, cf) for mode in ("a2a", "replicated", "serve2d",
                                     "a2a_pod") for cf in (8.0, 1.0)]
MESHES = {"a2a": ((2, 2), ("data", "model"), {}),
          "replicated": ((2, 2), ("data", "model"),
                         {"ep_mode": "replicated"}),
          "serve2d": ((2, 2), ("data", "model"), {"serve_fsdp": False}),
          "a2a_pod": ((2, 2, 2), ("pod", "data", "model"), {})}
MOE_ARCHS = ("jamba-v0.1-52b", "mixtral-8x22b", "kimi-k2-1t-a32b")
# (case, arch, capacity factor or None, rules)
FWD_CASES = ([(f"fwd-{a}", a, None, {}) for a in ARCH_IDS]
             + [(f"fwd-{a}-{m}", a, None, kw) for a in MOE_ARCHS
                for m, kw in (("replicated", {"ep_mode": "replicated"}),
                              ("serve2d", {"serve_fsdp": False}))]
             + [("fwd-kimi-k2-1t-a32b-drops", "kimi-k2-1t-a32b", 1.0, {})])
GRAD_ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")
LONG_ARCHS = ("gemma-2b", "jamba-v0.1-52b", "kimi-k2-1t-a32b")
B, S, PROMPT, STEPS = 4, 16, 16, 3
KV_LENS = (21, 17)  # a decode at position 20: the cache's fill, and less
CLI = ["--arch", "mixtral-8x22b", "--reduced", "--mesh", "2x2", "--steps",
       "6", "--batch", "4", "--seq", "32", "--ckpt-every", "3", "--lr",
       "3e-3", "--log-every", "1"]


def moe_config(cf: float, cls=MoEConfig):
    return cls(num_experts=8, top_k=2, d_ff_expert=24, num_shared_experts=1,
               capacity_factor=cf)


def model_config(arch: str, cf: float | None, get=get_config):
    cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def flat(tree, prefix: str) -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def nest(npz: dict, prefix: str) -> dict:
    out: dict = {}
    for key, arr in npz.items():
        if not key.startswith(prefix):
            continue
        node = out
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def tokens_for(cfg, seq: int) -> dict:
    batch = make_batch(cfg, B, seq, seed=0)
    if "positions" in batch:
        batch["positions"] = np.ascontiguousarray(batch["positions"])
    return batch


# --------------------------------------------------------------------------
# the reference side (run as a script in a subprocess)
# --------------------------------------------------------------------------
def _ref_mesh(name):
    shape, axes, _ = MESHES[name]
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def reference_layers(out: dict) -> None:
    x = np.random.default_rng(1).standard_normal(MOE_X).astype(np.float32)
    out["in.moe_x"] = x
    for mode, cf in MOE_CASES:
        kg = r_nn.KeyGen(jax.random.PRNGKey(2))
        p = r_moe.init_moe(kg, MOE_D, moe_config(cf, RMoEConfig), "swiglu",
                           jnp.float32)
        ctx = ref_rules(_ref_mesh(mode), ref_config("kimi-k2-1t-a32b"),
                        **MESHES[mode][2])
        fn = jax.jit(lambda p, x: r_moe.moe_apply(
            p, x, moe_config(cf, RMoEConfig), "swiglu", ctx))
        y, aux = fn(p, jnp.asarray(x))
        case = f"moe-{mode}-{cf}"
        out.update(flat(r_nn.split_params(p)[0], f"w.{case}."))
        out[f"y.{case}"], out[f"aux.{case}"] = np.asarray(y), np.asarray(aux)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 32, 2, 16)).astype(np.float32)
    out["in.q"], out["in.kv"] = q, kv
    for name, shape in (("data4", (4, 1)), ("2x2", (2, 2))):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        ctx = ref_rules(mesh, ref_config("gemma-2b"), long_context=True)
        for kv_len in KV_LENS:
            got = jax.jit(lambda q, k, v: r_att.flash_decode_sharded(
                q, k, v, kv_len, ctx, q_offset=20))(q, kv[0], kv[1])
            out[f"decode.{name}.{kv_len}"] = np.asarray(got)


def reference_forwards(out: dict, cases) -> None:
    mesh = _ref_mesh("a2a")
    for case, arch, cf, kw in cases:
        cfg = model_config(arch, cf, ref_config)
        m = ref_build(cfg, ref_rules(mesh, cfg, **kw), remat=False)
        params = m.init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in tokens_for(cfg, S).items()}

        def fwd(params, batch, m=m, cfg=cfg):
            enc = m._encode(params, batch) if cfg.is_encdec else None
            x, pos = m._embed_inputs(params, batch)
            x, aux, _ = m._run_groups(params, x, pos, enc_out=enc)
            return m._logits(params, x), aux
        logits, aux = jax.jit(fwd)(params, batch)
        out.update(flat(r_nn.split_params(params)[0], f"w.{case}."))
        out[f"logits.{case}"], out[f"aux.{case}"] = (np.asarray(logits),
                                                     np.asarray(aux))


def reference_models(out: dict) -> None:
    mesh = _ref_mesh("a2a")
    for arch in GRAD_ARCHS:
        cfg = model_config(arch, None, ref_config)
        m = ref_build(cfg, ref_rules(mesh, cfg))
        params = m.init(jax.random.PRNGKey(0))
        toks = tokens_for(cfg, S + 1)["tokens"]
        batch = {"tokens": jnp.asarray(toks[:, :S]),
                 "targets": jnp.asarray(toks[:, 1:])}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            m.loss_fn, has_aux=True))(params, batch)
        out.update(flat(r_nn.split_params(params)[0], f"w.grad-{arch}."))
        out.update(flat(r_nn.split_params(grads)[0], f"g.grad-{arch}."))
        out[f"loss.grad-{arch}"] = np.asarray(loss)
    cases = [("serve-gemma-2b", "gemma-2b", (2, 2), False)] + [
        (f"long-{a}", a, (4, 1), True) for a in LONG_ARCHS]
    for case, arch, shape, long in cases:
        cfg = model_config(arch, None, ref_config)
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        m = ref_build(cfg, ref_rules(mesh, cfg, long_context=long),
                      remat=False, long_context=long)
        params = m.init(jax.random.PRNGKey(0))
        toks = jnp.asarray(tokens_for(cfg, PROMPT + STEPS)["tokens"])
        logits, caches, _ = jax.jit(m.prefill, static_argnums=2)(
            params, {"tokens": toks[:, :PROMPT]}, PROMPT + 8)
        seq = [logits]
        step = jax.jit(m.decode_step)
        for i in range(STEPS):
            logits, caches = step(params, caches,
                                  toks[:, PROMPT + i:PROMPT + i + 1],
                                  jnp.asarray(PROMPT + i, jnp.int32))
            seq.append(logits)
        out.update(flat(r_nn.split_params(params)[0], f"w.{case}."))
        out[f"logits.{case}"] = np.asarray(jnp.concatenate(seq, axis=1))


def reference_cli(base: Path) -> None:
    ck = base / "ref_ck"
    r = subprocess.run([sys.executable, "-m", "repro.launch.train", *CLI,
                        "--ckpt-dir", str(ck)], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    losses = {int(m[1]): float(m[2]) for m in re.finditer(
        r"^step (\d+) loss (\S+)", r.stdout, re.M)}
    (base / "cli.json").write_text(json.dumps(losses))


def _env() -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false",
            "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_reference")
    procs = [subprocess.Popen([sys.executable, __file__, str(base), part],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env())
             for part in ("layers", "fwd0", "fwd1", "cli")]
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
    out = {}
    for part in ("layers", "fwd0", "fwd1"):
        with np.load(base / f"{part}.npz") as z:
            out.update(z)
    return base, out


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------
def lanes(name: str):
    shape, axes, kw = MESHES[name]
    return make_mesh(shape, axes, devices="cpu"), kw


@pytest.mark.parametrize("mode,cf", MOE_CASES)
def test_moe_apply_on_a_mesh_matches_reference(reference, mode, cf):
    """The EP paths route each data shard's tokens with that shard's
    capacity, average ``aux`` over the data axes, and (2-D layout) sum the
    split expert ff dim after the down projection."""
    _, ref = reference
    case = f"moe-{mode}-{cf}"
    mesh, kw = lanes(mode)
    ctx = make_rules(mesh, get_config("kimi-k2-1t-a32b"), **kw)
    mod = p_moe.MoE(Init(torch.device("cpu")), MOE_D, moe_config(cf),
                    "swiglu", torch.float32)
    weights = {k.replace("/", "."): to_tensor(v) for k, v in
               flat(nest(ref, f"w.{case}."), "").items()}
    mod.load_state_dict(weights, strict=True)
    with torch.no_grad():
        y, aux = p_moe.moe_apply(mod, torch.from_numpy(ref["in.moe_x"]),
                                 moe_config(cf), "swiglu", ctx)
    np.testing.assert_allclose(y.numpy(), ref[f"y.{case}"], **F32,
                               err_msg=case)
    np.testing.assert_allclose(float(aux), float(ref[f"aux.{case}"]),
                               rtol=1e-6, err_msg=case)
    if cf == 1.0:  # tokens were dropped: no mesh routes them differently
        with torch.no_grad():
            y1, _ = p_moe.moe_apply(mod, torch.from_numpy(ref["in.moe_x"]),
                                    moe_config(cf), "swiglu")
        assert not np.allclose(y1.numpy(), ref[f"y.{case}"], **F32)


@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)], ids=["data4", "2x2"])
def test_flash_decode_sharded_matches_reference(reference, mesh_shape,
                                                kv_len):
    """Each data lane attends its slice of a 32-slot cache as one block;
    slots at or past ``kv_len`` hold random values and are masked.  At
    ``kv_len`` 17 for a query at position 20 the causal mask alone would
    let slots 17 to 20 in."""
    _, ref = reference
    mesh = make_mesh(mesh_shape, ("data", "model"), devices="cpu")
    ctx = make_rules(mesh, get_config("gemma-2b"), long_context=True)
    kv = torch.from_numpy(ref["in.kv"])
    got = p_att.flash_decode_sharded(torch.from_numpy(ref["in.q"]), kv[0],
                                     kv[1], kv_len, ctx, q_offset=20)
    name = "data4" if mesh_shape == (4, 1) else "2x2"
    np.testing.assert_allclose(got.numpy(), ref[f"decode.{name}.{kv_len}"],
                               **F32)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------
def port_model(ref: dict, case: str, cfg, ctx, **kw) -> Model:
    model = Model(cfg, ctx=ctx, remat=False, **kw)
    return load_reference_params(model, nest(ref, f"w.{case}."))


def torch_batch(batch: dict) -> dict:
    return {k: (torch.from_numpy(v).long() if k in ("tokens", "positions")
                else torch.from_numpy(v)) for k, v in batch.items()}


@pytest.mark.parametrize("case,arch,cf,kw", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_forward_on_2x2_matches_reference(reference, case, arch, cf, kw):
    _, ref = reference
    cfg = model_config(arch, cf)
    ctx = make_rules(make_mesh((2, 2), ("data", "model"), devices="cpu"),
                     cfg, **kw)
    model = port_model(ref, case, cfg, ctx)
    with torch.no_grad():
        logits, aux = model(torch_batch(tokens_for(cfg, S)))
    np.testing.assert_allclose(logits.numpy(), ref[f"logits.{case}"],
                               **MODEL_TOL, err_msg=case)
    np.testing.assert_allclose(float(aux), float(ref[f"aux.{case}"]),
                               rtol=1e-5, atol=1e-6, err_msg=case)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_on_2x2_match_reference(reference, arch):
    """The counterparts of the reference's
    test_model_train_step_dp_tp_matches_single_device and
    test_ep_modes_agree: the loss (aux term included) and every gradient
    of the a2a EP model on 2 x 2, with remat on."""
    _, ref = reference
    cfg = model_config(arch, None)
    ctx = make_rules(make_mesh((2, 2), ("data", "model"), devices="cpu"),
                     cfg)
    model = load_reference_params(Model(cfg, ctx=ctx),
                                  nest(ref, f"w.grad-{arch}."))
    toks = torch.from_numpy(tokens_for(cfg, S + 1)["tokens"]).long()
    loss, _ = model.loss_fn({"tokens": toks[:, :S], "targets": toks[:, 1:]})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(ref[f"loss.grad-{arch}"]),
                               rtol=GRAD_TOL)
    want = flat(nest(ref, f"g.grad-{arch}."), "")
    leaves = reference_leaves(model)
    assert {leaf.path for leaf in leaves} == set(want)
    for leaf in leaves:
        got = leaf.stack([t.grad for t in leaf.tensors]).numpy()
        w = want[leaf.path]
        np.testing.assert_allclose(
            got, w, rtol=GRAD_TOL,
            atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{arch} {leaf.path}")


@pytest.mark.parametrize("case", ["serve-gemma-2b"] +
                         [f"long-{a}" for a in LONG_ARCHS])
def test_prefill_and_decode_on_a_mesh_match_reference(reference, case):
    """gemma-2b on 2 x 2 (its KV head repeated to 2 in the caches), and
    long-context decode on (data 4, model 1): the caches' 24 slots split
    6 a lane, the last lane all empty at the first decode step."""
    _, ref = reference
    arch = case.split("-", 1)[1]
    long = case.startswith("long")
    cfg = model_config(arch, None)
    mesh = make_mesh((4, 1) if long else (2, 2), ("data", "model"),
                     devices="cpu")
    ctx = make_rules(mesh, cfg, long_context=long)
    model = port_model(ref, case, cfg, ctx, long_context=long)
    toks = torch.from_numpy(tokens_for(cfg, PROMPT + STEPS)["tokens"]).long()
    with torch.no_grad():
        logits, caches, _ = model.prefill({"tokens": toks[:, :PROMPT]},
                                          cache_len=PROMPT + 8)
        seq = [logits]
        for i in range(STEPS):
            logits, caches = model.decode_step(
                caches, toks[:, PROMPT + i:PROMPT + i + 1], PROMPT + i)
            seq.append(logits)
    if not long:  # gemma-2b's one KV head, repeated for model = 2
        assert caches[0]["attn"]["k"].shape[2] == 2
    np.testing.assert_allclose(torch.cat(seq, 1).numpy(),
                               ref[f"logits.{case}"], **MODEL_TOL,
                               err_msg=case)


def test_train_cli_on_a_mesh_matches_reference(reference, tmp_path):
    """``python -m repro_torch.launch.train --mesh 2x2 --device cpu``
    resumes the reference CLI's step-3 checkpoint (written on its 2 x 2
    mesh) and logs the reference's losses for steps 4 to 6."""
    base, _ = reference
    want = {int(k): v for k, v in json.loads(
        (base / "cli.json").read_text()).items()}
    assert sorted(want) == [1, 2, 3, 4, 5, 6]
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copy(base / "ref_ck" / "step_00000003.npz", ck)
    (ck / "latest.json").write_text(json.dumps({"step": 3}))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *CLI, "--ckpt-dir", str(ck), "--resume", "--device",
                        "cpu"], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    assert "resumed from step 3" in r.stdout
    got = {int(m[1]): float(m[2]) for m in re.finditer(
        r"^step (\d+) loss (\S+)", r.stdout, re.M)}
    assert sorted(got) == [4, 5, 6]
    for step, loss in got.items():
        assert abs(loss - want[step]) <= CLI_RTOL * abs(want[step]) + 5e-5, (
            step, loss, want[step])
    assert want[6] < want[1]


if __name__ == "__main__":
    out_dir, part = Path(sys.argv[1]), sys.argv[2]
    if part == "cli":
        reference_cli(out_dir)
    else:
        result: dict = {}
        if part == "layers":
            reference_layers(result)
            reference_models(result)
        else:
            reference_forwards(result, FWD_CASES[int(part[-1])::2])
        np.savez(out_dir / f"{part}.npz", **result)
