"""The port's dry run (``repro_torch.launch.dryrun``) held against the
reference's (``repro.launch.dryrun``).

One reference subprocess with 8 forced host devices computes every
reference number this file needs (a module-scoped fixture holds them):
the pure helpers for all ten archs at full size, the reduced configs'
``init_cache`` shapes and dtypes, and XLA's ``memory_analysis``, its
input/output shardings and alias table, and the matmul FLOPs of the
reduced cells of ``tests/test_dryrun_small.py`` on a (2 x 2) mesh and its
(2 x 2 x 2) pod cell, the ``long_500k`` cells and one MoE cell.  The
reference's FLOPs are taken from its ``unroll=True`` program, the one its
delta method reads (its ``unroll=False`` program counts each scanned
layer group once); the memory does not depend on ``unroll``.

The port traces the same cells on ``meta`` lanes.  What is held, each
difference named and held to its exact count:

* ``argument_size_in_bytes`` exactly, but for one leaf the port counts and
  XLA drops: the decode ``pos`` (int32, 4 bytes) of an arch that never
  reads it (xLSTM has no attention), which ``jax.jit`` prunes as an
  unused argument;
* ``alias_size_in_bytes``: the port's is every donated input (the train
  state, the decode caches) as the reference's ``in_shardings`` cut them.
  XLA's is the outputs its alias table pairs with a donated buffer: its
  sharding propagation lays some outputs out otherwise than their inputs
  (the attention's ``wv`` and its optimizer state, split over 'model'
  too; a decode step's recurrent and convolution states), and those it
  leaves unpaired;
* ``output_size_in_bytes``: the port's keeps each donated leaf at its
  input's layout, plus the other outputs (metrics, logits), which equal
  XLA's; XLA's is its outputs at its own layouts plus an 8-byte entry a
  leaf of the output tuple's index table;
* FLOPs exactly against the reference's matmul FLOPs, counted over the
  jaxpr of the step it lowers (``dot_general`` and
  ``conv_general_dilated``: 2 x the output's elements x the contracted
  size, through nested calls, a ``scan`` body times its length and a
  ``shard_map`` body times its manual lanes), the ops
  ``FlopCounterMode`` counts: the port's ``flops_global`` (one lane's
  step, traced, times the lanes) equals it exactly, the Mamba and xLSTM
  blocks included (tensor parallel over 'model', each product computed
  once over the lanes);
* all-to-all bytes: the Mamba and mLSTM blocks' regrouping all-to-alls
  (labelled ``nn.RECURRENT``) equal a hand count, and so do the MoE
  layers' ``dist.spmd.all_to_all`` bytes, the rest.  The reference's are
  twice the MoE's plus a constant: XLA's
  CPU backend moves a bfloat16 all-to-all as float32 (a convert before
  and after it in the HLO), and its partitioner adds resharding
  all-to-alls of its own (131,072 bytes on the train cells, 1,024 on the
  decode cells, as on the cells with no MoE layer), which the port never
  runs.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import spmd
from repro_torch.dist.context import DuplicateSpecError, NamedSharding, P
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import (analyze, cfg_with_repeat,
                                       extrapolate, full_repeat,
                                       param_counts, slstm_flops_correction,
                                       trace_cell)
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import xlstm
from repro_torch.models.model import Model
from repro_torch.models.moe import capacity_of

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")

CELLS = [("stablelm-1.6b", "train_4k"), ("mixtral-8x22b", "train_4k"),
         ("jamba-v0.1-52b", "decode_32k"), ("xlstm-1.3b", "decode_32k")]
POD_CELL = ("stablelm-1.6b", "train_4k")
# the Adafactor state (factored second moments), as the MoE archs with 64
# experts or more train
ADA_CELL = ("kimi-k2-1t-a32b", "train_4k")
LONG_ARCHS = ("jamba-v0.1-52b", "mixtral-8x22b", "starcoder2-7b",
              "xlstm-1.3b")
# reduced mixtral, train, 32 x 64 tokens: expert parallel on 2 x 2 only
TWO_MESH_BATCH, TWO_MESH_SEQ = 32, 64

_REFERENCE = r"""
import dataclasses, json, math, re, sys
import jax
from repro.configs import get_config, ARCH_IDS
from repro.launch import dryrun as d
from repro.launch.shapes import SHAPES
from repro.models.model import build_model
from repro.models.xlstm import slstm_step_flops

def matmul_flops(jaxpr, mult=1):
    '''dot_general and conv_general_dilated FLOPs of a jaxpr, nested
    calls included; a scan body counts length times, a shard_map body
    once a manual lane; a while or cond (unknown trips) raises.'''
    total = 0
    for eqn in jaxpr.eqns:
        name, prm = eqn.primitive.name, eqn.params
        out = eqn.outvars[0].aval.shape if eqn.outvars else ()
        if name == "dot_general":
            (lc, _), _ = prm["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += mult * 2 * math.prod(out) * math.prod(lhs[i] for i in lc)
        elif name == "conv_general_dilated":
            rhs, spec = eqn.invars[1].aval.shape, prm["dimension_numbers"].rhs_spec
            total += mult * 2 * math.prod(out) * math.prod(
                rhs[i] for i in spec[1:])
        elif name in ("while", "cond"):
            raise NotImplementedError(name)
        if name == "scan":
            total += matmul_flops(prm["jaxpr"].jaxpr, mult * prm["length"])
        elif name == "shard_map":
            lanes = math.prod(prm["mesh"].shape[a] for a in prm["manual_axes"])
            total += matmul_flops(prm["jaxpr"], mult * lanes)
        else:
            for v in prm.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    total += matmul_flops(sub, mult)
    return total

def mem_detail(low, comp):
    '''What XLA's memory_analysis is made of, per device: the donated
    inputs at their in_shardings; its outputs at its own out_shardings,
    split into those with a donated input's path (kept at its size or
    re-sharded) and the rest; the outputs its alias table pairs.'''
    ks = jax.tree_util.keystr
    def nb(aval, sh):
        return math.prod(sh.shard_shape(aval.shape)) * aval.dtype.itemsize
    ins = [(ks(p), a, s) for (p, s), a in zip(
        jax.tree_util.tree_leaves_with_path(comp.input_shardings[0]),
        jax.tree_util.tree_leaves(low.args_info[0]))]
    donated = {k: nb(a, s) for k, a, s in ins if a.donated}
    outs = [(ks(p), a, s) for (p, s), a in zip(
        jax.tree_util.tree_leaves_with_path(comp.output_shardings),
        jax.tree_util.tree_leaves(low.out_info))]
    head = comp.as_text().split("\n", 1)[0]
    paired = {int(o) for o in re.findall(r"\{(\d+)\}: \(\d+, \{\}, may-alias\)",
                                         head)}
    out = {"donated": sum(donated.values()), "n_out": len(outs),
           "out_xla": 0, "other_out": 0, "paired_out": 0, "resharded": []}
    for i, (k, a, s) in enumerate(outs):
        b = nb(a, s)
        out["out_xla"] += b
        out["paired_out"] += b if i in paired else 0
        if k not in donated:
            out["other_out"] += b
        elif b != donated[k]:
            out["resharded"].append(k)
    return out

# the step lower_cell jits, and its abstract arguments
captured = {}
_jit = jax.jit
class _Capture:
    def __init__(self, f, jitted):
        self.f, self.jitted = f, jitted
    def lower(self, *args):
        captured["f"], captured["args"] = self.f, args
        return self.jitted.lower(*args)
def _capturing_jit(f, **kw):
    jitted = _jit(f, **kw)
    return _Capture(f, jitted) if "in_shardings" in kw else jitted
d.jax.jit = _capturing_jit

CELLS = %(cells)r
POD = %(pod)r
ADA = %(ada)r
LONG = %(long)r
out = {"archs": {}, "caches": {}, "cells": {}, "long": {},
       "two_mesh": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    reps = {}
    for r in (1, 2, 3):
        c = d.cfg_with_repeat(cfg, r)
        reps[r] = [c.num_layers, c.encoder_layers]
    out["archs"][arch] = {
        "param_counts": d.param_counts(build_model(cfg)),
        "repeat": reps, "full_repeat": d.full_repeat(cfg),
        "slstm": {s: d.slstm_flops_correction(cfg, SHAPES[s])
                  for s in SHAPES},
        "step_flops": slstm_step_flops(cfg.d_model, cfg.num_heads),
    }
    caches = jax.eval_shape(lambda: build_model(cfg.reduced()).init_cache(2, 24))
    out["caches"][arch] = {
        "/".join(k.key for k in p): [list(a.shape), str(a.dtype)]
        for p, a in jax.tree_util.tree_leaves_with_path(caches)}

def mesh(shape, axes):
    return jax.make_mesh(shape, axes, devices=jax.devices()[:len(axes) and
                         __import__("math").prod(shape)],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))

def cell(arch, shape, m, seq=64, batch=8, opt="adamw"):
    cfg = get_config(arch).reduced()
    shp = dataclasses.replace(SHAPES[shape], seq_len=seq, global_batch=batch)
    try:
        _, low = d.lower_cell(cfg, shp, m, unroll=True, opt_name=opt)
        comp = low.compile()
        rec = d.analyze_compiled(comp)
    except Exception as e:
        return {"ok": False, "error": type(e).__name__}
    jaxpr = jax.make_jaxpr(captured["f"])(*captured["args"]).jaxpr
    return {"ok": True, "memory": rec["memory"],
            "memory_detail": mem_detail(low, comp),
            "collectives": rec["collectives"],
            "matmul_flops": matmul_flops(jaxpr)}

m22 = mesh((2, 2), ("data", "model"))
for arch, shape in CELLS:
    out["cells"][arch + "/" + shape] = cell(arch, shape, m22)
out["cells"]["adafactor"] = cell(ADA[0], ADA[1], m22, opt="adafactor")
out["cells"]["pod"] = cell(POD[0], POD[1],
                           mesh((2, 2, 2), ("pod", "data", "model")),
                           seq=32)
for arch in LONG:
    for b in (1, 2):
        out["long"][arch + "/" + str(b)] = cell(arch, "long_500k", m22,
                                                batch=b)
out["two_mesh"]["2x2"] = cell("mixtral-8x22b", "train_4k", m22,
                              seq=%(seq)d, batch=%(batch)d)
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    code = _REFERENCE % {"cells": CELLS, "pod": POD_CELL, "ada": ADA_CELL,
                         "long": LONG_ARCHS, "seq": TWO_MESH_SEQ,
                         "batch": TWO_MESH_BATCH}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


def small(shape_name: str, seq: int = 64, batch: int = 8):
    return dataclasses.replace(SHAPES[shape_name], seq_len=seq,
                               global_batch=batch)


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices="cpu")


def xla_arguments(arch: str, shape, want: dict) -> int:
    """XLA's argument bytes of a cell, plus the decode ``pos`` (int32) of
    xLSTM, which never reads it: ``jax.jit`` prunes an unused argument,
    the port counts every input."""
    pruned = 4 if arch == "xlstm-1.3b" and shape.kind == "decode" else 0
    return want["memory"]["argument_size_in_bytes"] + pruned


def assert_memory_matches(rec: dict, want: dict, arch: str, shape) -> None:
    """The port's per-lane argument, alias and output bytes against XLA's
    ``memory_analysis``, each difference by its named cause (the module
    docstring)."""
    mem, xla, det = rec["memory"], want["memory"], want["memory_detail"]
    assert mem["argument_size_in_bytes"] == xla_arguments(arch, shape, want)
    # the port aliases every donated input; XLA the outputs it pairs
    assert mem["alias_size_in_bytes"] == det["donated"]
    assert xla["alias_size_in_bytes"] == det["paired_out"]
    # the port keeps the donated leaves' layout; XLA re-shards the listed
    # ones, and counts its output tuple's index table
    assert mem["output_size_in_bytes"] == det["donated"] + det["other_out"]
    assert xla["output_size_in_bytes"] == det["out_xla"] + 8 * det["n_out"]
    if mem["alias_size_in_bytes"] != xla["alias_size_in_bytes"]:
        assert det["resharded"], det
    print(f"{arch} {shape.name}: alias port {mem['alias_size_in_bytes']}, "
          f"XLA {xla['alias_size_in_bytes']}; output port "
          f"{mem['output_size_in_bytes']}, XLA "
          f"{xla['output_size_in_bytes']}; XLA re-shards "
          f"{det['resharded']}")
    # a mesh cell's temp is one lane's peak (see ``analyze``); XLA's
    # buffer assignment reuses and fuses, so the two are not compared
    assert mem["temp_size_in_bytes"] > 0 and "temp_size_note" not in mem
    print(f"{arch} {shape.name}: temp a lane, port "
          f"{mem['temp_size_in_bytes']}, XLA {xla['temp_size_in_bytes']}")


# --------------------------------------------------------------------------
# the pure helpers, all ten archs at full size
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pure_helpers_match_reference(ref, arch):
    want = ref["archs"][arch]
    cfg = get_config(arch)
    assert param_counts(Model(cfg, device="meta")) == want["param_counts"]
    for r in (1, 2, 3):
        c = cfg_with_repeat(cfg, r)
        assert [c.num_layers, c.encoder_layers] == want["repeat"][str(r)]
    assert full_repeat(cfg) == want["full_repeat"]
    for s in SHAPES:
        assert slstm_flops_correction(cfg, SHAPES[s]) == want["slstm"][s]
    assert xlstm.slstm_step_flops(cfg.d_model, cfg.num_heads) == \
        want["step_flops"]


def test_shard_shape_matches_jax():
    """``NamedSharding.shard_shape`` against jax's on the same meshes,
    divisible dims and not (jax raises ``ValueError``)."""
    import jax
    from jax.sharding import NamedSharding as JaxSharding
    from jax.sharding import PartitionSpec as JaxP

    jm = jax.sharding.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    m = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    specs = [(), ("data",), ("data", "model"), (None, "model"),
             (("pod", "data"), None, "model"), (("pod", "data", "model"),)]
    shapes = [(8, 4, 6), (4, 2, 2), (6, 8, 2), (2, 3, 4), (1, 4, 4),
              (16, 2, 2)]
    for spec in specs:
        for shape in shapes:
            try:
                want = JaxSharding(jm, JaxP(*spec)).shard_shape(shape)
            except ValueError:
                with pytest.raises(ValueError):
                    NamedSharding(m, P(*spec)).shard_shape(shape)
                continue
            assert NamedSharding(m, P(*spec)).shard_shape(shape) == want, \
                (spec, shape)
    with pytest.raises(DuplicateSpecError):
        NamedSharding(m, P("data", "data"))


# --------------------------------------------------------------------------
# the reduced cells on the small meshes
# --------------------------------------------------------------------------
def _a2a_by_hand(arch: str, shape, mesh_shape) -> int:
    """The MoE layers' all-to-all bytes a lane receives: two calls a layer
    a pass ([E, C, d] in, then back) of the local tokens' capacity slots;
    a train step runs the forward, its remat recompute and the backward
    (the gradients' transposes)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is None or cfg.moe.num_experts % mesh_shape[-1]:
        return 0
    dp = math.prod(mesh_shape[:-1])
    T = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    cap = capacity_of(cfg.moe, T // dp)
    n_moe = sum(1 for block in Model(cfg, device="meta").layers
                if block.desc[1] == "moe")
    passes = 3 if shape.kind == "train" else 1
    return 2 * passes * n_moe * cfg.moe.num_experts * cap * cfg.d_model * 2


def _regroup_a2a_by_hand(arch: str, shape, mesh_shape) -> int:
    """The Mamba and mLSTM blocks' all-to-all bytes a lane receives
    (``nn.RECURRENT``): with two 'model' lanes, one a layer a pass,
    regrouping ``in_proj``'s or ``up``'s output [B_local, S, 2 di / tp]
    to each lane's channels of both halves (the sLSTM's ``up`` output,
    whose halves the lanes do not split, is gathered instead)."""
    cfg = get_config(arch).reduced()
    tp = mesh_shape[-1]
    if tp != 2 or shape.kind != "decode":
        return 0
    dp = math.prod(mesh_shape[:-1])
    n = 0
    for block in Model(cfg, device="meta").layers:
        mixer = block.desc[0]
        if mixer == "mamba":
            n += block.mamba.in_proj.shape[1]
        elif mixer == "mlstm":
            n += block.mlstm.up.shape[1]
    return shape.global_batch // dp * n // tp * 2


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_reduced_cell_matches_reference(ref, arch, shape_name):
    want = ref["cells"][f"{arch}/{shape_name}"]
    assert want["ok"]
    cfg = get_config(arch).reduced()
    shape = small(shape_name)
    traced = trace_cell(cfg, shape, cpu_mesh((2, 2)), unroll=False,
                        opt_name="adamw")
    rec = analyze(traced)
    assert_memory_matches(rec, want, arch, shape)
    assert rec["flops_global"] == want["matmul_flops"]
    assert rec["flops"] == rec["flops_global"] / 4
    regroup = sum(v for k, v in traced.labelled.items()
                  if k.startswith("all-to-all:"))
    assert regroup == _regroup_a2a_by_hand(arch, shape, (2, 2))
    a2a = rec["collectives"].get("all-to-all", 0) - regroup
    want_a2a = want["collectives"].get("all-to-all", 0)
    assert a2a == _a2a_by_hand(arch, shape, (2, 2))
    # float32 on XLA's CPU backend, and its own resharding all-to-alls on
    # top (see the module doc)
    assert want_a2a == 2 * a2a + (131072 if shape.kind == "train" else 1024)


def test_pod_mesh_cell_matches_reference(ref):
    want = ref["cells"]["pod"]
    assert want["ok"]
    arch, shape_name = POD_CELL
    rec = analyze(trace_cell(get_config(arch).reduced(),
                             small(shape_name, seq=32), cpu_mesh(
                                 (2, 2, 2), ("pod", "data", "model")),
                             unroll=False, opt_name="adamw"))
    assert rec["lanes"] == 8
    assert_memory_matches(rec, want, arch, small(shape_name, seq=32))
    assert rec["flops_global"] == want["matmul_flops"]


def test_adafactor_cell_matches_reference(ref):
    """kimi-k2 reduced with Adafactor on (2 x 2): the factored state's
    leaves get the reference's shardings (``_state_entries``)."""
    want = ref["cells"]["adafactor"]
    assert want["ok"]
    arch, shape_name = ADA_CELL
    shape = small(shape_name)
    rec = analyze(trace_cell(get_config(arch).reduced(), shape,
                             cpu_mesh((2, 2)), unroll=False,
                             opt_name="adafactor"))
    assert_memory_matches(rec, want, arch, shape)
    assert rec["flops_global"] == want["matmul_flops"]


@pytest.mark.parametrize("arch", LONG_ARCHS)
@pytest.mark.parametrize("batch", [1, 2])
def test_long_500k_cells_fail_as_the_reference(ref, arch, batch):
    """With ``long_context``, "batch" and "kv_seq" both map to 'data': an
    attention cache leaf of an arch without a sliding window (jamba) gets
    'data' twice (``DuplicateSpecError``); a batch of 1 that 'data' does
    not divide is refused (``ValueError``); else the cell builds (and its
    argument bytes equal XLA's: the ring buffers' int32 positions)."""
    want = ref["long"][f"{arch}/{batch}"]
    cfg = get_config(arch).reduced()
    try:
        rec = analyze(trace_cell(cfg, small("long_500k", batch=batch),
                                 cpu_mesh((2, 2)), unroll=False,
                                 opt_name="adamw"))
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        assert not want["ok"] and type(e).__name__ == want["error"], \
            (type(e).__name__, want)
        return
    assert want["ok"], want
    assert rec["memory"]["argument_size_in_bytes"] == \
        xla_arguments(arch, small("long_500k", batch=batch), want)


def test_moe_cell_on_two_meshes(ref):
    """Reduced mixtral (4 experts) at 32 x 64 tokens on a (2 x 2) mesh, on
    16 x 16 and on (1 x 8), its MoE layers' forward FLOPs a lane by hand.
    On 2 x 2 the 4 experts split over the 2 'model' lanes (expert
    parallel): a lane routes its data shard's 1,024 tokens and runs its 2
    experts' capacity slots of both lanes of its row (capacity from the
    data shard's tokens, 1,024 x 2 x 8 / 4 slots an expert).  On 16 x 16
    and on (1 x 8), 16 and 8 do not divide 4: the MoE runs its local path
    on every lane, over all 2,048 tokens gathered from the data lanes
    with the global capacity (the reference's program), so a lane's MoE
    FLOPs are those of the whole layer on both meshes.  The train step on
    2 x 2 equals the reference's FLOPs on the same mesh."""
    from repro_torch.models import model as model_mod

    cfg = get_config("mixtral-8x22b").reduced()
    train = small("train_4k", seq=TWO_MESH_SEQ, batch=TWO_MESH_BATCH)
    serve = small("prefill_32k", seq=TWO_MESH_SEQ, batch=TWO_MESH_BATCH)
    moe = cfg.moe
    T = serve.global_batch * serve.seq_len
    d, f, E = cfg.d_model, moe.d_ff_expert, moe.num_experts
    n_moe = cfg.num_layers
    slots = 3 * 2 * d * f  # gate, up and down a slot
    ep_lane = 2 * (T // 2) * d * E + E * capacity_of(moe, T // 2) * slots
    local = 2 * T * d * E + E * capacity_of(moe, T) * slots
    moe_flops = [0]
    real = model_mod.moe_lanes

    def counted(*a, **kw):
        with FlopCounterMode(display=False) as fc:
            out = real(*a, **kw)
        moe_flops[0] += fc.get_total_flops()
        return out
    model_mod.moe_lanes = counted
    try:
        for mesh, want in ((cpu_mesh((2, 2)), ep_lane),
                           (make_production_mesh(), local),
                           (cpu_mesh((1, 8)), local)):
            moe_flops[0] = 0
            trace_cell(cfg, serve, mesh, unroll=False, opt_name="adamw")
            assert moe_flops[0] == n_moe * want, (mesh, moe_flops, want)
    finally:
        model_mod.moe_lanes = real
    flops = analyze(trace_cell(cfg, train, cpu_mesh((2, 2)), unroll=False,
                               opt_name="adamw"))["flops_global"]
    print(f"GFLOP a step on 2x2: {flops / 1e9:.2f}; MoE GFLOP a lane a "
          f"forward: 2x2 {n_moe * ep_lane / 1e9:.3f}, 16x16 and 1x8 "
          f"{n_moe * local / 1e9:.3f}")
    assert flops == ref["two_mesh"]["2x2"]["matmul_flops"]


# --------------------------------------------------------------------------
# the delta method, the collective counter, the sLSTM count
# --------------------------------------------------------------------------
def test_delta_extrapolation_equals_direct_count():
    base = get_config("mixtral-8x22b").reduced()
    shape = small("train_4k", seq=32)
    mesh = cpu_mesh((2, 2))
    R = 4
    recs = {r: analyze(trace_cell(cfg_with_repeat(base, r), shape, mesh,
                                  unroll=True, opt_name="adamw"))
            for r in (1, 2, R)}
    for key in ("flops", "bytes_accessed"):
        assert extrapolate(recs[1][key], recs[2][key], R) == recs[R][key]
    inputs = dryrun.roofline_inputs({1: recs[1], 2: recs[2]}, R)
    assert inputs["collective_bytes_per_device"] == recs[R]["collectives"]


def test_roofline_collective_time_holds_both_parts():
    """``collective_s`` is the collectives the port runs (``dist.spmd``)
    over the assumed link rate, and ``collective_bytes_per_device`` their
    bytes by kind at the full depth.  gemma-2b reduced, a train step on
    (2 x 2): both parts of its collective time, the FSDP weights'
    all-gathers and their gradients' reduce-scatters and the tensor
    parallelism's and gradients' all-reduces, are in it; the all-gathers
    and reduce-scatters are ``derived_collectives``' rule exactly (the
    case where leaving them out would misstate the bottleneck)."""
    from repro_torch.dist.context import make_rules
    from repro_torch.models.convert import reference_leaves

    cfg = get_config("gemma-2b").reduced()
    shape = small("train_4k", seq=32)
    mesh = cpu_mesh((2, 2))
    deltas = {r: analyze(trace_cell(cfg_with_repeat(cfg, r), shape, mesh,
                                    unroll=True, opt_name="adamw"))
              for r in (1, 2)}
    R = full_repeat(cfg)
    inputs = dryrun.roofline_inputs(deltas, R)
    colls = inputs["collective_bytes_per_device"]
    ctx = make_rules(dryrun._meta_mesh(mesh), cfg)
    derived = dryrun.derived_collectives(
        reference_leaves(Model(cfg, ctx=ctx, device="meta")), ctx, True)
    assert derived["all-gather"] > 0 and derived["reduce-scatter"] > 0
    for kind in ("all-gather", "reduce-scatter"):
        assert colls[kind] == derived[kind], kind
    assert colls["all-reduce"] > 0
    counts = param_counts(Model(cfg, device="meta"))
    roof = dryrun.roofline(inputs, counts, shape, 4)
    assert roof["collective_s"] == sum(colls.values()) / dryrun.LINK_BW
    assert roof["collective_s"] > \
        (colls["all-gather"] + colls["reduce-scatter"]) / dryrun.LINK_BW
    assert roof["link_bw_assumed"] is True
    assert roof["bottleneck"] == max(
        ("compute_s", "memory_s", "collective_s"), key=roof.get)


def test_derived_collectives_by_hand():
    """``derived_collectives``' rule on one leaf of each kind, gemma-2b
    reduced on (2 x 2): the FSDP-split embedding all-gathered twice and
    reduce-scattered in a train step, once gathered in a serving step; a
    replicated norm's gradient all-reduced over the 2 data lanes."""
    from repro_torch.dist.context import make_rules
    from repro_torch.models.convert import reference_leaves
    cfg = get_config("gemma-2b").reduced()
    mesh = dryrun._meta_mesh(cpu_mesh((2, 2)))
    ctx = make_rules(mesh, cfg)
    leaves = {leaf.path: leaf for leaf in
              reference_leaves(Model(cfg, ctx=ctx, device="meta"))}
    embed, norm = leaves["embed"], leaves["norm_f/gamma"]
    assert tuple(ctx.param_sharding(embed).spec) == ("model", "data")
    assert tuple(ctx.param_sharding(norm).spec) in ((), (None,))
    e = math.prod(embed.shape) * embed.dtype.itemsize
    n = math.prod(norm.shape) * norm.dtype.itemsize
    assert dryrun.derived_collectives([embed], ctx, True) == \
        {"all-gather": 2 * e // 2, "reduce-scatter": e // 4}
    assert dryrun.derived_collectives([embed], ctx, False) == \
        {"all-gather": e // 2}
    assert dryrun.derived_collectives([norm], ctx, True) == \
        {"all-reduce": n}
    assert dryrun.derived_collectives([norm], ctx, False) == {}


def test_collective_counter_known_program():
    """psum of [1024] float32 and all_to_all of [8, 128] float32 a lane on
    an (8,) mesh of CPU lanes: 4,096 and 4,096 bytes a lane; pmean is its
    psum once; the backward adds each one's transpose; nothing is recorded
    (and no hook is set) outside the block."""
    mesh = make_mesh((8,), ("d",), devices="cpu")
    x = torch.zeros(8 * 1024, requires_grad=True)
    y = torch.zeros(8 * 8, 128)
    with spmd.count_collectives() as counts:
        s = spmd.psum(spmd.shard(x, P("d"), mesh), "d", mesh)
        a = spmd.all_to_all(spmd.shard(y, P("d"), mesh), "d", 0, 0, mesh)
    assert counts == {"all-reduce": 1024 * 4, "all-to-all": 8 * 128 * 4}
    with spmd.count_collectives() as counts:
        spmd.pmean(spmd.shard(y, P("d"), mesh), "d", mesh)
    assert counts == {"all-reduce": 8 * 128 * 4}
    with spmd.count_collectives() as counts:
        s = spmd.psum(spmd.shard(x, P("d"), mesh), "d", mesh)
        sum(t.sum() for t in s.flat).backward()
    assert counts == {"all-reduce": 2 * 1024 * 4}
    s = spmd.psum(spmd.shard(x, P("d"), mesh), "d", mesh)
    assert s.flat[0]._backward_hooks is None
    assert spmd._counts.get() is None and a.shape == (8,)


def test_slstm_recurrence_counted_once(monkeypatch):
    """The sLSTM recurrence's matvec is in the count once a pass, every
    step (no ``slstm_flops_correction`` on top), and the count is linear
    in S."""
    cfg = get_config("xlstm-1.3b").reduced()
    n_slstm = cfg.num_layers // cfg.xlstm.slstm_every
    dh = cfg.d_model // cfg.num_heads
    matvec = 2 * cfg.num_heads * dh * 4 * dh  # a token, a layer

    def count(shape):
        return trace_cell(cfg, shape, None, unroll=False,
                          opt_name="adamw").flops

    full = {s: count(small("prefill_32k", seq=s, batch=2))
            for s in (32, 64, 96)}
    train = count(small("train_4k", seq=32, batch=2))
    # linear in S (the last position's unembedding is the constant term)
    assert full[96] - full[64] == full[64] - full[32]
    with FlopCounterMode(display=False) as fc:  # one step: B matvecs
        B, d = 2, cfg.d_model
        xlstm._slstm_step(torch.zeros(B, 4, d, device="meta"),
                          torch.zeros(cfg.num_heads, dh, 4, dh,
                                      device="meta"),
                          xlstm.init_slstm_state(B, d, "meta"),
                          cfg.num_heads)
    assert fc.get_total_flops() == B * matvec
    monkeypatch.setattr(
        xlstm, "_slstm_step",
        lambda xproj, r, state, num_heads: _step_without_matvec(
            xproj, state, num_heads))
    without = count(small("prefill_32k", seq=32, batch=2))
    without_train = count(small("train_4k", seq=32, batch=2))
    assert full[32] - without == n_slstm * 32 * 2 * matvec
    # train: forward, remat recompute, and the backward's two products,
    # but for the first step's product into the initial state (a constant)
    assert train - without_train == n_slstm * (4 * 32 - 1) * 2 * matvec
    # and the record's total adds no analytic correction on top
    shape = small("prefill_32k", seq=32, batch=2)
    deltas = {r: analyze(trace_cell(cfg_with_repeat(cfg, r), shape, None,
                                    unroll=True, opt_name="adamw"))
              for r in (1, 2)}
    R = full_repeat(cfg)
    assert dryrun.roofline_inputs(deltas, R)["hlo_flops_per_device"] == \
        extrapolate(deltas[1]["flops"], deltas[2]["flops"], R)
    assert slstm_flops_correction(cfg, shape) > 0


def _step_without_matvec(xproj, state, num_heads):
    """``xlstm._slstm_step`` with the recurrent matvec's result replaced by
    zeros of its shape (no FLOPs counted)."""
    B, _, d = xproj.shape
    dh = d // num_heads
    r = torch.zeros(num_heads, dh, 4, dh, dtype=xproj.dtype,
                    device=xproj.device)
    rec = torch.zeros(B, 4, d, dtype=r.dtype, device=xproj.device)
    gates = xproj.float() + rec.float()
    li, lf, z, o = gates[:, 0], gates[:, 1], gates[:, 2], gates[:, 3]
    lf = torch.nn.functional.logsigmoid(lf)
    m_new = torch.maximum(lf + state["m"], li)
    f = torch.exp(lf + state["m"] - m_new)
    i = torch.exp(li - m_new)
    c_new = f * state["c"] + i * torch.tanh(z)
    n_new = f * state["n"] + i
    h_new = torch.sigmoid(o) * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def test_dense_flops_equal_an_analytic_matmul_count():
    """A reduced stablelm prefill with no mesh: 2 M N K over the q, k, v
    and o projections, the scores and the values (one KV block: S <= 512),
    the FFN's up, gate and down, and the last position's unembedding."""
    cfg = get_config("stablelm-1.6b").reduced()
    B, S = 2, 64
    rec = analyze(trace_cell(cfg, small("prefill_32k", seq=S, batch=B),
                             None, unroll=False, opt_name="adamw"))
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim, cfg.d_ff)
    T = B * S
    V = Model(cfg, device="meta").embed.shape[0]
    ffn = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    layer = (2 * T * d * (H + 2 * K) * hd + 2 * T * H * hd * d
             + 2 * (2 * B * H * S * S * hd) + ffn * 2 * T * d * f)
    want = cfg.num_layers * layer + 2 * B * d * V
    assert rec["flops"] == want and rec["lanes"] == 1


def test_meta_trace_counts_a_real_step():
    """The meta trace's FLOPs and argument bytes equal ``FlopCounterMode``
    over one real train step on the CPU and the bytes of its real state
    and batch (the check ``chip_smoke.py`` repeats on the card at
    gemma-2b's full width)."""
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.train import OptConfig, make_init_state, make_train_step
    from repro_torch.train.data import SyntheticLM

    cfg = get_config("gemma-2b").reduced()
    B, S = 2, 32
    traced = analyze(trace_cell(cfg, ShapeSpec("t", "train", S, B), None,
                                unroll=False, opt_name="adamw"))
    model = Model(cfg, device="cpu", seed=0)
    opt = OptConfig()
    state = make_init_state(model, opt)()
    step = make_train_step(model, opt)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, S, B).get_batch(0).items()}
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert traced["flops"] == fc.get_total_flops()
    # one lane: the tracked peak is the lane's temp
    assert traced["memory"]["temp_size_in_bytes"] > 0
    assert "temp_size_note" not in traced["memory"]
    tensors = ([t for leaf in state.params for t in leaf.tensors]
               + [state.opt["step"], state.step] + list(batch.values())
               + [t for st in state.opt["ema"].values() for t in st.values()])
    real = sum(t.numel() * t.element_size() for t in tensors)
    assert traced["memory"]["argument_size_in_bytes"] == real


def test_mrope_sections_fixed_shape():
    """M-RoPE at qwen2-vl reduced's head dim and theta, with the section
    ids' ``repeat_interleave`` given a fixed ``output_size``: the same
    values as the data-dependent ``repeat_interleave`` gives, and the op
    runs on ``meta`` tensors (no value is read back)."""
    from repro_torch.models.attention import apply_rope, mrope_sections
    cfg = get_config("qwen2-vl-72b").reduced()
    hd = cfg.resolved_head_dim
    sec = mrope_sections(hd)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, hd)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 50, (2, 5, 3)))
    got = apply_rope(x, pos, fraction=1.0, theta=cfg.rope_theta,
                     mrope_sections=sec)
    sec_id = torch.repeat_interleave(torch.arange(3), torch.tensor(sec))
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    ang = pos[..., sec_id].float() * inv
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    assert torch.equal(got, want)
    meta = apply_rope(x.to("meta"), pos.to("meta"), fraction=1.0,
                      theta=cfg.rope_theta, mrope_sections=sec)
    assert meta.shape == x.shape and meta.device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_leaves_match_reference_init_cache(ref, arch):
    """Every cache leaf of the reduced config, shape and dtype, equals the
    reference's ``init_cache`` (B = 2, 24 slots): the port's one dict a
    layer stacked as the reference's layer groups stack them.  The
    sliding-window ring's ``pos`` is int32 in both."""
    from repro_torch.launch.shapes import _leaves
    from repro_torch.models.model import layer_paths
    cfg = get_config(arch).reduced()
    caches = Model(cfg, device="meta").init_cache(2, 24)
    got: dict = {}
    for layer, cache in zip(layer_paths(cfg), caches):
        for keys, t in _leaves(cache):
            path = "/".join((layer, *keys))
            shape, dtype, n = got.get(path, (tuple(t.shape), t.dtype, 0))
            assert (shape, dtype) == (tuple(t.shape), t.dtype), path
            got[path] = (shape, dtype, n + 1)
    want = ref["caches"][arch]
    assert set(got) == set(want)
    for path, (shape, dtype, n) in got.items():
        assert [[n, *shape], str(dtype).removeprefix("torch.")] == \
            want[path], path


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k",
                                        "train_4k"])
def test_serving_cells_traced_in_inference_mode(monkeypatch, shape_name):
    """A serving cell's step runs under ``torch.inference_mode()`` (as
    ``ServeEngine`` runs it), so no autograd graph keeps its
    intermediates; a train step runs with autograd.  The recurrent and
    attention archs both."""
    seen = []
    for name in ("prefill", "decode_step", "loss_fn"):
        original = getattr(Model, name)

        def spy(self, *args, _original=original, **kw):
            seen.append((torch.is_inference_mode_enabled(),
                         torch.is_grad_enabled()))
            return _original(self, *args, **kw)
        monkeypatch.setattr(Model, name, spy)
    for arch in ("stablelm-1.6b", "xlstm-1.3b"):
        seen.clear()
        traced = trace_cell(get_config(arch).reduced(),
                            small(shape_name, seq=16, batch=2), None,
                            unroll=False, opt_name="adamw")
        serving = shape_name != "train_4k"
        assert seen == [(serving, not serving)], (arch, seen)
        assert traced.temp_peak > 0


def test_trace_refuses_an_op_off_meta():
    """The meta run computes nothing: an op whose result holds values on
    another device stops the trace; an empty one (as
    ``torch.utils.checkpoint`` makes on the default device) passes."""
    counter = dryrun._ByteCounter([])
    with counter:
        assert torch.empty((0,)).device.type == "cpu"
    with pytest.raises(RuntimeError, match="not meta"):
        with counter:
            torch.ones(3) + 1


def test_cli_without_gpu_or_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun`` with no GPU visible and jax
    unimportable writes a record with the reference's keys and exits 0."""
    code = (
        "import sys, runpy\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['dryrun', '--arch', 'stablelm-1.6b', '--shape',\n"
        f"            'train_4k', '--skip-delta', '--out', {str(tmp_path)!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun',\n"
        "                     run_name='__main__')\n"
        "finally:\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "    print('imported', bad)\n")
    env = {"PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": "",
           "PATH": os.environ.get("PATH", "")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported []" in r.stdout
    assert "[OK] stablelm-1.6b × train_4k × 16x16" in r.stdout
    rec = json.loads((tmp_path / "stablelm-1.6b__train_4k__pod16x16.json")
                     .read_text())
    assert {"arch", "shape", "mesh", "applicable", "skip_reason", "variant",
            "compile_seconds", "full_program", "param_counts", "ok",
            "total_seconds"} <= set(rec)
    assert rec["ok"] and rec["hardware"]["link_bw_assumed"] is True
    assert {"flops", "bytes_accessed", "memory", "collectives"} <= \
        set(rec["full_program"])
    assert "collectives_derived" not in rec["full_program"]
    mem = rec["full_program"]["memory"]
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"} <= set(mem)
    assert "generated_code_size_in_bytes" not in mem
    assert mem["argument_size_in_bytes"] > 0
    # 256 lanes: temp is one lane's peak
    assert mem["temp_size_in_bytes"] > 0 and "temp_size_note" not in mem
