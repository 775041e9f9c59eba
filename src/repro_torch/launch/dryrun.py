"""Multi-pod dry run: trace every (arch x shape x mesh) cell on ``meta``
lanes, with no GPU and no value computed.

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices.  Here the production mesh (``launch.mesh.
make_production_mesh``) is a grid of ``meta`` lanes, the rules come from
``make_rules``, and one cell's train step, prefill or decode step runs
once on ``meta`` tensors: every op checks its shapes and dtypes and
allocates nothing.  An op that yields a tensor on any other device stops
the trace (``_ByteCounter``): nothing runs on the CPU or a GPU in place
of ``meta``.  Serving steps run under ``torch.inference_mode()``, as
``ServeEngine`` runs them.  For each cell this writes one JSON record,
with the reference's file names and field names:

  * proof that the cell builds: the meta run ends without a shape or
    sharding error (a sharding the inputs do not divide raises
    ``ValueError``, a spec with one axis twice ``DuplicateSpecError``,
    as jax does);
  * ``full_program``: ``analyze`` of the real-depth step;
  * ``param_counts``;
  * ``roofline_inputs`` and ``roofline``: the delta method, the cell
    traced at repeat 1 and 2 with ``unroll=True`` and extrapolated to
    the full depth.  The port's counts are exact at any depth (a Python
    loop is counted step by step, where XLA counts a scan body once), so
    the delta equals a direct count; it is kept so both packages'
    records are made the same way.

What the fields mean in the port (``analyze``):

  * a mesh cell runs its SPMD program under ``spmd.representative_lane``:
    every lane runs the same ops on the same shapes, so the trace runs
    the first lane's and hands its results to the others, as XLA compiles
    one program for every device.  Every count below is that lane's;
  * ``flops``: ``FlopCounterMode``'s count (matmul-class ops: ``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, convolution, attention; forward,
    remat recompute and backward) of one lane's step.  ``flops_global``
    is that times the lanes: the work the mesh does, a replicated
    computation counted once a lane that runs it.  XLA's
    ``cost_analysis`` also counts elementwise ops and reductions, which
    this leaves out;
  * ``bytes_accessed``: every non-view op's input plus output bytes on
    one lane, unfused (XLA counts after fusion);
  * ``memory``: ``argument_size_in_bytes``, each input's bytes on one
    lane as ``NamedSharding.shard_shape`` cuts it (train: the state and
    the batch; prefill: the parameters and the batch; decode: the
    parameters, caches, tokens, ``pos`` and ``enc_out``);
    ``alias_size_in_bytes``, the donated inputs, as the reference's
    ``donate_argnums`` (the train state, the decode caches);
    ``output_size_in_bytes``, the outputs cut the same way (logits split
    by ("batch", "seq", "vocab")); ``temp_size_in_bytes``, the peak of
    the bytes held by storages one lane's ops allocate (the assembly of
    a whole output from the lanes' parts is no lane's and is left out).
    ``generated_code_size_in_bytes`` has no counterpart and is left
    out;
  * ``collectives``: the per-lane result bytes of the collectives that
    ``dist.spmd`` ran (forward, remat recompute and backward), by XLA's
    kind names: the weights' FSDP all-gathers and their gradients'
    reduce-scatters, the gradient all-reduces, the tensor-parallel and
    expert-parallel ones.  ``collectives_note`` names the bytes of each
    kind that ``derived_collectives``' rule does not model (the weights
    a layer gathers over 'model', the Mamba and xLSTM activations and
    states regrouped over 'model', the long-context decode's gathers).
    ``derived_collectives`` is that rule,
    kept as a check: on a train step the all-gather and reduce-scatter
    bytes, less the named ones, equal it.

The roofline's rates are an H100 SXM's datasheet figures (``PEAK_FLOPS``,
``HBM_BW``); the link rate ``LINK_BW`` is an assumption, and each record
says so.

Usage (no GPU needed; the lanes are ``meta``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import time
import traceback
import types
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import spmd
from repro_torch.dist.context import (Mesh, NamedSharding, ShardCtx,
                                      _axes_tuple, make_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, batch_shardings,
                                       batch_specs, cache_shardings,
                                       cell_applicable, decode_input_specs)
from repro_torch.models.convert import reference_leaves
from repro_torch.models.model import Model, build_model
from repro_torch.models.nn import ShardedParameter
from repro_torch.models.xlstm import slstm_step_flops
from repro_torch.train import OptConfig, make_init_state, make_train_step

# H100 SXM (per card), NVIDIA's datasheet figures
PEAK_FLOPS = 989e12     # bf16 dense FLOP/s
HBM_BW = 3.35e12        # bytes/s
# assumed, not measured: a 256-lane mesh of H100s spans 32 nodes of 8, and
# a lane's traffic off its node goes through one 400 Gb/s NDR InfiniBand
# port a GPU (50e9 bytes/s); no run across cards has measured it
LINK_BW = 50e9          # bytes/s/lane
HARDWARE = {"name": "H100 SXM (datasheet)", "peak_flops": PEAK_FLOPS,
            "hbm_bw": HBM_BW, "link_bw": LINK_BW, "link_bw_assumed": True,
            "link_bw_basis": "assumed: one 400 Gb/s NDR InfiniBand port a "
                             "GPU, 32 nodes of 8 GPUs for 256 lanes"}


# --------------------------------------------------------------------------
# layer-count manipulation for the delta method
# --------------------------------------------------------------------------
def cfg_with_repeat(cfg: ArchConfig, r: int) -> ArchConfig:
    if cfg.xlstm is not None:
        return dataclasses.replace(cfg, num_layers=r * cfg.xlstm.slstm_every)
    if cfg.attn_every:
        return dataclasses.replace(cfg, num_layers=r * cfg.attn_every)
    kw = {"num_layers": (cfg.moe.first_k_dense + r)
          if (cfg.moe and cfg.moe.first_k_dense) else r}
    if cfg.encoder_layers:
        kw["encoder_layers"] = r
    return dataclasses.replace(cfg, **kw)


def full_repeat(cfg: ArchConfig) -> int:
    if cfg.xlstm is not None:
        return cfg.num_layers // cfg.xlstm.slstm_every
    if cfg.attn_every:
        return cfg.num_layers // cfg.attn_every
    if cfg.moe and cfg.moe.first_k_dense:
        return cfg.num_layers - cfg.moe.first_k_dense
    return cfg.num_layers


# --------------------------------------------------------------------------
# parameter accounting
# --------------------------------------------------------------------------
def param_counts(model: Model) -> dict[str, float]:
    """Total, embedding, expert and active non-embedding parameter counts
    over the reference's leaves, by the reference's path tests: "embed"
    anywhere in a path (so ``unembed`` too), and ``w_up``/``w_down``/
    ``w_gate`` under ``moe`` but not under ``shared`` for the experts."""
    cfg = model.cfg
    leaves = [(leaf.path, math.prod(leaf.shape))
              for leaf in reference_leaves(model)]
    total = sum(n for _, n in leaves)
    embed = sum(n for p, n in leaves if "embed" in p or "unembed" in p)
    expert = sum(n for p, n in leaves
                 if re.search(r"w_(up|down|gate)", p) and "moe" in p
                 and "shared" not in p)
    active = total - embed
    if cfg.moe is not None and expert:
        active -= expert * (1.0 - cfg.moe.top_k / cfg.moe.num_experts)
    return {"total": total, "embedding": embed, "expert": expert,
            "active_nonembed": active}


def slstm_flops_correction(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """The reference's analytic sLSTM recurrence FLOPs (step FLOPs x steps
    x layers, x3 for a train step), which it adds because XLA counts the
    recurrence's scan body once.  The port's dry run does not add it: its
    sLSTM is a Python loop of einsums that ``FlopCounterMode`` counts step
    by step, forward, remat recompute and backward; the gates' 12 d
    elementwise FLOPs a step are left out, as every elementwise op is."""
    if cfg.xlstm is None or shape.kind == "decode":
        return 0.0
    n_slstm = cfg.num_layers // cfg.xlstm.slstm_every
    steps = shape.seq_len * shape.global_batch
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd ~ 3x fwd
    return mult * n_slstm * steps * slstm_step_flops(cfg.d_model,
                                                      cfg.num_heads)


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------
def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class _ByteCounter(TorchDispatchMode):
    """Counts each op's input and output bytes (views move none) and the
    peak of the bytes held by storages the ops allocate.  A storage is
    live while a tensor on it is (``weakref.finalize``); the storages of
    ``external`` tensors (the step's arguments) are not counted.  An op
    whose result holds values off ``meta`` raises: the trace computes
    nothing."""

    def __init__(self, external):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._external = {_storage_key(t) for t in external}
        self._refs: dict[int, list[int]] = {}
        self._view: dict = {}  # op -> whether its result aliases an input

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._external:
            return
        ref = self._refs.get(key)
        if ref is None:
            n = t.untyped_storage().nbytes()
            ref = self._refs[key] = [n, 0]
            self.live += n
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = list(_tensors(out))
        view = self._view.get(func)
        if view is None:
            view = self._view[func] = _is_view(func)
        for t in outs:
            # an empty tensor holds no value (``torch.utils.checkpoint``
            # makes one on the default device)
            if t.device.type != "meta" and t.numel():
                raise RuntimeError(f"dry run: {func} gave a tensor on "
                                   f"{t.device}, not meta")
        if spmd.assembling.get():  # a whole value from the lanes' parts
            return out
        if not view:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in (*_tensors(args), *_tensors(kwargs or {}), *outs))
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class Traced:
    """One cell's meta run.  ``flops``, ``bytes_accessed`` and
    ``temp_peak`` are one lane's; ``arguments``/``outputs``/``aliased``
    are lists of (shape, dtype, sharding or None); ``collectives`` are
    per-lane bytes by kind, of the collectives ``dist.spmd`` ran, and
    ``labelled`` the named parts of them (``spmd.Counts``)."""
    model: Model
    lanes: int
    flops: float
    bytes_accessed: float
    temp_peak: int
    arguments: list
    outputs: list
    aliased: list
    collectives: dict
    labelled: dict


def _meta_mesh(mesh: Mesh | None) -> Mesh | None:
    """The same grid of lanes, all ``meta``."""
    return None if mesh is None else mesh.on_meta()


def _spec_of(axes, shape):
    return types.SimpleNamespace(axes=tuple(axes), shape=tuple(shape))


def _state_entries(state, ctx: ShardCtx) -> list:
    """(shape, dtype, sharding) of every leaf of a ``TrainState``, with
    the shardings the reference's ``state_shardings`` gives them."""
    rep = ctx.logical_sharding(())
    out = []
    for leaf in state.params:
        out.append((leaf.shape, leaf.dtype, ctx.param_sharding(leaf)))
    out.append((tuple(state.opt["step"].shape), state.opt["step"].dtype,
                rep))
    for leaf in state.params:
        axes = leaf.axes
        for name, t in state.opt["ema"][leaf.path].items():
            if name == "vr":
                spec = _spec_of(axes[:-1], t.shape)
            elif name == "vc":
                spec = _spec_of(axes[:-2] + axes[-1:], t.shape)
            else:
                spec = _spec_of(axes, t.shape)
            out.append((tuple(t.shape), t.dtype, ctx.param_sharding(spec)))
    for leaf in state.params if state.ef is not None else ():
        t = state.ef[leaf.path]
        out.append((tuple(t.shape), t.dtype, ctx.param_sharding(leaf)))
    out.append((tuple(state.step.shape), state.step.dtype, rep))
    return out


def _tensor_entries(tree, shardings) -> list:
    """(shape, dtype, sharding) of each tensor (or ``spmd.Lanes``) of
    ``tree`` beside the same structure of shardings."""
    ts, _ = tree_flatten(tree)
    ss, _ = tree_flatten(shardings, is_leaf=lambda x: x is None or
                         isinstance(x, NamedSharding))
    return [(tuple(t.shape), t.dtype, s) for t, s in zip(ts, ss)
            if isinstance(t, (torch.Tensor, spmd.Lanes))]


def _storages(tree) -> list:
    """Every tensor a tree holds: a ``spmd.Lanes``' and an
    ``nn.ShardedParameter``'s lanes' parts too."""
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, spmd.Lanes):
            out.extend(t.parts.flat)
        elif isinstance(t, ShardedParameter):
            out.extend(t.pieces)
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _cache_entries(caches, cfg: ArchConfig, ctx: ShardCtx) -> list:
    shardings = (cache_shardings(caches, cfg, ctx) if ctx.enabled
                 else [None] * len(tree_flatten(caches)[0]))
    return _tensor_entries(caches, shardings)


def lane_bytes(entries) -> int:
    """One lane's bytes of (shape, dtype, sharding) entries: each shape as
    ``NamedSharding.shard_shape`` cuts it (whole without a sharding)."""
    total = 0
    for shape, dtype, sh in entries:
        lane = sh.shard_shape(shape) if sh is not None else shape
        total += math.prod(lane) * dtype.itemsize
    return total


def derived_collectives(leaves, ctx: ShardCtx, train: bool) -> dict:
    """The per-lane result bytes, by kind, of the weight and gradient
    collectives of an FSDP program (kept as a check of the counted ones:
    the module docstring).  The rule,
    for each parameter leaf under ``ctx.param_sharding``: a leaf split
    over the FSDP axes (``weight_rules["embed"]``) is all-gathered over
    them once a forward, its result still split over its other axes; a
    train step gathers it once more for the backward and reduce-scatters
    its gradient (result: the lane's shard); a train step all-reduces the
    gradient of every other leaf (result: the lane's shard) when the
    batch axes hold more than one lane.  The activation collectives of
    tensor parallelism are not derived."""
    if not ctx.enabled:
        return {}
    fsdp = set(_axes_tuple(ctx.weight_rules.get("embed")))
    batch_lanes = ctx.axis_size("batch")
    out: dict[str, int] = {}

    def add(kind, n):
        out[kind] = out.get(kind, 0) + int(n)
    for leaf in leaves:
        sh = ctx.param_sharding(leaf)
        nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
        split = {a for entry in sh.spec for a in _axes_tuple(entry)}
        n_all = math.prod(ctx.mesh.shape[a] for a in split)
        n_f = math.prod(ctx.mesh.shape[a] for a in split & fsdp)
        if n_f > 1:
            add("all-gather", (2 if train else 1) * nbytes * n_f // n_all)
            if train:
                add("reduce-scatter", nbytes // n_all)
        elif train and batch_lanes > 1:
            add("all-reduce", nbytes // n_all)
    return out


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh | None, *,
               unroll: bool, opt_name: str, ep_mode: str = "a2a",
               serve_fsdp: bool = True, remat_policy: str = "nothing",
               ssm_dtype: str = "float32",
               capacity_factor: float = 0.0) -> Traced:
    """The counterpart of the reference's ``lower_cell``: build the cell
    on ``mesh``'s lanes made ``meta`` (``mesh=None``: one lane, the
    disabled context) and run its step once, under ``FlopCounterMode``,
    ``spmd.count_collectives`` and a dispatch mode that counts bytes and
    the live intermediates' peak.  A shape or sharding error raises, as
    the reference's lowering does."""
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    mesh = _meta_mesh(mesh)
    ctx = make_rules(mesh, cfg, long_context=shape.long, ep_mode=ep_mode,
                     serve_fsdp=(serve_fsdp or shape.kind == "train"))
    train = shape.kind == "train"
    model = build_model(cfg, ctx, device="meta", unroll=unroll, remat=train,
                        long_context=shape.long, remat_policy=remat_policy,
                        ssm_dtype=ssm_dtype)
    leaves = reference_leaves(model)
    param_entries = [(leaf.shape, leaf.dtype, ctx.param_sharding(leaf))
                     for leaf in leaves]
    rep = ctx.logical_sharding(())
    i32 = torch.int32
    if train:
        opt_cfg = OptConfig(name=opt_name)
        state = make_init_state(model, opt_cfg)()
        step = make_train_step(model, opt_cfg)
        batch = batch_specs(cfg, shape)
        state_entries = _state_entries(state, ctx)
        arguments = state_entries + _tensor_entries(
            batch, batch_shardings(cfg, shape, ctx))
        aliased = state_entries
        external = _storages([list(leaf.tensors) for leaf in leaves]
                             + [state.opt, state.ef, state.step, batch])

        def run():
            _, metrics = step(state, batch)
            return [((), m.dtype, rep) for m in metrics.values()]
        outputs_extra = state_entries
    elif shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        arguments = param_entries + _tensor_entries(
            batch, batch_shardings(cfg, shape, ctx))
        aliased = []
        external = _storages([list(leaf.tensors) for leaf in leaves]
                             + [batch])

        def run():
            logits, caches, _ = model.prefill(batch, shape.seq_len)
            return _logit_entries(logits, ctx) + _cache_entries(caches, cfg,
                                                                ctx)
        outputs_extra = []
    else:  # decode
        caches, toks, _, enc = decode_input_specs(model, cfg, shape)
        c_entries = _cache_entries(caches, cfg, ctx)
        if ctx.enabled:  # the lanes' caches (``Model.init_cache``)
            caches = model.init_cache(shape.global_batch, shape.seq_len,
                                      device="meta")
        arguments = (param_entries + c_entries
                     + [(tuple(toks.shape), i32,
                         ctx.logical_sharding(("batch", None))),
                        ((), i32, rep)])
        if enc is not None:
            arguments.append((tuple(enc.shape), enc.dtype,
                              ctx.logical_sharding(("batch", None, None))))
        aliased = c_entries
        external = _storages([list(leaf.tensors) for leaf in leaves]
                             + [caches, toks, enc])

        def run():
            logits, _ = model.decode_step(caches, toks, shape.seq_len - 1,
                                          enc_out=enc)
            return _logit_entries(logits, ctx)
        outputs_extra = c_entries
    lane_bytes(arguments)  # a dim the sharding does not divide raises here
    lanes = 1 if mesh is None else mesh.size
    # serving steps run under inference mode, as ServeEngine runs them (a
    # graph would keep every intermediate alive)
    with torch.inference_mode(not train), \
            spmd.representative_lane(), \
            FlopCounterMode(display=False) as fc, \
            spmd.count_collectives() as colls, \
            _ByteCounter(external) as bc:
        outputs = run()
    return Traced(model=model, lanes=lanes, flops=float(fc.get_total_flops()),
                  bytes_accessed=float(bc.bytes_accessed),
                  temp_peak=bc.peak, arguments=arguments,
                  outputs=outputs + outputs_extra, aliased=aliased,
                  collectives=dict(colls), labelled=dict(colls.labelled))


def _logit_entries(logits, ctx: ShardCtx) -> list:
    """Logits [B, S, V] split by their logical axes, a dim the lanes do
    not divide kept whole."""
    if not ctx.enabled:
        return [(tuple(logits.shape), logits.dtype, None)]
    spec = ctx._spec(("batch", "seq", "vocab"), ctx.rules,
                     tuple(logits.shape))
    return [(tuple(logits.shape), logits.dtype,
             NamedSharding(ctx.mesh, spec))]


def analyze(traced: Traced) -> dict:
    """``analyze_compiled``'s record from a meta run, per lane (the
    module docstring says what each field means in the port), and
    ``flops_global``, ``lanes``."""
    memory = {
        "argument_size_in_bytes": lane_bytes(traced.arguments),
        "output_size_in_bytes": lane_bytes(traced.outputs),
        "temp_size_in_bytes": traced.temp_peak,
        "alias_size_in_bytes": lane_bytes(traced.aliased),
    }
    out = {
        "flops": traced.flops,
        "bytes_accessed": traced.bytes_accessed,
        "memory": memory,
        "collectives": dict(traced.collectives),
        "flops_global": traced.flops * traced.lanes,
        "lanes": traced.lanes,
    }
    if traced.labelled:
        out["collectives_note"] = (
            "bytes the FSDP rule (derived_collectives) does not model, in "
            "the totals above: " + "; ".join(
                f"{k}: {v}" for k, v in sorted(traced.labelled.items())))
    return out


# --------------------------------------------------------------------------
# one cell, and the sweep
# --------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             *, force: bool = False, skip_delta: bool = False,
             ep_mode: str = "a2a", serve_fsdp: bool = True,
             remat_policy: str = "nothing", ssm_dtype: str = "float32",
             capacity_factor: float = 0.0, tag: str = "") -> dict:
    shape = SHAPES[shape_name]
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    if tag:
        mesh_tag = f"{mesh_tag}__{tag}"
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_path.exists() and not force:
        cached = json.loads(out_path.read_text())
        if cached.get("ok") or not cached.get("applicable", True):
            return cached  # only reuse successful/skip cells; retry failures
    cfg = get_config(arch)
    ok, reason = cell_applicable(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                    "applicable": ok, "skip_reason": reason}
    if not ok:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(record, indent=2))
        return record
    opt_name = "adafactor" if cfg.moe and cfg.moe.num_experts >= 64 \
        else "adamw"
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    record["variant"] = {"ep_mode": ep_mode, "serve_fsdp": serve_fsdp,
                         "remat_policy": remat_policy, "ssm_dtype": ssm_dtype,
                         "capacity_factor": capacity_factor}
    record["hardware"] = dict(HARDWARE)
    t0 = time.time()
    kw = dict(opt_name=opt_name, ep_mode=ep_mode, serve_fsdp=serve_fsdp,
              remat_policy=remat_policy, ssm_dtype=ssm_dtype,
              capacity_factor=capacity_factor)
    try:
        # 1) the real-depth step: the proof that it builds, and its memory
        traced = trace_cell(cfg, shape, mesh, unroll=False, **kw)
        full = analyze(traced)
        record["compile_seconds"] = time.time() - t0
        record["full_program"] = full
        record["param_counts"] = param_counts(traced.model)
        del traced
        # 2) delta method on r=1 / r=2 traces
        if not skip_delta:
            # xlstm long-sequence cells: as the reference, trace the deltas
            # at S=1024 and scale linearly (every per-layer term is linear
            # in S at fixed chunk)
            seq_scale = 1.0
            d_shape = shape
            if cfg.xlstm is not None and shape.kind != "decode" \
                    and shape.seq_len > 1024:
                seq_scale = shape.seq_len / 1024
                d_shape = dataclasses.replace(shape, seq_len=1024)
            deltas = {}
            for r in (1, 2):
                deltas[r] = analyze(trace_cell(cfg_with_repeat(cfg, r),
                                               d_shape, mesh, unroll=True,
                                               **kw))
            R = full_repeat(cfg)
            record["roofline_inputs"] = roofline_inputs(deltas, R, seq_scale)
            record["roofline"] = roofline(
                record["roofline_inputs"], record["param_counts"], shape,
                n_chips)
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_seconds"] = time.time() - t0
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2))
    return record


def extrapolate(d1: float, d2: float, R: int, seq_scale: float = 1.0):
    """A count at repeat R from the counts at repeat 1 and 2."""
    return (d1 + (R - 1) * (d2 - d1)) * seq_scale


def roofline_inputs(deltas: dict, R: int, seq_scale: float = 1.0) -> dict:
    """The per-lane totals at repeat ``R`` from ``analyze`` at r = 1, 2.
    No sLSTM correction is added (``slstm_flops_correction``)."""
    def colls(key):
        out = {}
        for kind in set(deltas[1][key]) | set(deltas[2][key]):
            out[kind] = int(extrapolate(deltas[1][key].get(kind, 0),
                                        deltas[2][key].get(kind, 0), R,
                                        seq_scale))
        return out
    return {
        "hlo_flops_per_device": extrapolate(
            deltas[1]["flops"], deltas[2]["flops"], R, seq_scale),
        "hlo_bytes_per_device": extrapolate(
            deltas[1]["bytes_accessed"], deltas[2]["bytes_accessed"], R,
            seq_scale),
        "collective_bytes_per_device": colls("collectives"),
        "delta_r1": deltas[1], "delta_r2": deltas[2], "repeat": R,
    }


def roofline(inputs: dict, counts: dict, shape: ShapeSpec,
             n_chips: int) -> dict:
    """Per-lane roofline terms at the H100's rates: ``collective_s`` is the
    collectives the port runs over the assumed ``LINK_BW``."""
    flops = inputs["hlo_flops_per_device"]
    bytes_acc = inputs["hlo_bytes_per_device"]
    colls = sum(inputs["collective_bytes_per_device"].values())
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) \
        * counts["active_nonembed"] * tokens
    out = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": colls / LINK_BW,
        "model_flops": model_flops,
        "hlo_flops_global": flops * n_chips,
        "useful_flops_ratio": model_flops / max(flops * n_chips, 1.0),
        "tokens": tokens,
        "chips": n_chips,
        "link_bw_assumed": True,
    }
    terms = {k: out[k] for k in ("compute_s", "memory_s", "collective_s")}
    out["bottleneck"] = max(terms, key=terms.get)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-delta", action="store_true")
    ap.add_argument("--ep-mode", default="a2a", choices=["a2a", "replicated"])
    ap.add_argument("--no-serve-fsdp", action="store_true")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--ssm-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--tag", default="", help="artifact suffix for perf variants")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, out_dir, force=args.force,
                               skip_delta=args.skip_delta, ep_mode=args.ep_mode,
                               serve_fsdp=not args.no_serve_fsdp,
                               remat_policy=args.remat_policy,
                               ssm_dtype=args.ssm_dtype,
                               capacity_factor=args.capacity_factor,
                               tag=args.tag)
                tag = "SKIP" if not rec["applicable"] else (
                    "OK" if rec.get("ok") else "FAIL")
                failures += tag == "FAIL"
                extra = ""
                if rec.get("roofline"):
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" useful={r['useful_flops_ratio']:.2f}")
                print(f"[{tag}] {arch} × {shape} × "
                      f"{'2x16x16' if mp else '16x16'}"
                      f" ({rec.get('total_seconds', 0):.0f}s){extra}",
                      flush=True)
                if tag == "FAIL":
                    print("      ", rec.get("error"), flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
