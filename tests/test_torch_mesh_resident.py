"""A mesh model's weights resident lane by lane, on CPU lanes, in this
process: the pieces ``Init`` cuts by ``param_sharding``, the two
collectives the layout adds (``spmd.all_gather``, ``spmd.psum_scatter``),
the optimizer and the int8 error feedback on shards, the checkpoint of a
sharded state, and the dry run's counted FSDP collectives.

The reference is the port's own unsharded model from the same seed (the
same global values, bitwise), and ``launch.dryrun.derived_collectives``'
rule; ``tests/test_torch_mesh_layers.py`` holds the resident model's
forward, loss, gradients, decode and CLI against the reference package.

Bounds: the pieces and the checkpoints bitwise; the optimizer on shards
to 4 float32 ulps of a leaf's largest value
(``tests/test_torch_train.py``'s bound: a sum over lanes adds in another
order than one sum over the leaf), and its moments (``m``, ``v``,
``vr``, ``vc``) to 4 a step, as each step's rounding carries into the
next; the int8 error feedback bitwise (a maximum and elementwise ops).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import spmd
from repro_torch.dist.context import P, _axes_tuple, make_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.models.convert import (load_reference_params,
                                        reference_leaves, to_reference)
from repro_torch.models.model import Model
from repro_torch.models.nn import RECURRENT, ShardedParameter, named_weights
from repro_torch.train import OptConfig, make_init_state
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import apply_updates
from repro_torch.train.train_step import ef_compress_grads, stacked_grads

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ULPS = 4


def f32(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices="cpu")


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_weight_is_resident_lane_by_lane(arch, mesh_name):
    """Each weight's pieces: ``shard_shape``, storage of their own (no
    view of another lane's tensor, no whole copy left), on their lane's
    device, and together the unsharded model's value from the same seed,
    bitwise.  ``load_reference_params`` keeps the same pieces (float32:
    ``to_reference`` hands bfloat16 out as float32)."""
    cfg = f32(arch)
    shape, axes = MESHES[mesh_name]
    mesh = cpu_mesh(shape, axes)
    model = Model(cfg, ctx=make_rules(mesh, cfg), seed=3)
    base = dict(named_weights(Model(cfg, device="cpu", seed=3)))
    weights = dict(named_weights(model))
    assert set(weights) == set(base)
    ptrs = set()
    n_params = 0
    for name, w in weights.items():
        assert isinstance(w, ShardedParameter), name
        assert w.sharding == model.ctx.param_sharding(w), name
        local = w.sharding.shard_shape(w.shape)
        for lane, piece in zip(mesh.devices.flat, w.pieces):
            assert tuple(piece.shape) == local, name
            assert piece.device == lane
            assert piece.untyped_storage().nbytes() == \
                piece.numel() * piece.element_size(), name
            ptrs.add(piece.untyped_storage().data_ptr())
            n_params += 1
        assert torch.equal(w.full(), base[name].detach()), name
    # every piece its own storage: no two share one
    assert len(ptrs) == n_params == len(list(model.parameters()))
    assert model.param_count() == sum(p.numel() for p in base.values())
    before = {name: [id(p) for p in w.pieces] for name, w in weights.items()}
    load_reference_params(model, to_reference(Model(cfg, device="cpu",
                                                    seed=4)))
    other = dict(named_weights(Model(cfg, device="cpu", seed=4)))
    for name, w in named_weights(model):
        assert [id(p) for p in w.pieces] == before[name]
        assert torch.equal(w.full(), other[name].detach()), name


def test_meta_lanes_allocate_nothing():
    """On ``meta`` lanes every piece is ``meta``, of its shard shape."""
    cfg = get_config("kimi-k2-1t-a32b")
    mesh = dryrun._meta_mesh(cpu_mesh((2, 2)))
    model = Model(cfg, ctx=make_rules(mesh, cfg), device="meta")
    for name, w in named_weights(model):
        assert all(p.device.type == "meta" for p in w.pieces), name
        assert tuple(w.pieces[0].shape) == w.sharding.shard_shape(w.shape)


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("axes,dim", [("data", 0), ("model", 1),
                                      (("data", "model"), 0)])
def test_all_gather_and_psum_scatter_values(axes, dim):
    """``all_gather`` concatenates a group's parts in their index order
    (here: the whole array on every lane); ``psum_scatter`` gives lane k
    the sum over its group of every lane's k-th chunk."""
    mesh = cpu_mesh((2, 2))
    x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    spec = P(axes) if dim == 0 else P(None, axes)
    parts = spmd.shard(x, spec, mesh)
    got = spmd.all_gather(parts, axes, dim, mesh)
    for idx in np.ndindex(2, 2):
        assert torch.equal(got[idx], x)
    red = spmd.psum_scatter(got, axes, dim, mesh)
    n = 4 if isinstance(axes, tuple) else 2
    for idx in np.ndindex(2, 2):
        assert torch.equal(red[idx], n * parts[idx])


def test_all_gather_and_psum_scatter_are_each_others_transpose():
    """<all_gather(x), y> = <x, psum_scatter(y)> summed over the lanes,
    and autograd carries each one's gradient as the other."""
    mesh = cpu_mesh((2, 2))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    ys = np.empty((2, 2), dtype=object)
    for idx in np.ndindex(2, 2):
        ys[idx] = torch.randn(4, 6, generator=gen, dtype=torch.float64)
    parts = spmd.shard(x, P("data"), mesh)
    g = spmd.all_gather(parts, "data", 0, mesh)
    lhs = sum((g[idx] * ys[idx]).sum() for idx in np.ndindex(2, 2))
    rs = spmd.psum_scatter(ys, "data", 0, mesh)
    rhs = sum((parts[idx] * rs[idx]).sum() for idx in np.ndindex(2, 2))
    torch.testing.assert_close(lhs, rhs)
    lhs.backward()
    # the gather's backward: the reduce-scatter of the lanes' gradients
    # (both 'model' positions hold x's one copy, so theirs add)
    want = sum(spmd.unshard(rs[:, m:m + 1], P("data"),
                            cpu_mesh((2, 1))) for m in range(2))
    torch.testing.assert_close(x.grad, want)
    # and the reduce-scatter's backward is the all-gather
    zs = np.empty((2, 2), dtype=object)
    for idx in np.ndindex(2, 2):
        zs[idx] = ys[idx].clone().requires_grad_()
    w = spmd.shard(torch.randn(4, 6, generator=gen, dtype=torch.float64),
                   P("data"), mesh)
    out = spmd.psum_scatter(zs, "data", 0, mesh)
    sum((out[idx] * w[idx]).sum() for idx in np.ndindex(2, 2)).backward()
    gathered = spmd.all_gather(w, "data", 0, mesh)
    for idx in np.ndindex(2, 2):
        torch.testing.assert_close(zs[idx].grad, gathered[idx])


def test_gather_and_scatter_counted_with_their_backward():
    """``all-gather`` counts a lane's gathered bytes and its backward a
    ``reduce-scatter`` of the lane's shard; ``psum_scatter`` the other
    way round; a label adds a named part of its kind."""
    mesh = cpu_mesh((2, 2))
    x = torch.zeros(8, 16, requires_grad=True)
    with spmd.count_collectives() as counts:
        g = spmd.all_gather(spmd.shard(x, P("data"), mesh), "data", 0, mesh,
                            label="a")
        sum(t.sum() for t in g.flat).backward()
    assert dict(counts) == {"all-gather": 8 * 16 * 4,
                            "reduce-scatter": 4 * 16 * 4}
    assert counts.labelled == {"all-gather: a": 8 * 16 * 4,
                               "reduce-scatter: a": 4 * 16 * 4}
    y = torch.zeros(8, 16, requires_grad=True)
    with spmd.count_collectives() as counts:
        r = spmd.psum_scatter(spmd.shard(y, P(), mesh), "model", 1, mesh)
        sum(t.sum() for t in r.flat).backward()
    assert dict(counts) == {"reduce-scatter": 8 * 8 * 4,
                            "all-gather": 8 * 16 * 4}
    assert counts.labelled == {}


# --------------------------------------------------------------------------
# the optimizer on shards
# --------------------------------------------------------------------------
def _same_grads(model, base, seed: int):
    """The no-mesh model's gradients of one loss, stacked by leaf, and
    the same split into ``model``'s lanes."""
    cfg = base.cfg
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 17))).long()
    loss, _ = base.loss_fn({"tokens": toks[:, :16], "targets": toks[:, 1:]})
    loss.backward()
    whole = stacked_grads(reference_leaves(base))
    leaves = reference_leaves(model)
    lanes = [spmd.Lanes.split(g, leaf.spec, leaf.tensors[0].mesh)
             for g, leaf in zip(whole, leaves)]
    return whole, lanes


def _assert_ulps(got: torch.Tensor, want: torch.Tensor, what: str,
                 ulps: int = ULPS):
    top = float(want.abs().max())
    tol = ulps * float(np.spacing(np.float32(max(top, 1e-30))))
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: |diff| {err:.3g} > {ulps} ulps of {top:.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_kw,gc", [
    ({"name": "adamw"}, False),
    ({"name": "adafactor", "factored_min_dim": 16}, False),
    ({"name": "adafactor"}, False),
    ({"name": "adamw"}, True)],
    ids=["adamw", "adafactor-factored", "adafactor-unfactored", "int8-ef"])
def test_apply_updates_on_resident_shards(opt_kw, gc, dtype):
    """Two steps of ``apply_updates`` (after the int8 error feedback with
    ``gc``) on a 2 x 2 model's shards against the unsharded model, the
    same gradients: every float32 parameter and every optimizer state
    leaf (the float32 masters of bfloat16 weights among them) to 4
    float32 ulps of its largest, a bfloat16 weight its own master
    rounded, the compressed gradients and the error feedback bitwise."""
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              dtype=dtype)
    opt = OptConfig(peak_lr=3e-3, warmup_steps=1, decay_steps=10,
                    clip_norm=0.5, **opt_kw)
    mesh = cpu_mesh((2, 2))
    model = Model(cfg, ctx=make_rules(mesh, cfg), seed=0, remat=False)
    base = Model(cfg, device="cpu", seed=0, remat=False)
    states = [make_init_state(m, opt, grad_compression=gc)()
              for m in (model, base)]
    for step in range(2):
        whole, lanes = _same_grads(model, base, step)
        if gc:
            paths = [leaf.path for leaf in states[1].params]
            whole, e1 = ef_compress_grads(whole, [states[1].ef[p]
                                                  for p in paths])
            lanes, e0 = ef_compress_grads(lanes, [states[0].ef[p]
                                                  for p in paths])
            for a, b in zip(lanes, whole):
                assert torch.equal(a.full(), b)
            for a, b in zip(e0, e1):
                assert torch.equal(a.full(), b)
            states[0].ef, states[1].ef = dict(zip(paths, e0)), \
                dict(zip(paths, e1))
        _, m0 = apply_updates(states[0].params, lanes, states[0].opt, opt)
        _, m1 = apply_updates(states[1].params, whole, states[1].opt, opt)
        _assert_ulps(m0["grad_norm"], m1["grad_norm"], "grad norm")
        for a, b in zip(states[0].params, states[1].params):
            st = states[0].opt["ema"][a.path]
            if "master" in st:  # bf16: its own master, rounded
                assert torch.equal(a.stack(), st["master"].full().to(
                    a.dtype)), a.path
            else:
                _assert_ulps(a.stack(), b.stack(), f"step {step} {a.path}")
        for path, st in states[1].opt["ema"].items():
            for k, t in st.items():
                # a moment carries each step's rounding into the next: 4
                # ulps a step
                _assert_ulps(states[0].opt["ema"][path][k].full(), t,
                             f"step {step} {path} {k}",
                             ULPS if k == "master" else ULPS * (step + 1))


# --------------------------------------------------------------------------
# the checkpoint
# --------------------------------------------------------------------------
def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_sharded_checkpoint_is_the_unsharded_file(tmp_path):
    """A 2 x 2 state's save holds the arrays an unsharded run saves,
    bitwise (names, dtypes, values); it restores into 2 x 2 and 2 x 4
    meshes of another seed (the elastic restore), each piece cut from the
    file's arrays and still of its shard shape."""
    cfg = get_config("mixtral-8x22b").reduced()
    opt = OptConfig(peak_lr=3e-3, warmup_steps=1, decay_steps=10)
    model = Model(cfg, ctx=make_rules(cpu_mesh((2, 2)), cfg), seed=0,
                  remat=False)
    base = Model(cfg, device="cpu", seed=0, remat=False)
    states = [make_init_state(m, opt)() for m in (model, base)]
    whole, lanes = _same_grads(model, base, 0)
    apply_updates(states[0].params, lanes, states[0].opt, opt)
    apply_updates(states[1].params, whole, states[1].opt, opt)
    # the same values (the update's sums differ in order): write the
    # unsharded state's into the sharded one, then compare the files
    for a, b in zip(states[0].params, states[1].params):
        a.write(b.stack())
    for path, st in states[1].opt["ema"].items():
        for k, t in st.items():
            states[0].opt["ema"][path][k] = spmd.Lanes.split(
                t, states[0].opt["ema"][path][k].spec,
                states[0].opt["ema"][path][k].mesh)
    for name, state in (("sharded", states[0]), ("whole", states[1])):
        ck = CheckpointManager(tmp_path / name)
        ck.save(1, state, sync=True)
        ck.close()
    got = _arrays(tmp_path / "sharded" / "step_00000001.npz")
    want = _arrays(tmp_path / "whole" / "step_00000001.npz")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    for shape in ((2, 2), (2, 4)):
        fresh = Model(cfg, ctx=make_rules(cpu_mesh(shape), cfg), seed=7)
        state = make_init_state(fresh, opt)()
        restored, step = CheckpointManager(tmp_path / "sharded").restore(
            state)
        assert step == 1
        for leaf, ref in zip(restored.params, states[1].params):
            assert torch.equal(leaf.stack(), ref.stack()), leaf.path
            for t in leaf.tensors:
                assert all(tuple(p.shape) == t.sharding.shard_shape(t.shape)
                           for p in t.pieces)
        for path, st in states[1].opt["ema"].items():
            for k, t in st.items():
                assert torch.equal(restored.opt["ema"][path][k].full(), t)


# --------------------------------------------------------------------------
# the recurrent blocks, tensor parallel over 'model'
# --------------------------------------------------------------------------
RECURRENT_MIXERS = ("mamba", "mlstm", "slstm")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_recurrent_blocks_gather_no_weight_over_model(arch, monkeypatch):
    """On 2 x 2 CPU lanes, a forward, a prefill and a decode step and a
    loss's backward gather no Mamba, mLSTM or sLSTM weight over 'model':
    each reaches its lanes through ``nn.gather_to`` with every 'model'
    split kept (only its FSDP split over 'data' is gathered); the
    'model' collectives they run carry ``nn.RECURRENT``.  Each lane's
    recurrence runs on its own half: Mamba's scan on [B/2, S, di/2, N],
    mLSTM's on H/2 heads, sLSTM's steps on d/2 channels."""
    from repro_torch.models import nn as nnm
    from repro_torch.models import ssm, xlstm

    cfg = f32(arch)
    model = Model(cfg, ctx=make_rules(cpu_mesh((2, 2)), cfg), seed=0)
    mine = {id(w): name for name, w in named_weights(model)
            if any(f".{m}." in name for m in RECURRENT_MIXERS)}
    gathered = {}
    real = nnm.gather_to

    def spy(w, target, ctx, **kw):
        if id(w) in mine:
            gathered[mine[id(w)]] = (tuple(w.spec), tuple(target))
        return real(w, target, ctx, **kw)
    monkeypatch.setattr(nnm, "gather_to", spy)
    seen: dict = {}
    for mod, name, arg in ((ssm, "_ssm_scan_chunked", 0),
                           (xlstm, "_mlstm_chunked", 0),
                           (xlstm, "_slstm_step", 0)):
        def wrap(*a, _fn=getattr(mod, name), _name=name, _arg=arg, **kw):
            seen.setdefault(_name, set()).add(tuple(a[_arg].shape))
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)))
    with spmd.count_collectives() as counts:
        with torch.no_grad():
            model({"tokens": toks[:, :16]})
            _, caches, _ = model.prefill({"tokens": toks[:, :16]}, 24)
            model.decode_step(caches, toks[:, 16:], 16)
        loss, _ = model.loss_fn({"tokens": toks[:, :16],
                                 "targets": toks[:, 1:]})
        loss.backward()
    assert set(gathered) == set(mine.values())
    for name, (spec, target) in gathered.items():
        for dim, entry in enumerate(spec):
            if "model" in _axes_tuple(entry):
                assert "model" in _axes_tuple(target[dim]), (name, target)
    labels = {k.split(": ", 1)[1] for k in counts.labelled}
    assert nnm.RECURRENT in labels
    # reduced jamba's MoE router is the one weight a layer gathers whole
    assert labels <= {nnm.RECURRENT, nnm.TP_GATHER}
    d = cfg.d_model
    if arch == "jamba-v0.1-52b":
        di, N = 2 * d, cfg.mamba.d_state
        assert seen["_ssm_scan_chunked"] == {(2, 16, di // 2, N)}
    else:
        H, di = cfg.num_heads, int(d * cfg.xlstm.proj_factor_mlstm)
        assert seen["_mlstm_chunked"] == {(2, 16, H // 2, di // H)}
        assert seen["_slstm_step"] == {(2, 4, d // 2)}


def test_mamba_on_three_model_lanes_matches_no_mesh():
    """Reduced jamba at d_model 48 on (data 1 x model 3), where 'model'
    divides the conv state's time axis (d_conv - 1 = 3: ``cache_spec``
    splits it there, the reference's rule) and di = 96: the conv state
    goes time -> channels and back by all-to-all, and ``in_proj``'s
    halves, over three lanes, are gathered before each lane takes its
    channels.  Prefill and decode logits and the states against the
    no-mesh model from the same seed."""
    cfg = dataclasses.replace(f32("jamba-v0.1-52b"), d_model=48)
    ctx = make_rules(cpu_mesh((1, 3)), cfg)
    model = Model(cfg, ctx=ctx, seed=0)
    base = Model(cfg, device="cpu", seed=0)
    conv = next(c["mamba"]["conv"] for c in model.init_cache(2, 8)
                if "mamba" in c)
    assert tuple(conv.spec)[1] == "model"
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad(), spmd.count_collectives() as counts:
        got, caches, _ = model.prefill({"tokens": toks[:, :8]}, 16)
        want, ref_caches, _ = base.prefill({"tokens": toks[:, :8]}, 16)
        for i in range(8, 12):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                       rtol=1e-5)
            got, caches = model.decode_step(caches, toks[:, i:i + 1], i)
            want, ref_caches = base.decode_step(ref_caches,
                                                toks[:, i:i + 1], i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    for c, r in zip(caches, ref_caches):
        if "mamba" in c:
            for k in ("conv", "ssm"):
                np.testing.assert_allclose(c["mamba"][k].full().numpy(),
                                           r["mamba"][k].numpy(), atol=1e-5,
                                           rtol=1e-5)
    assert counts.labelled["all-to-all: " + RECURRENT] > 0


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_counts_the_fsdp_collectives(arch):
    """A reduced train cell on 2 x 2 meta lanes: the all-gathers and
    reduce-scatters the program runs, less the named ones the FSDP rule
    does not model (``collectives_note``), equal ``derived_collectives``;
    the temp figure is one lane's peak, a number."""
    cfg = get_config(arch).reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=4)
    mesh = cpu_mesh((2, 2))
    traced = dryrun.trace_cell(cfg, shape, mesh, unroll=False,
                               opt_name="adamw")
    rec = dryrun.analyze(traced)
    ctx = make_rules(dryrun._meta_mesh(mesh), cfg)
    derived = dryrun.derived_collectives(reference_leaves(traced.model),
                                         ctx, True)
    for kind in ("all-gather", "reduce-scatter"):
        named = sum(v for k, v in traced.labelled.items()
                    if k.startswith(kind + ":"))
        assert rec["collectives"][kind] - named == derived[kind], kind
        assert derived[kind] > 0
    assert ("collectives_note" in rec) == bool(traced.labelled)
    assert isinstance(rec["memory"]["temp_size_in_bytes"], int)
    assert rec["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_layout_is_the_cache_shardings_rule(arch):
    """``Model.init_cache`` on 2 x 2 lays each leaf out as
    ``launch.shapes.cache_shardings`` (the reference's rule, by path)
    does, each lane's part of its shard shape and storage."""
    from repro_torch.launch.shapes import cache_shardings
    from repro_torch.models.model import _init_cache_block

    cfg = get_config(arch).reduced()
    mesh = cpu_mesh((2, 2))
    model = Model(cfg, ctx=make_rules(mesh, cfg), device="meta")
    caches = model.init_cache(4, 24)
    whole = [_init_cache_block(b.desc, cfg, 4, 24, model.ctx, model.dtype,
                               "meta") for b in model.layers]
    want = cache_shardings(whole, cfg, model.ctx)
    for got_layer, want_layer in zip(caches, want):
        for mixer, leaves in want_layer.items():
            for key, sh in leaves.items():
                lanes = got_layer[mixer][key]
                assert tuple(lanes.spec) == tuple(sh.spec), (mixer, key)
                local = sh.shard_shape(lanes.shape)
                assert all(tuple(p.shape) == local for p in lanes.parts.flat)
