"""The port's mesh layer held against the reference: layout rules, the
specs of every parameter and cache leaf, shapes, the lane collectives and
elastic checkpoint restore.  All in this process and exact.

The reference's side needs no devices: its rules, ``kv_repeat_for`` and
shardings take a ``jax.sharding.AbstractMesh`` of the same shape (its
parameters from ``abstract_params``, its caches from ``jax.eval_shape``),
and the port's a ``Mesh`` of ``meta`` lanes, on which its ``Model``
allocates nothing.  A leaf is matched by the reference's tree path; the
reference stacks a layer group's leaves on a leading [L] axis, the port
keeps one tensor (and one cache dict) a layer, so a stacked leaf's spec
is the port's with a leading None.

The numeric side of the mesh (the MoE's expert-parallel paths, the
sequence-sharded decode, whole models, the training CLI) is in
``tests/test_torch_mesh_layers.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.dist.context import make_rules as ref_rules
from repro.launch import shapes as ref_shapes
from repro.models.attention import kv_repeat_for as ref_kv_repeat
from repro.models.model import build_model as ref_build
from repro.models.nn import Param
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import spmd
from repro_torch.dist.context import P, make_rules
from repro_torch.launch import shapes
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.attention import kv_repeat_for
from repro_torch.models.convert import reference_leaves
from repro_torch.models.model import Model, layer_paths
from repro_torch.train.checkpoint import CheckpointManager

# (name, shape, axes, full-size configs?)
MESHES = {
    "2x2": ((2, 2), ("data", "model"), False),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"), False),
    "data4": ((4,), ("data",), False),
    "model4": ((4,), ("model",), False),
    "prod16x16": ((16, 16), ("data", "model"), True),
    "prod2x16x16": ((2, 16, 16), ("pod", "data", "model"), True),
}
VARIANTS = [dict(), dict(long_context=True), dict(serve_fsdp=False),
            dict(ep_mode="replicated")]


def port_mesh(name: str):
    shape, axes, full = MESHES[name]
    if full:
        return make_production_mesh(multi_pod=len(shape) == 3)
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


def configs(arch: str, full: bool):
    cfg, rcfg = get_config(arch), ref_config(arch)
    return (cfg, rcfg) if full else (cfg.reduced(), rcfg.reduced())


@functools.lru_cache(maxsize=None)
def ref_param_leaves(arch: str, full: bool) -> dict:
    """{reference tree path: Param of ShapeDtypeStructs}."""
    _, rcfg = configs(arch, full)
    params = ref_build(rcfg, ref_rules(None, rcfg)).abstract_params()
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Param):
                out[prefix + key] = val
            else:
                walk(val, f"{prefix}{key}/")
    walk(params, "")
    return out


def ref_cache_specs(rmodel, rcfg, rctx, B: int, S: int) -> dict:
    """{reference cache leaf path "group0/b0/attn/k": spec tuple}."""
    abstract = jax.eval_shape(lambda: rmodel.init_cache(B, S))
    sh = ref_shapes.cache_shardings(abstract, rcfg, rctx)
    return {"/".join(k.key for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(sh)}


def port_cache_specs(model, cfg, ctx, B: int, S: int) -> dict:
    caches = model.init_cache(B, S, device="meta")
    sh = shapes.cache_shardings(caches, cfg, ctx)
    out = {}
    for layer, one in zip(layer_paths(cfg), sh):
        for keys, s in shapes._leaves(one):
            # a stacked reference leaf: the [L] axis first, replicated
            out.setdefault(layer + "/" + "/".join(keys), set()).add(
                (None,) + tuple(s.spec))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_match_reference(arch, mesh_name):
    """``make_rules``, ``kv_repeat_for`` and the spec of every parameter
    leaf, cache leaf (a decode shape) and batch input equal the
    reference's, for each variant: the default, ``long_context``,
    ``serve_fsdp=False`` (the 2-D expert layout) and
    ``ep_mode="replicated"``."""
    shape, axes, full = MESHES[mesh_name]
    cfg, rcfg = configs(arch, full)
    mesh, rmesh = port_mesh(mesh_name), AbstractMesh(shape, axes)
    want_params = ref_param_leaves(arch, full)
    B, S = (128, 32768) if full else (4, 64)
    for kw in VARIANTS:
        ctx, rctx = make_rules(mesh, cfg, **kw), ref_rules(rmesh, rcfg, **kw)
        what = f"{arch} on {mesh_name} {kw}"
        assert dict(ctx.rules) == dict(rctx.rules), what
        assert dict(ctx.weight_rules) == dict(rctx.weight_rules), what
        assert ctx.ep_mode == rctx.ep_mode
        assert kv_repeat_for(cfg, ctx) == ref_kv_repeat(rcfg, rctx), what
        for name in ("batch", "experts", "q_heads", "kv_seq", "vocab"):
            assert ctx.axis_size(name) == rctx.axis_size(name), (what, name)

        model = Model(cfg, ctx=ctx, device="meta")
        leaves = {leaf.path: leaf for leaf in reference_leaves(model)}
        assert set(leaves) == set(want_params), what
        for path, leaf in leaves.items():
            assert leaf.shape == want_params[path].value.shape, path
            assert leaf.axes == tuple(want_params[path].axes), path
            got = tuple(ctx.param_sharding(leaf).spec)
            want = tuple(rctx.param_sharding(want_params[path]).spec)
            assert got == want, (what, path, got, want)

        rmodel = ref_build(rcfg, rctx)
        try:
            want_cache = ref_cache_specs(rmodel, rcfg, rctx, B, S)
        except DuplicateSpecError:
            # long_context with batch and kv_seq both on 'data': the
            # reference's rules give one leaf 'data' twice, which jax
            # refuses; so does the port
            with pytest.raises(ValueError, match="more than one dim"):
                port_cache_specs(model, cfg, ctx, B, S)
        else:
            got_cache = port_cache_specs(model, cfg, ctx, B, S)
            assert set(got_cache) == set(want_cache), what
            for path, specs in got_cache.items():
                assert specs == {want_cache[path]}, (what, path, specs)

        for name in ("train_4k", "prefill_32k", "decode_32k"):
            got = shapes.batch_shardings(cfg, shapes.SHAPES[name], ctx)
            want = ref_shapes.batch_shardings(rcfg, ref_shapes.SHAPES[name],
                                              rctx)
            assert {k: tuple(v.spec) for k, v in got.items()} == \
                {k: tuple(v.spec) for k, v in want.items()}, (what, name)


def test_production_mesh_kv_repeat_and_spec_count():
    """On the 16 x 16 production mesh: kimi's 8 KV heads repeat to 16
    (two a model lane), gemma (8 heads, 1 KV head) and minitron keep
    attention replicated, as the reference decides."""
    mesh = make_production_mesh()
    rmesh = AbstractMesh((16, 16), ("data", "model"))
    got = {a: kv_repeat_for(get_config(a), make_rules(mesh, get_config(a)))
           for a in ARCH_IDS}
    want = {a: ref_kv_repeat(ref_config(a), ref_rules(rmesh, ref_config(a)))
            for a in ARCH_IDS}
    assert got == want
    assert got["kimi-k2-1t-a32b"] == 2
    assert mesh.size == 256 and mesh.shape == {"data": 16, "model": 16}
    assert {str(d) for d in mesh.devices.flat} == {"meta"}


@pytest.mark.parametrize("name", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_match_reference(arch, name):
    """``cell_applicable``, ``batch_specs`` and ``decode_input_specs``:
    the same names, shapes and dtypes (as meta tensors)."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    shape = shapes.SHAPES[name]
    rshape = ref_shapes.SHAPES[name]
    assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
    assert shapes.cell_applicable(cfg, shape)[0] == \
        ref_shapes.cell_applicable(rcfg, rshape)[0]
    got = shapes.batch_specs(cfg, shape)
    want = ref_shapes.batch_specs(rcfg, rshape)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    if shape.kind != "decode":
        return
    small = dataclasses.replace(shape, global_batch=2, seq_len=64)
    model = Model(cfg.reduced(), device="meta")
    caches, toks, pos, enc = shapes.decode_input_specs(model, cfg.reduced(),
                                                       small)
    rmodel = ref_build(rcfg.reduced(), ref_rules(None, rcfg.reduced()))
    rcaches, rtoks, rpos, renc = ref_shapes.decode_input_specs(
        rmodel, rcfg.reduced(), small)
    assert tuple(toks.shape) == rtoks.shape and pos.dim() == 0
    assert (enc is None) == (renc is None)
    want_shapes = {"/".join(k.key for k in path): leaf.shape[1:]
                   for path, leaf in jax.tree_util.tree_leaves_with_path(
                       rcaches)}
    got_shapes = {f"{layer}/{'/'.join(keys)}": tuple(leaf.shape)
                  for layer, one in zip(layer_paths(cfg.reduced()), caches)
                  for keys, leaf in shapes._leaves(one)}
    assert got_shapes == want_shapes


def test_make_concrete_fills_specs_from_the_generator():
    cfg = get_config("qwen2-vl-72b").reduced()
    specs = shapes.batch_specs(cfg, dataclasses.replace(
        shapes.SHAPES["train_4k"], global_batch=2, seq_len=64))
    a = shapes.make_concrete(specs, np.random.default_rng(0), cfg.vocab_size)
    b = shapes.make_concrete(specs, np.random.default_rng(0), cfg.vocab_size)
    for k, spec in specs.items():
        assert a[k].shape == spec.shape and a[k].dtype == spec.dtype
        assert torch.equal(a[k], b[k])
    assert 0 <= int(a["tokens"].min()) and \
        int(a["tokens"].max()) < cfg.vocab_size


# --------------------------------------------------------------------------
# the lane collectives
# --------------------------------------------------------------------------
def _x(*shape):
    return torch.arange(float(np.prod(shape))).reshape(shape)


@pytest.mark.parametrize("spec", [P("data"), P(None, "model"),
                                  P(("data", "model")), P("model", "data"),
                                  P()])
def test_shard_and_unshard(spec):
    """Each lane gets its block (a view on a shared device); ``unshard``
    gives the tensor back."""
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    x = _x(8, 4)
    parts = spmd.shard(x, spec, mesh)
    assert parts.shape == (2, 2)
    for (i, j), part in np.ndenumerate(parts):
        # a view into x's storage: no copy
        assert part.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
    torch.testing.assert_close(spmd.unshard(parts, spec, mesh), x)
    if spec == P(("data", "model")):  # data major: lane (i, j) is block 2i+j
        for (i, j), part in np.ndenumerate(parts):
            torch.testing.assert_close(part, x[2 * (2 * i + j):][:2])


def test_all_to_all_is_tiled_in_source_order():
    """``jax.lax.all_to_all(..., tiled=True)``: lane k receives chunk k of
    every lane of its group, concatenated in the senders' order."""
    mesh = make_mesh((2, 3), ("data", "model"), devices="cpu")
    parts = spmd.lanewise(lambda i: torch.full((6, 2), float(i)),
                          spmd.axis_index(mesh, ("data", "model")))
    parts = spmd.lanewise(lambda t: t + torch.arange(6.)[:, None] / 10,
                          parts)
    out = spmd.all_to_all(parts, "model", 0, 1, mesh)
    for (i, k), got in np.ndenumerate(out):
        want = torch.cat([parts[i, s][2 * k:2 * k + 2] for s in range(3)], 1)
        torch.testing.assert_close(got, want)
    back = spmd.all_to_all(out, "model", 1, 0, mesh)
    for idx, got in np.ndenumerate(back):
        torch.testing.assert_close(got, parts[idx])


def test_reductions_are_the_same_on_every_lane():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    idx = spmd.axis_index(mesh, ("pod", "data", "model"))
    parts = spmd.lanewise(lambda i: torch.tensor([float(i), -float(i)]), idx)
    s = spmd.psum(parts, ("pod", "data"), mesh)
    mx = spmd.pmax(parts, "data", mesh)
    mean = spmd.pmean(parts, ("pod", "data"), mesh)
    for (p, d, m), got in np.ndenumerate(s):
        members = [parts[a, b, m] for a in range(2) for b in range(2)]
        torch.testing.assert_close(got, sum(members))
        torch.testing.assert_close(mean[p, d, m], sum(members) / 4)
        torch.testing.assert_close(mx[p, d, m], torch.maximum(
            parts[p, 0, m], parts[p, 1, m]))
    assert spmd.axis_index(mesh, "data")[1, 0, 1] == 0
    assert spmd.axis_index(mesh, ("pod", "model"))[1, 0, 1] == 3


def test_collectives_carry_gradients():
    """A psum then an unshard: every lane's part gets the gradient."""
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    x = torch.arange(8., requires_grad=True)
    parts = spmd.shard(x, P("data"), mesh)
    total = spmd.unshard(spmd.psum(parts, "data", mesh), P(), mesh)
    (total * torch.arange(4.)).sum().backward()
    torch.testing.assert_close(x.grad, torch.arange(4.).repeat(2))


# --------------------------------------------------------------------------
# meshes and elastic checkpoints
# --------------------------------------------------------------------------
def test_make_mesh_devices():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.first_device == torch.device("cpu")
    with pytest.raises(ValueError, match="names 3 lanes"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((4,), ("data", "model"), devices="cpu")


def test_elastic_restore_from_four_lanes_to_eight(tmp_path):
    """The reference's test_elastic_checkpoint_resharding: a tensor split
    over 4 lanes, saved, restored split over 8; the lanes hold the new
    blocks and the whole is the same, bitwise."""
    x = torch.arange(64.0).reshape(8, 8)
    mesh4 = make_mesh((4,), ("data",), devices="cpu")
    parts4 = spmd.shard(x, P("data"), mesh4)
    ck = CheckpointManager(tmp_path)
    ck.save(1, {"x": spmd.unshard(parts4, P("data"), mesh4)}, sync=True)
    ck.close()
    mesh8 = make_mesh((8,), ("data",), devices="cpu")
    sh8 = {"x": make_rules(mesh8, get_config("gemma-2b")
                           ).logical_sharding(("batch",))}
    assert tuple(sh8["x"].spec) == ("data",)
    state = {"x": torch.zeros(8, 8)}
    restored, step = CheckpointManager(tmp_path).restore(state,
                                                         shardings=sh8)
    assert step == 1 and restored["x"].shape == (8,)
    for k, part in enumerate(restored["x"]):
        torch.testing.assert_close(part, x[k:k + 1], rtol=0, atol=0)
    torch.testing.assert_close(spmd.unshard(restored["x"], P("data"), mesh8),
                               x, rtol=0, atol=0)
    torch.testing.assert_close(state["x"], x, rtol=0, atol=0)
