"""The port's LLM layers against the reference's JAX functions, on the same
numpy inputs (made from a seed), on the CPU.

Float32 comparisons hold to ``atol = rtol = 1e-5`` unless a test says
otherwise: the same arithmetic, summed or approximated (sin, exp) in
another order.  The bfloat16 activations must be bitwise equal: they are
where torch's defaults differ from the reference (exact vs tanh GELU, one
rounding vs one per operation).  The MoE router's dispatch must be exactly
equal, with tokens dropped: a stable sort decides which ones; its
routing weights agree to 1e-6 (torch's and XLA's ``exp`` differ in the last
bit of a float32 softmax).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import MambaConfig, MoEConfig, XLSTMConfig
from repro.dist.context import ShardCtx
from repro.models import attention as r_att
from repro.models import ffn as r_ffn
from repro.models import moe as r_moe
from repro.models import nn as r_nn
from repro.models import ssm as r_ssm
from repro.models import xlstm as r_xl
from repro_torch.configs.base import MambaConfig as PMambaConfig
from repro_torch.configs.base import MoEConfig as PMoEConfig
from repro_torch.configs.base import XLSTMConfig as PXLSTMConfig
from repro_torch.models import attention as p_att
from repro_torch.models import ffn as p_ffn
from repro_torch.models import moe as p_moe
from repro_torch.models import nn as p_nn
from repro_torch.models import ssm as p_ssm
from repro_torch.models import xlstm as p_xl
from repro_torch.models.convert import to_tensor

CTX = ShardCtx(None, {}, {})
F32 = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a):
    return to_tensor(np.asarray(a))


def port_module(module, ref_params):
    """Load a reference Param tree into the port's module of that layer."""
    values, _ = r_nn.split_params(ref_params)
    flat = {}

    def walk(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                flat[prefix + key] = t(val)
    walk(values)
    module.load_state_dict(flat, strict=True)
    return module


# --------------------------------------------------------------------------
# norms and activations
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    x = rng(1).standard_normal((3, 5, 64)).astype(np.float32) * 3
    gamma = rng(2).standard_normal(64).astype(np.float32) * 0.1
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(r_nn.rms_norm(xj, jnp.asarray(gamma))).astype(np.float32)
    got = p_nn.rms_norm(t(xj), torch.from_numpy(gamma)).float().numpy()
    np.testing.assert_allclose(got, want, **(F32 if dtype == "float32"
                                             else dict(atol=0, rtol=2**-7)))


def test_layer_norm_matches_reference():
    """The population variance (``jnp.var``), not torch's default
    ``correction=1``, which is 64/63 of it here."""
    x = rng(1).standard_normal((3, 5, 64)).astype(np.float32) * 2 + 0.5
    gamma = 1 + rng(2).standard_normal(64).astype(np.float32) * 0.1
    beta = rng(3).standard_normal(64).astype(np.float32) * 0.1
    want = r_nn.layer_norm(jnp.asarray(x), jnp.asarray(gamma),
                           jnp.asarray(beta))
    got = p_nn.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                          torch.from_numpy(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form: 0.841192 at 1.0, where
    the exact GELU gives 0.841345."""
    got = float(p_nn.gelu(torch.tensor([1.0]))[0])
    assert abs(got - float(jax.nn.gelu(1.0))) < 1e-6
    assert abs(got - 0.841192) < 1e-6


@pytest.mark.parametrize("name", ["gelu", "silu", "softplus", "sigmoid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_match_reference(name, dtype):
    """Bitwise in bf16 (each operation rounded, constants in bf16, as the
    reference computes); to 1e-6 in float32."""
    x = (rng(4).standard_normal(20000) * 4).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(getattr(jax.nn, name)(xj))
    got = getattr(p_nn, name)(t(xj))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                      want.view(np.uint16))
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "relu2"])
def test_ffn_matches_reference(mlp_type):
    kg = r_nn.KeyGen(jax.random.PRNGKey(0))
    ref = r_ffn.init_ffn(kg, 32, 96, mlp_type, jnp.float32)
    mod = port_module(p_ffn.FFN(p_nn.Init(CPU), 32, 96, mlp_type,
                                torch.float32), ref)
    x = rng(5).standard_normal((2, 7, 32)).astype(np.float32) * 2
    want = r_ffn.ffn_apply(ref, jnp.asarray(x), mlp_type, CTX)
    got = p_ffn.ffn_apply(mod, torch.from_numpy(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --------------------------------------------------------------------------
# RoPE and attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["full", "partial", "mrope"])
def test_apply_rope_matches_reference(kind):
    B, S, H, hd = 2, 9, 3, 32
    x = rng(6).standard_normal((B, S, H, hd)).astype(np.float32)
    frac = 0.25 if kind == "partial" else 1.0
    sections = p_att.mrope_sections(hd) if kind == "mrope" else None
    if kind == "mrope":  # three position streams (t, h, w)
        pos = rng(7).integers(0, 50, (B, S, 3))
    else:
        pos = np.broadcast_to(np.arange(S) + 40, (B, S)).copy()
    want = r_att.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction=frac,
                            theta=1e4, mrope_sections=sections)
    got = p_att.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           fraction=frac, theta=1e4, mrope_sections=sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if kind == "partial":  # the unrotated tail passes through
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


@pytest.mark.parametrize("case", ["causal", "kv_len", "window",
                                  "ring", "cross"])
def test_flash_attention_matches_reference(case):
    """GQA (6 query heads over 2 KV heads), Skv = 21 in blocks of 8 (the
    last one short)."""
    B, Sq, H, K, hd, Skv, bk = 2, 5, 6, 2, 16, 21, 8
    r = rng(8)
    q = r.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = r.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = r.standard_normal((B, Skv, K, hd)).astype(np.float32)
    kw = dict(block_k=bk)
    if case == "causal":
        kw.update(causal=True, q_offset=16)
    elif case == "kv_len":
        kw.update(causal=True, q_offset=12, kv_len=17)
    elif case == "window":
        kw.update(causal=True, q_offset=16, window=6)
    elif case == "ring":  # slots out of order, four empty (-1)
        slots = np.full(Skv, -1)
        slots[:17] = r.permutation(17) + 3
        kw.update(causal=True, q_offset=15, window=7,
                  kv_positions=slots)
    else:
        kw.update(causal=False)
    jkw = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b)
           for a, b in kw.items()}
    pkw = {a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b)
           for a, b in kw.items()}
    want = r_att.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **jkw)
    got = p_att.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def test_route_drops_tokens_like_the_reference():
    """64 tokens, top-2 of 4 experts, capacity 8 (capacity_factor 0.25):
    most slots overflow, and which ones stay depends on the stable sort."""
    moe = dict(num_experts=4, top_k=2, d_ff_expert=16, capacity_factor=0.25)
    T, d = 64, 16
    cap = p_moe.capacity_of(PMoEConfig(**moe), T)
    assert cap == 8
    router = rng(9).standard_normal((d, 4)).astype(np.float32)
    xf = rng(10).standard_normal((T, d)).astype(np.float32)
    w_idx, w_comb, w_aux = r_moe._route(jnp.asarray(router), jnp.asarray(xf),
                                        MoEConfig(**moe), cap)
    g_idx, g_comb, g_aux = p_moe._route(torch.from_numpy(router),
                                        torch.from_numpy(xf),
                                        PMoEConfig(**moe), cap)
    assert (np.asarray(w_idx) >= 0).sum() < T * 2  # tokens were dropped
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(g_comb.numpy(), np.asarray(w_comb), atol=0,
                               rtol=1e-6)
    np.testing.assert_allclose(float(g_aux), float(w_aux), rtol=1e-6)


@pytest.mark.parametrize("mlp_type,shared,cf", [
    ("swiglu", 0, 8.0), ("gelu", 0, 8.0), ("swiglu", 1, 8.0),
    ("swiglu", 0, 0.5)])
def test_moe_apply_matches_reference(mlp_type, shared, cf):
    kw = dict(num_experts=4, top_k=2, d_ff_expert=24, capacity_factor=cf,
              num_shared_experts=shared)
    kg = r_nn.KeyGen(jax.random.PRNGKey(1))
    ref = r_moe.init_moe(kg, 32, MoEConfig(**kw), mlp_type, jnp.float32)
    mod = port_module(p_moe.MoE(p_nn.Init(CPU), 32, PMoEConfig(**kw),
                                mlp_type, torch.float32), ref)
    x = rng(11).standard_normal((2, 9, 32)).astype(np.float32)
    want, w_aux = r_moe.moe_apply(ref, jnp.asarray(x), MoEConfig(**kw),
                                  mlp_type, CTX)
    got, g_aux = p_moe.moe_apply(mod, torch.from_numpy(x), PMoEConfig(**kw),
                                 mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(g_aux), float(w_aux), rtol=1e-6)


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk", [(37, 16), (16, 16), (5, 256)])
def test_ssm_scan_chunked_matches_reference(S, chunk):
    r = rng(12)
    B, di, N = 2, 12, 4
    dA = r.uniform(0.3, 1.0, (B, S, di, N)).astype(np.float32)
    dBx = r.standard_normal((B, S, di, N)).astype(np.float32)
    Cs = r.standard_normal((B, S, N)).astype(np.float32)
    h0 = r.standard_normal((B, di, N)).astype(np.float32)
    wy, wh = r_ssm._ssm_scan_chunked(*(jnp.asarray(a) for a in
                                       (dA, dBx, Cs, h0)), chunk, False)
    gy, gh = p_ssm._ssm_scan_chunked(*(torch.from_numpy(a) for a in
                                       (dA, dBx, Cs, h0)), chunk)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **F32)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **F32)


def test_mamba_prefill_then_decode_matches_reference():
    mc = dict(d_state=8, d_conv=4, expand=2)
    kg = r_nn.KeyGen(jax.random.PRNGKey(2))
    ref = r_ssm.init_mamba(kg, 32, MambaConfig(**mc), jnp.float32)
    mod_cfg = PMambaConfig(**mc)
    mod = port_module(p_ssm.Mamba(p_nn.Init(CPU), 32, mod_cfg, torch.float32),
                      ref)
    x = rng(13).standard_normal((2, 21, 32)).astype(np.float32)
    want, wst = r_ssm.mamba_apply(ref, jnp.asarray(x[:, :20]),
                                  MambaConfig(**mc), CTX, chunk=8)
    got, gst = p_ssm.mamba_apply(mod, torch.from_numpy(x[:, :20]),
                                 mod_cfg, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want1, _ = r_ssm.mamba_apply(ref, jnp.asarray(x[:, 20:]),
                                 MambaConfig(**mc), CTX, state=wst)
    got1, _ = p_ssm.mamba_apply(mod, torch.from_numpy(x[:, 20:]), mod_cfg,
                                state=gst)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **F32)


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------
def _mlstm_inputs(S, seed=14):
    r = rng(seed)
    B, H, hd = 2, 3, 8
    q, k, v = (r.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    li = r.standard_normal((B, S, H)).astype(np.float32) * 2
    lf = np.log(1 / (1 + np.exp(-(r.standard_normal((B, S, H)) + 2)))
                ).astype(np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("S,chunk", [(37, 16), (16, 16)])
def test_mlstm_chunked_matches_reference_and_steps(S, chunk):
    """Against the reference's chunked form (a short last chunk padded with
    identity steps), and against the port's own step, repeated."""
    q, k, v, li, lf = _mlstm_inputs(S)
    B, _, H, hd = q.shape
    wy, wst = r_xl._mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                                  r_xl.init_mlstm_state(B, H, hd), chunk,
                                  False)
    args = [torch.from_numpy(a) for a in (q, k, v, li, lf)]
    gy, gst = p_xl._mlstm_chunked(*args, p_xl.init_mlstm_state(B, H, hd),
                                  chunk)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-4,
                               rtol=1e-4)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   atol=1e-4, rtol=1e-4)
    st = p_xl.init_mlstm_state(B, H, hd)
    ys = []
    for i in range(S):
        y, st = p_xl._mlstm_step(*(a[:, i] for a in args), st)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), gy.numpy(),
                               atol=1e-4, rtol=1e-4)
    assert np.isfinite(gy.numpy()).all()


def test_mlstm_and_slstm_apply_match_reference():
    xc = dict(slstm_every=2, chunk_size=8)
    kg = r_nn.KeyGen(jax.random.PRNGKey(3))
    d, H = 32, 4
    rm = r_xl.init_mlstm(kg, d, H, XLSTMConfig(**xc), jnp.float32)
    rs = r_xl.init_slstm(kg, d, H, XLSTMConfig(**xc), jnp.float32)
    pxc = PXLSTMConfig(**xc)
    pm = port_module(p_xl.MLSTM(p_nn.Init(CPU), d, H, pxc, torch.float32), rm)
    ps = port_module(p_xl.SLSTM(p_nn.Init(CPU), d, H, pxc, torch.float32), rs)
    x = rng(15).standard_normal((2, 19, d)).astype(np.float32)
    want, wst = r_xl.mlstm_apply(rm, jnp.asarray(x), H, XLSTMConfig(**xc),
                                 CTX)
    got, gst = p_xl.mlstm_apply(pm, torch.from_numpy(x), H, pxc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want, wst = r_xl.slstm_apply(rs, jnp.asarray(x), H, CTX)
    got, gst = p_xl.slstm_apply(ps, torch.from_numpy(x), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for key in ("c", "n", "h", "m"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **F32)


def test_bfloat16_weights_cross_as_bits():
    a = (rng(16).standard_normal((3, 4)) * 100).astype(ml_dtypes.bfloat16)
    got = to_tensor(a)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  a.view(np.uint16))
