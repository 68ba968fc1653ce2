"""Port's core/layers.py against the JAX reference's, fp32, rtol = atol = 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core import layers as jl
from pevit_tpu_torch.core import layers as tl

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, C, H = 3, 7, 64, 4


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _block_params(rng):
    return {
        "attn": {"in_proj": {"kernel": _rand(rng, C, 3 * C, scale=C ** -0.5),
                             "bias": _rand(rng, 3 * C, scale=0.1)},
                 "out_proj": {"kernel": _rand(rng, C, C, scale=C ** -0.5),
                              "bias": _rand(rng, C, scale=0.1)}},
        "mlp": {"c_fc": {"kernel": _rand(rng, C, 4 * C, scale=C ** -0.5),
                         "bias": _rand(rng, 4 * C, scale=0.1)},
                "c_proj": {"kernel": _rand(rng, 4 * C, C, scale=(4 * C) ** -0.5),
                           "bias": _rand(rng, C, scale=0.1)}},
        "ln_1": {"scale": 1 + _rand(rng, C, scale=0.1), "bias": _rand(rng, C, scale=0.1)},
        "ln_2": {"scale": 1 + _rand(rng, C, scale=0.1), "bias": _rand(rng, C, scale=0.1)},
    }


def _module(cls, params):
    m = cls(C)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = torch.from_numpy(v)

    walk(params, "")
    m.load_state_dict(flat)
    return m


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _delta_fns(rng):
    """Same linear q/v delta on both sides, (B, H, N, hd) output."""
    mq, mv = _rand(rng, C, C, scale=0.1), _rand(rng, C, C, scale=0.1)

    def jfn(x):
        b, n, _ = x.shape
        f = lambda m: (x @ jnp.asarray(m)).reshape(b, n, H, C // H).transpose(0, 2, 1, 3)
        return f(mq), f(mv)

    def tfn(x):
        b, n, _ = x.shape
        f = lambda m: (x @ torch.from_numpy(m)).reshape(b, n, H, C // H).transpose(1, 2)
        return f(mq), f(mv)

    return jfn, tfn


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    rng = np.random.default_rng(0)
    x, s, b = _rand(rng, B, N, C, scale=3.0), 1 + _rand(rng, C), _rand(rng, C)
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps)
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quick_gelu():
    x = _rand(np.random.default_rng(1), 1000, scale=4.0)
    np.testing.assert_allclose(tl.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.quick_gelu(jnp.asarray(x))), **TOL)


def test_mlp():
    rng = np.random.default_rng(2)
    p = _block_params(rng)["mlp"]
    x = _rand(rng, B, N, C)
    got = tl.mlp(_module(tl.MLP, p), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jl.mlp(_jax(p), jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("with_delta", [False, True])
def test_multi_head_attention(with_delta):
    rng = np.random.default_rng(3)
    p = _block_params(rng)["attn"]
    x = _rand(rng, B, N, C)
    jfn, tfn = _delta_fns(rng) if with_delta else (None, None)
    want = jl.multi_head_attention(_jax(p), jnp.asarray(x), n_head=H, qv_delta_fn=jfn)
    got = tl.multi_head_attention(_module(tl.Attention, p), torch.from_numpy(x), n_head=H,
                                  qv_delta_fn=tfn)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("ln_eps", [1e-5, 1e-12])
def test_residual_attention_block(with_delta, ln_eps):
    """The port's block always takes the fused-MLP route (its plain version
    on the CPU); the reference's block here is the unfused composite."""
    rng = np.random.default_rng(4)
    p = _block_params(rng)
    x = _rand(rng, B, N, C)
    jfn, tfn = _delta_fns(rng) if with_delta else (None, None)
    want = jl.residual_attention_block(_jax(p), jnp.asarray(x), n_head=H, qv_delta_fn=jfn,
                                       ln_eps=ln_eps)
    got = tl.residual_attention_block(_module(tl.ResidualAttentionBlock, p), torch.from_numpy(x),
                                      n_head=H, qv_delta_fn=tfn, ln_eps=ln_eps)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_kv_stay_views_of_the_packed_projection(monkeypatch):
    """Without a delta, k and v reach the attention core as strided views of
    the packed qkv projection (no copies), in (B, N, H, hd)."""
    seen = {}
    real = tl.attention_core

    def spy(q, k, v):
        seen.update(q=q, k=k, v=v)
        return real(q, k, v)

    monkeypatch.setattr(tl, "attention_core", spy)
    rng = np.random.default_rng(5)
    m = _module(tl.Attention, _block_params(rng)["attn"])
    tl.multi_head_attention(m, torch.from_numpy(_rand(rng, B, N, C)), n_head=H)
    assert seen["k"].shape == (B, N, H, C // H)
    assert seen["k"].stride() == (N * 3 * C, 3 * C, C // H, 1)
    assert seen["v"].stride() == (N * 3 * C, 3 * C, C // H, 1)
