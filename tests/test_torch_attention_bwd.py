"""The attention core's backward: dq, dk and dv through the port's autograd
Function on the CPU against jax.vjp of the reference's ``_fused`` (the
Pallas forward in interpret mode plus its plain-XLA ``_fused_bwd``), fp32,
rtol = atol = 1e-5; also with k and v as strided views of a packed qkv
tensor, as the tower passes them.  And the repair this slice makes: the
outputs of ``attention_core`` and ``fused_mlp_residual`` carry the
Functions' backwards, so a loss reaches the KAdaptation parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ops import attention as ja
from pevit_tpu_torch.core import layers as tl
from pevit_tpu_torch.ops import attention as ta
from pevit_tpu_torch.ops import fused_mlp as tf

TOL = dict(rtol=1e-5, atol=1e-5)


def _bnhd(b, n, h, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.1 * rng.standard_normal((b, n, h, hd))).astype(np.float32)
    k = (0.1 * rng.standard_normal((b, n, h, hd))).astype(np.float32)
    v = rng.standard_normal((b, n, h, hd)).astype(np.float32)
    g = rng.standard_normal((b, n, h, hd)).astype(np.float32)
    return q, k, v, g


def _jax_grads(q, k, v, g):
    """Reference VJP in its (B, H, N, hd) layout, returned as (B, N, H, hd)."""
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(lambda a, b, c: ja._fused(a, b, c, True), t(q), t(k), t(v))
    return [np.asarray(d).transpose(0, 2, 1, 3) for d in vjp(t(g))]


@pytest.mark.parametrize("b,n,h", [(1, 5, 3), (2, 50, 3), (3, 17, 4)])
def test_grads_match_reference_vjp(b, n, h):
    q, k, v, g = _bnhd(b, n, h, seed=n)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ta.attention_core(qt, kt, vt)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for name, a, w in zip("qkv", got, _jax_grads(q, k, v, g)):
        assert a.shape == (b, n, h, 64)
        np.testing.assert_allclose(a.numpy(), w, err_msg=f"d{name}", **TOL)


def test_grads_route_into_packed_qkv_views():
    """k and v as strided (B, N, H, hd) views of one packed (B, N, 3C)
    tensor: autograd writes each gradient into its own columns."""
    b, n, h, hd = 2, 7, 3, 64
    c = h * hd
    q, k, v, g = _bnhd(b, n, h, seed=9)
    packed = torch.from_numpy(np.concatenate([x.reshape(b, n, c) for x in (q, k, v)], -1))
    packed.requires_grad_()
    qs, ks, vs = (x.reshape(b, n, h, hd) for x in packed.split(c, dim=-1))
    assert ks.stride() == (n * 3 * c, 3 * c, hd, 1)
    out = ta.attention_core(qs, ks, vs)
    (d_packed,) = torch.autograd.grad(out, packed, torch.from_numpy(g))
    want = np.concatenate([d.reshape(b, n, c) for d in _jax_grads(q, k, v, g)], -1)
    np.testing.assert_allclose(d_packed.numpy(), want, **TOL)


def test_bwd_ref_bf16_rounds_to_input_dtype():
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in _bnhd(2, 9, 2, seed=3))
    dq, dk, dv = ta.attention_bwd_ref(q, k, v, g)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    want = ta.attention_bwd_ref(q.float(), k.float(), v.float(), g.float())
    for a, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.float().numpy(), w.to(torch.bfloat16).float().numpy())


def test_outputs_carry_the_functions_backward():
    """The repair of the serving slice's wrappers: the attention and fused
    MLP outputs have the Functions' backwards as grad_fn, on the CPU as on
    the card, so gradients reach their inputs."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _bnhd(1, 5, 2))
    assert type(ta.attention_core(q, k, v).grad_fn).__name__ == "_AttentionCoreBackward"
    C = 64
    x = torch.randn(2, 3, C, requires_grad=True)
    w = [torch.ones(C), torch.zeros(C), torch.randn(C, 4 * C) * 0.1, torch.zeros(4 * C),
         torch.randn(4 * C, C) * 0.1, torch.zeros(C)]
    y = tf.fused_mlp_residual(x, *w)
    assert type(y.grad_fn).__name__ == "_FusedMlpResidualBackward"
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_block_gradient_reaches_the_delta():
    """Through one block (both Functions on its path), the q/v delta and the
    block input get non-zero gradients; the frozen weights get none."""
    C, H = 64, 2
    torch.manual_seed(0)
    blk = tl.ResidualAttentionBlock(C)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.1)
    blk.requires_grad_(False)
    x = torch.randn(2, 5, C, requires_grad=True)
    delta = torch.randn(2, H, 5, C // H, requires_grad=True)
    y = tl.residual_attention_block(blk, x, n_head=H, qv_delta_fn=lambda _: (delta, delta))
    gx, gd = torch.autograd.grad(y.square().sum(), (x, delta))
    assert gx.abs().sum() > 0 and gd.abs().sum() > 0
    assert all(p.grad is None for p in blk.parameters())
