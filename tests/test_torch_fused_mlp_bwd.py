"""The fused residual MLP's backward: the port's dx, through its autograd
Function on the CPU (the plain backward the card's kernel is held to),
against jax.grad of the reference's fused_mlp_residual, whose custom VJP
runs the Pallas backward kernel in interpret mode; rtol = atol = 5e-5, the
reference's own tolerance for that kernel.  An eps other than 1e-5 (which
the reference kernel fixes) is held against autograd of the unfused plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ops.fused_mlp import fused_mlp_residual as jax_fused
from pevit_tpu_torch.core import layers as tl
from pevit_tpu_torch.ops import fused_mlp as tf

from .test_torch_fused_mlp import NAMES, C, _params, _x

TOL = dict(rtol=5e-5, atol=5e-5)


def _dy(shape, seed):
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(np.float32)


def _port_dx(p, x, dy, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    y = tf.fused_mlp_residual(xt, *(torch.from_numpy(p[n]) for n in NAMES), **kw)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    return dx.numpy()


@pytest.mark.parametrize("b,n", [(3, 12), (5, 7), (2, 200)])
def test_dx_matches_pallas_backward(b, n):
    """(5, 7) and (2, 200) rows do not fill the reference's 256-row tile."""
    p, x, dy = _params(3), _x((b, n, C), seed=b), _dy((b, n, C), seed=n)
    w = [jnp.asarray(p[k]) for k in NAMES]
    _, vjp = jax.vjp(lambda xx: jax_fused(xx, *w, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(_port_dx(p, x, dy), np.asarray(want), **TOL)


def test_bwd_ref_is_the_functions_backward():
    p, x, dy = _params(4), _x((2, 9, C), seed=5), _dy((2, 9, C), seed=5)
    args = [torch.from_numpy(p[n]) for n in NAMES[:-1]]
    want = tf.fused_mlp_bwd_ref(torch.from_numpy(dy), torch.from_numpy(x), *args).numpy()
    np.testing.assert_array_equal(_port_dx(p, x, dy), want)


@pytest.mark.parametrize("eps", [1e-5, 1e-12, 1e-3])
def test_eps_matches_autograd_of_unfused(eps):
    p, x, dy = _params(5), _x((3, 6, C), seed=6), _dy((3, 6, C), seed=6)
    xt = torch.from_numpy(x).requires_grad_()
    ln = tl.layer_norm(xt, torch.from_numpy(p["ln_scale"]), torch.from_numpy(p["ln_bias"]), eps=eps)
    h = ln @ torch.from_numpy(p["wfc"]) + torch.from_numpy(p["bfc"])
    y = xt + tl.quick_gelu(h) @ torch.from_numpy(p["wproj"]) + torch.from_numpy(p["bproj"])
    (want,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    np.testing.assert_allclose(_port_dx(p, x, dy, eps=eps), want.numpy(), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_function_raises_when_a_weight_requires_grad(name):
    """Frozen-weight contract: a weight that asks for a gradient is refused
    at backward time, never given a silent None."""
    p, x = _params(6), _x((2, 3, C), seed=7)
    xt = torch.from_numpy(x).requires_grad_()
    w = {n: torch.from_numpy(p[n]).requires_grad_(n == name) for n in NAMES}
    y = tf.fused_mlp_residual(xt, *(w[n] for n in NAMES))
    with pytest.raises(RuntimeError, match=name):
        y.sum().backward()


def test_bwd_launcher_refuses_cpu_tensors():
    p, x = _params(), _x((2, 3, C), seed=4)
    before = tf.BWD_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.fused_mlp_bwd(torch.from_numpy(x), torch.from_numpy(x),
                         *(torch.from_numpy(p[k]) for k in NAMES[:-1]))
    assert tf.BWD_KERNEL.launches == before


def test_bwd_kernel_is_registered():
    from pevit_tpu_torch.ops import KERNELS

    assert tf.BWD_KERNEL in KERNELS
    assert tf.BWD_KERNEL.source.name == "fused_mlp_bwd.cu" and tf.BWD_KERNEL.source.is_file()
    assert tf.BWD_KERNEL.replaces == "pevit_tpu/ops/fused_mlp.py:122"
