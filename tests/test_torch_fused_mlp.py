"""Port's fused residual MLP plain version against the reference's Pallas
kernel (interpret mode), rtol = atol = 2e-5 as the reference's own test.
The reference kernel fixes the LayerNorm eps at 1e-5; the port's takes it as
an argument, held here against the reference's unfused layer_norm(eps) +
mlp + residual."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core.layers import layer_norm, mlp
from pevit_tpu.ops.fused_mlp import fused_mlp_residual as jax_fused
from pevit_tpu_torch.ops import fused_mlp as tf

TOL = dict(rtol=2e-5, atol=2e-5)
C, F = 128, 512
NAMES = ("ln_scale", "ln_bias", "wfc", "bfc", "wproj", "bproj")


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float32)
    return {"ln_scale": 1.0 + 2 * f32(C), "ln_bias": 2 * f32(C), "wfc": f32(C, F),
            "bfc": f32(F), "wproj": f32(F, C), "bproj": f32(C)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(p, x, **kw):
    args = [torch.from_numpy(x)] + [torch.from_numpy(p[n]) for n in NAMES]
    return tf.fused_mlp_residual(*args, **kw).numpy()


@pytest.mark.parametrize("b,n", [(3, 12), (5, 7)])
def test_matches_pallas_kernel(b, n):
    """(5, 7) rows do not fill the reference kernel's 256-row tile."""
    p, x = _params(), _x((b, n, C), seed=b)
    want = jax_fused(jnp.asarray(x), *(jnp.asarray(p[k]) for k in NAMES), True)
    np.testing.assert_allclose(_port(p, x), np.asarray(want), **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_eps_matches_unfused_reference(eps):
    p, x = _params(1), _x((3, 12, C), seed=7)
    u = layer_norm(jnp.asarray(x), jnp.asarray(p["ln_scale"]), jnp.asarray(p["ln_bias"]), eps=eps)
    want = jnp.asarray(x) + mlp({"c_fc": {"kernel": jnp.asarray(p["wfc"]), "bias": jnp.asarray(p["bfc"])},
                                 "c_proj": {"kernel": jnp.asarray(p["wproj"]),
                                            "bias": jnp.asarray(p["bproj"])}}, u)
    np.testing.assert_allclose(_port(p, x, eps=eps), np.asarray(want), **TOL)


def test_eps_is_used():
    """A near-constant row makes the LayerNorm epsilon visible."""
    p = _params(2)
    x = np.full((1, 2, C), 0.5, np.float32) + 1e-4 * _x((1, 2, C), seed=3)
    assert np.abs(_port(p, x, eps=1e-5) - _port(p, x, eps=1e-12)).max() > 1e-3


def test_kernel_wrapper_refuses_cpu_tensors():
    p, x = _params(), _x((2, 3, C), seed=4)
    before = tf.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.fused_mlp_fwd(torch.from_numpy(x), *(torch.from_numpy(p[k]) for k in NAMES))
    assert tf.KERNEL.launches == before


# the four widths the kernels took before any C did, and the widths of
# ViT-Ti, ViT-S, ViT-H and ViT-g and a tail width (200) that fills no tile
WORKSPACE_WIDTHS = [256, 512, 768, 1024, 192, 200, 384, 1280, 1408]


@pytest.mark.parametrize("R", [1, 400, 5800, 12800])
@pytest.mark.parametrize("width", WORKSPACE_WIDTHS)
def test_fwd_workspace_bytes(R, width):
    """Both bodies carve u (R x C) and then g (R x F) in x's dtype, and g's
    16-byte loads need it to start aligned; the float32 body then carves
    the weights' four TF32 planes (C x F float32 each), each aligned."""
    F = 4 * width
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        u, g = R * width * size, R * F * size
        planes = 4 * width * F * 4 if dtype == torch.float32 else 0
        assert tf.fwd_workspace_bytes(dtype, R, width, F) == u + g + planes
        assert u % 16 == 0 and g % 16 == 0
        offsets = [off for _, off, _ in tf.fwd_workspace_layout(dtype, R, width, F)]
        want = [0, u] + ([u + g + i * width * F * 4 for i in range(4)] if planes else [])
        assert offsets == want
