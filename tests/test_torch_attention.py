"""Port's attention plain version against the reference's XLA core and its
Pallas kernel (interpret mode), rtol 1e-4 / atol 1e-5 as the reference's own
kernel test.  B*H = 3, 6 and 12 are not multiples of the Pallas kernel's
8 (batch, head) pairs per program, so its padding is exercised too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.ops import attention as ja
from pevit_tpu_torch.ops import attention as ta

TOL = dict(rtol=1e-4, atol=1e-5)
BH = [(1, 3), (2, 3), (3, 4)]


def _qkv(b, h, n, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.1 * rng.standard_normal((b, h, n, hd))).astype(np.float32)
    k = (0.1 * rng.standard_normal((b, h, n, hd))).astype(np.float32)
    v = rng.standard_normal((b, h, n, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h", BH)
@pytest.mark.parametrize("n", [5, 50, 197])
def test_ref_matches_xla_attention(b, h, n):
    q, k, v = _qkv(b, h, n)
    want = ja._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h", BH)
@pytest.mark.parametrize("n", [5, 50, 197])
def test_ref_matches_pallas_kernel(b, h, n):
    q, k, v = _qkv(b, h, n, seed=1)
    want = ja._fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)  # interpret mode
    got = ta.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [5, 50])
def test_core_bnhd_matches_reference_core(n):
    """attention_core takes (B, N, H, hd), as the reference's does."""
    q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in _qkv(2, 3, n, seed=2))
    want = ja.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = ta.attention_core(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel never falls back: CPU tensors are refused, not computed."""
    q, k, v = map(torch.from_numpy, (x.transpose(0, 2, 1, 3).copy() for x in _qkv(1, 2, 5)))
    before = ta.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.attention_fwd(q, k, v)
    assert ta.KERNEL.launches == before


def test_core_refuses_other_devices():
    q = torch.zeros(1, 5, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ta.attention_core(q, q, q)
