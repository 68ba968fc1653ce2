"""Port's classification head against the JAX reference's, fp32, 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.train import head as jh
from pevit_tpu_torch.train import head as th

TOL = dict(rtol=1e-5, atol=1e-5)
B, D, K = 6, 16, 5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (2 + 3 * rng.standard_normal((B, D))).astype(np.float32)
    state = {"mean": (0.1 * rng.standard_normal(D)).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    return x, state, mask


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("train,masked", [(False, False), (True, False), (True, True)])
def test_batch_norm(train, masked):
    x, state, mask = _inputs()
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want_y, want_s = jh.batch_norm(jnp.asarray(x), _j(state), train=train, mask=jm)
    got_y, got_s = th.batch_norm(torch.from_numpy(x), _t(state), train=train, mask=tm)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), **TOL)


def test_init_bn_state():
    s = th.init_bn_state(D, device="cpu")
    assert torch.equal(s["mean"], torch.zeros(D)) and torch.equal(s["var"], torch.ones(D))


@pytest.mark.parametrize("mode", ["none", "pretrained", "ln_cls", "clip"])
def test_init_head_logit_scale_modes(mode):
    want = jh.init_head(jax.random.PRNGKey(0), D, K, logit_scale_init=mode, backbone_logit_scale=3.5)
    got = th.init_head(torch.Generator().manual_seed(0), D, K, logit_scale_init=mode,
                       backbone_logit_scale=3.5, device="cpu")
    np.testing.assert_allclose(got.logit_scale.item(), float(want["logit_scale"]), rtol=1e-6)


def test_init_head_random_and_text_weights():
    got = th.init_head(torch.Generator().manual_seed(0), D, K, device="cpu")
    bound = 1.0 / np.sqrt(D)
    for p in (got.linear.kernel, got.linear.bias):
        assert p.abs().max() <= bound and p.std() > 0
    assert got.linear.kernel.shape == (D, K)
    w = np.random.default_rng(1).standard_normal((D, K)).astype(np.float32)
    text = th.init_head(None, D, K, text_init_weights=w, device="cpu")
    assert np.array_equal(text.linear.kernel.detach().numpy(), w)
    assert not text.linear.bias.any()


@pytest.mark.parametrize("use_bn,normalize,scale", [
    (True, False, False), (False, False, False), (True, True, False), (True, False, True),
])
def test_head_forward(use_bn, normalize, scale):
    x, state, _ = _inputs(2)
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal((D, K)).astype(np.float32)
    bias = rng.standard_normal(K).astype(np.float32)
    jhead = {"linear": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
             "logit_scale": jnp.asarray(0.7, jnp.float32)}
    thead = th.Head(D, K)
    thead.load_state_dict({"linear.kernel": torch.from_numpy(kernel),
                           "linear.bias": torch.from_numpy(bias),
                           "logit_scale": torch.tensor(0.7)})
    kw = dict(train=False, use_bn=use_bn, normalize_feature=normalize, apply_logit_scale=scale)
    want, _ = jh.head_forward(jhead, _j(state), jnp.asarray(x), **kw)
    got, _ = th.head_forward(thead, _t(state), torch.from_numpy(x), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
