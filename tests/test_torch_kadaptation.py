"""Port's KAdaptation math against the JAX reference's, non-zero factors,
fp32, rtol = atol = 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.peft import kadaptation as jk
from pevit_tpu.peft import kron as jkron
from pevit_tpu_torch.peft import kadaptation as tk
from pevit_tpu_torch.peft import kron as tkron
from pevit_tpu_torch.peft.base import PeftConfig, init_peft, make_hooks

from .test_torch_bridge import PORT_TINY

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH, N_HEAD, B, N = 64, 4, 3, 5


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    p, d = tk.PHM_DIM, WIDTH // tk.PHM_DIM
    shared = {f"phm_rule{i}_{s}": _rand(rng, *shape, scale=0.05)
              for i in (1, 2) for s, shape in (("left", (p, p, 1)), ("right", (p, 1, p)))}
    layer = {"q_left": _rand(rng, p, d, 1), "q_right": _rand(rng, p, 1, d),
             "v_left": _rand(rng, p, d, 1), "v_right": _rand(rng, p, 1, d),
             "b": _rand(rng, WIDTH, scale=0.1)}
    return shared, layer


def _port(shared, layer):
    s, lyr = tk.KAdaptationShared(), tk.KAdaptationLayer(WIDTH)
    s.load_state_dict({k: torch.from_numpy(v) for k, v in shared.items()})
    lyr.load_state_dict({k: torch.from_numpy(v) for k, v in layer.items()})
    return s, lyr


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_batched_kron_sum():
    rng = np.random.default_rng(1)
    a, b = _rand(rng, 6, 4, 5), _rand(rng, 6, 3, 2)
    np.testing.assert_allclose(tkron.batched_kron_sum(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jkron.batched_kron_sum(jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_bmm():
    rng = np.random.default_rng(2)
    a, b = _rand(rng, 5, 4, 1), _rand(rng, 5, 1, 3)
    np.testing.assert_allclose(tkron.bmm(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jkron.bmm(jnp.asarray(a), jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("compat", [True, False])
def test_delta_weights(compat):
    shared, layer = _params()
    want = jk.delta_weights(_jax(shared), _jax(layer), reference_compat=compat)
    got = tk.delta_weights(*_port(shared, layer), reference_compat=compat)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("compat", [True, False])
def test_attn_delta(compat):
    """Including quirk 4: with reference_compat the (N, B, C) raw reshape
    scrambles tokens, rows and heads."""
    shared, layer = _params(3)
    x = _rand(np.random.default_rng(4), B, N, WIDTH)
    want = jk.attn_delta(_jax(shared), _jax(layer), jax.random.PRNGKey(0), jnp.asarray(x),
                         n_head=N_HEAD, reference_compat=compat)
    got = tk.attn_delta(*_port(shared, layer), None, torch.from_numpy(x), n_head=N_HEAD,
                        reference_compat=compat)
    for g, w in zip(got, want):
        assert g.shape == (B, N_HEAD, N, WIDTH // N_HEAD)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_quirk_v_reuses_wq():
    """reference_compat: the v delta does not see v_left/v_right."""
    shared, layer = _params(5)
    other = {**layer, "v_left": 7 * layer["v_left"]}
    x = torch.from_numpy(_rand(np.random.default_rng(6), B, N, WIDTH))
    dv = tk.attn_delta(*_port(shared, layer), None, x, n_head=N_HEAD)[1]
    dv_other = tk.attn_delta(*_port(shared, other), None, x, n_head=N_HEAD)[1]
    assert torch.equal(dv, dv_other)
    dv_own = tk.attn_delta(*_port(shared, other), None, x, n_head=N_HEAD,
                           reference_compat=False)[1]
    assert not torch.allclose(dv_own, dv)


def test_init_zero_factors_and_rule_range():
    m = init_peft(torch.Generator().manual_seed(0), PeftConfig(method="kadaptation"), PORT_TINY,
                  device="cpu")
    assert len(m.layers) == PORT_TINY.vision.layers
    for lyr in m.layers:
        for name in ("q_left", "q_right", "v_left", "v_right", "b"):
            assert not getattr(lyr, name).any()
    rule = m.shared.phm_rule1_left
    assert rule.abs().max() <= 0.01 and rule.abs().max() > 0
    assert sum(p.numel() for p in m.parameters()) == tk.num_params(
        PORT_TINY.vision.layers, PORT_TINY.vision.width)


def test_dropout_on_h_is_train_only_and_seeded():
    shared, layer = _port(*_params(7))
    x = torch.from_numpy(_rand(np.random.default_rng(8), B, N, WIDTH))
    hooks = make_hooks(PeftConfig(method="kadaptation"), PORT_TINY, train=True)
    eval_dq = tk.attn_delta(shared, layer, None, x, n_head=N_HEAD)[0]
    run = lambda seed: hooks.attn_delta.func(shared, layer, torch.Generator().manual_seed(seed), x,
                                             n_head=N_HEAD, train=True)[0]
    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), eval_dq)
    no_drop = tk.attn_delta(shared, layer, None, x, n_head=N_HEAD, train=True, dropout_p=0.0)[0]
    assert torch.equal(no_drop, eval_dq)


def test_unported_methods_raise():
    """Every PEFT method builds its hooks (LoRA a q/v delta, the adapter and
    Compacter a hook on the MLP output, as the reference's ``make_hooks``);
    the methods without PEFT parameters get none; only a name that no
    package knows raises."""
    from pevit_tpu.peft import PeftConfig as JaxPeftConfig
    from pevit_tpu.peft.base import make_hooks as jax_make_hooks

    from .test_torch_bridge import TINY

    for method in ("kadaptation", "lora", "adapter", "compacter"):
        for train in (False, True):
            got = make_hooks(PeftConfig(method=method), PORT_TINY, train=train)
            want = jax_make_hooks(JaxPeftConfig(method=method), TINY, train=train)
            assert (got.attn_delta is None, got.mlp_post is None) == (
                want.attn_delta is None, want.mlp_post is None), method
            hook = got.attn_delta or got.mlp_post
            assert hook.keywords["train"] is train
    for method in ("linear_probe", "full_finetune", "zeroshot"):
        assert make_hooks(PeftConfig(method=method), PORT_TINY, train=False) is None
        assert init_peft(torch.Generator(), PeftConfig(method=method), PORT_TINY) is None
    with pytest.raises(ValueError, match="nope"):
        PeftConfig(method="nope")
