"""The paper's three baselines, LoRA, the bottleneck adapter and Compacter,
against pevit_tpu/peft on the CPU:

* fp32: LoRA's ``attn_delta`` (with and without the raw-reshape scramble),
  the adapter's and Compacter's ``mlp_post``, ``phm_linear`` and
  ``gelu_new`` within 1e-5 of the largest value, with seeded non-zero
  parameters (LoRA's B is zero at init, which would test nothing);
* bf16: the same functions within one bf16 ulp of JAX's on the CPU, at most
  1% of the elements differing, as tests/test_torch_bf16_rounding.py holds
  the kernels; each with a control that moves one rounding point and
  differs in far more elements;
* the init: shapes as the JAX trees' per-layer slices, zeros and ones where
  JAX has them, the random leaves' distributions;
* ``peft_num_params`` equal to JAX's at ViT-B/32, and to the modules' own
  counts;
* the bridge round trip of a JAX bundle of each method, bit for bit;
* a block with an ``mlp_post`` hook takes the unfused MLP even with
  ``use_fused_mlp=True``, and its output differs from the block's without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core import CLIPSpec as JaxCLIPSpec
from pevit_tpu.core import layers as jlayers
from pevit_tpu.peft import PeftConfig as JaxPeftConfig
from pevit_tpu.peft import adapter as jad
from pevit_tpu.peft import base as jbase
from pevit_tpu.peft import compacter as jcp
from pevit_tpu.peft import lora as jlo
from pevit_tpu_torch import bridge
from pevit_tpu_torch.core import CLIPSpec, layers
from pevit_tpu_torch.peft import adapter as tad
from pevit_tpu_torch.peft import compacter as tcp
from pevit_tpu_torch.peft import lora as tlo
from pevit_tpu_torch.peft.base import PeftConfig, init_peft, make_hooks, peft_num_params

from .test_torch_bridge import PORT_TINY, _assert_same_tree, jax_bundle, port_bundle

TOL = 1e-5
WIDTH, N_HEAD = 64, 4
MAX_DIFFERING = 0.01
BASELINES = ("lora", "adapter", "compacter")


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _x(seed, b=3, n=5):
    return _rand(np.random.default_rng(seed), b, n, WIDTH)


def _load(module, tree):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    return module


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _lora_layer(seed):
    rng = np.random.default_rng(seed)
    return {"q_a": _rand(rng, WIDTH, 4, scale=0.1), "q_b": _rand(rng, 4, WIDTH, scale=0.1),
            "v_a": _rand(rng, WIDTH, 4, scale=0.1), "v_b": _rand(rng, 4, WIDTH, scale=0.1)}


def _adapter_layer(seed):
    rng = np.random.default_rng(seed)
    return {"norm_scale": 1 + _rand(rng, WIDTH, scale=0.1), "norm_bias": _rand(rng, WIDTH, scale=0.1),
            "down_kernel": _rand(rng, WIDTH, 64, scale=0.1), "down_bias": _rand(rng, 64, scale=0.1),
            "up_kernel": _rand(rng, 64, WIDTH, scale=0.1), "up_bias": _rand(rng, WIDTH, scale=0.1)}


def _compacter_params(seed):
    """(shared, layer) of one Compacter layer as JAX draws them, with
    non-zero LayerNorm and biases."""
    tree = jcp.init_params(jax.random.PRNGKey(seed), 1, WIDTH)
    layer = {k: np.array(v[0]) for k, v in tree["layers"].items()}
    rng = np.random.default_rng(seed)
    layer["norm_scale"] += _rand(rng, WIDTH, scale=0.1)
    layer["norm_bias"] = _rand(rng, WIDTH, scale=0.1)
    layer["down_b"], layer["up_b"] = _rand(rng, 64, scale=0.1), _rand(rng, WIDTH, scale=0.1)
    return {"phm_rule": np.array(tree["shared"]["phm_rule"])}, layer


def _close(got, want, what=""):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


# ---------------------------------------------------------------------------
# fp32 against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compat", [True, False])
def test_lora_attn_delta(compat):
    layer = _lora_layer(0)
    x = _x(1)
    want = jlo.attn_delta(None, _jax(layer), None, jnp.asarray(x), n_head=N_HEAD,
                          reference_compat=compat)
    got = tlo.attn_delta(None, _load(tlo.LoRALayer(WIDTH), layer), None, torch.from_numpy(x),
                         n_head=N_HEAD, reference_compat=compat)
    for g, w, name in zip(got, want, ("dq", "dv")):
        assert g.shape == (3, N_HEAD, 5, WIDTH // N_HEAD) and g.dtype == torch.float32
        _close(g, w, name)


def test_lora_scramble_moves_rows():
    """Quirk 4: under reference_compat the delta of one image depends on
    the other images of the batch."""
    layer = _load(tlo.LoRALayer(WIDTH), _lora_layer(2))
    x = torch.from_numpy(_x(3))
    dq = tlo.attn_delta(None, layer, None, x, n_head=N_HEAD)[0]
    x2 = x.clone()
    x2[1:] += 1.0
    dq2 = tlo.attn_delta(None, layer, None, x2, n_head=N_HEAD)[0]
    assert not torch.equal(dq[0], dq2[0])
    plain = lambda z: tlo.attn_delta(None, layer, None, z, n_head=N_HEAD, reference_compat=False)[0]
    assert torch.equal(plain(x)[0], plain(x2)[0])


def test_adapter_mlp_post():
    layer = _adapter_layer(4)
    m = _x(5)
    want = jad.mlp_post(None, _jax(layer), None, jnp.asarray(m))
    got = tad.mlp_post(None, _load(tad.AdapterLayer(WIDTH), layer), None, torch.from_numpy(m))
    _close(got, want, "adapter mlp_post")
    assert not np.allclose(np.asarray(want), m)  # the adapter is live


def test_compacter_phm_linear_and_mlp_post():
    shared, layer = _compacter_params(6)
    m = _x(7)
    jargs = [jnp.asarray(layer[k]) for k in ("down_w_left", "down_w_right")]
    targs = [torch.from_numpy(layer[k]) for k in ("down_w_left", "down_w_right")]
    want = jcp.phm_linear(jnp.asarray(m), *jargs, jnp.asarray(shared["phm_rule"]),
                          jnp.asarray(layer["down_b"]))
    got = tcp.phm_linear(torch.from_numpy(m), *targs, torch.from_numpy(shared["phm_rule"]),
                         torch.from_numpy(layer["down_b"]))
    assert got.shape == (3, 5, 64)
    _close(got, want, "phm_linear")
    want = jcp.mlp_post(_jax(shared), _jax(layer), None, jnp.asarray(m))
    got = tcp.mlp_post(_load(tcp.CompacterShared(), shared), _load(tcp.CompacterLayer(WIDTH), layer),
                       None, torch.from_numpy(m))
    _close(got, want, "compacter mlp_post")


def test_gelu_new():
    z = _rand(np.random.default_rng(8), 4096, scale=4.0)
    _close(layers.gelu_new(torch.from_numpy(z)), jlayers.gelu_new(jnp.asarray(z)), "gelu_new")


# ---------------------------------------------------------------------------
# bf16 rounding points
# ---------------------------------------------------------------------------

def _ulp(a: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``a``."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _bf16_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.bfloat16).float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))


def _bf16_case(method, seed):
    """(port fn, JAX fn, control fn) on one bf16 input of 4 x 50 tokens; each
    returns what the block reads in bf16 (LoRA's float32 delta as the block
    casts it)."""
    x = torch.from_numpy(_x(seed, b=4, n=50)).bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    if method == "lora":
        layer = _lora_layer(seed)
        tl = _load(tlo.LoRALayer(WIDTH), layer)
        # the q delta with the scramble off, in the (B, N, C) token layout
        heads = lambda d: d.reshape(4, 50, N_HEAD, WIDTH // N_HEAD).transpose(1, 2)

        def control():  # (x @ a) left in float32: its rounding point moved
            dt = x.dtype
            h = x.float() @ tl.q_a.to(dt).float()
            return heads(h @ tl.q_b.to(dt).float() * tlo.SCALE)
        return (lambda: tlo.attn_delta(None, tl, None, x, n_head=N_HEAD, reference_compat=False)[0],
                lambda: jlo.attn_delta(None, _jax(layer), None, jx, n_head=N_HEAD,
                                       reference_compat=False)[0],
                control)
    if method == "adapter":
        layer = _adapter_layer(seed)
        ta_ = _load(tad.AdapterLayer(WIDTH), layer)

        def control():  # the down product rounded to bf16 before its bias
            dt = x.dtype
            h = layers.layer_norm(x, ta_.norm_scale, ta_.norm_bias)
            h = torch.relu((h @ ta_.down_kernel.to(dt)).float() + ta_.down_bias).to(dt)
            return (h.float() @ ta_.up_kernel.to(dt).float() + ta_.up_bias).to(dt) + x
        return (lambda: tad.mlp_post(None, ta_, None, x),
                lambda: jad.mlp_post(None, _jax(layer), None, jx), control)
    shared, layer = _compacter_params(seed)
    ts, tl = _load(tcp.CompacterShared(), shared), _load(tcp.CompacterLayer(WIDTH), layer)

    def control():  # gelu_new after the cast to bf16, not before
        dt = x.dtype
        rule = ts.phm_rule
        h = layers.layer_norm(x, tl.norm_scale, tl.norm_bias)
        h = layers.gelu_new(tcp.phm_linear(h, tl.down_w_left, tl.down_w_right, rule,
                                           tl.down_b).to(dt))
        return tcp.phm_linear(h, tl.up_w_left, tl.up_w_right, rule, tl.up_b).to(dt) + x
    return (lambda: tcp.mlp_post(ts, tl, None, x),
            lambda: jcp.mlp_post(_jax(shared), _jax(layer), None, jx), control)


@pytest.mark.parametrize("method", BASELINES)
def test_bf16_within_one_ulp_of_jax(method):
    port, ref, _ = _bf16_case(method, seed=11)
    got, want = _bf16_numpy(port()), _bf16_numpy(ref())
    np.testing.assert_allclose(got, want, rtol=0, atol=_ulp(want))
    assert (got != want).mean() <= MAX_DIFFERING


@pytest.mark.parametrize("method", BASELINES)
def test_bf16_moved_rounding_point_is_told_apart(method):
    """Control: one rounding point moved changes far more elements than the
    check above allows, so that check pins the rounding points."""
    _, ref, control = _bf16_case(method, seed=11)
    other, want = _bf16_numpy(control()), _bf16_numpy(ref())
    assert (other != want).mean() > 10 * MAX_DIFFERING


# ---------------------------------------------------------------------------
# init, counts, bridge
# ---------------------------------------------------------------------------

VIT_B32 = CLIPSpec.vit_b32()
JAX_VIT_B32 = JaxCLIPSpec.vit_b32()


@pytest.mark.parametrize("method", BASELINES)
def test_init_shapes_and_distributions(method):
    port = init_peft(torch.Generator().manual_seed(0), PeftConfig(method=method), VIT_B32,
                     device="cpu")
    ref = jax.eval_shape(lambda: jbase.init_peft(jax.random.PRNGKey(0),
                                                 JaxPeftConfig(method=method), JAX_VIT_B32))
    assert len(port.layers) == 12
    for name, leaf in ref["layers"].items():
        assert tuple(getattr(port.layers[0], name).shape) == leaf.shape[1:], name
    if ref["shared"] is None:
        assert port.shared is None
    else:
        assert {k: tuple(v.shape) for k, v in port.shared.named_parameters()} == {
            k: v.shape for k, v in ref["shared"].items()}

    stack = lambda name: torch.stack([getattr(lyr, name) for lyr in port.layers]).detach()
    zeros = {"lora": ("q_b", "v_b"), "adapter": ("norm_bias", "down_bias", "up_bias"),
             "compacter": ("norm_bias", "down_b", "up_b")}[method]
    for name in zeros:
        assert not stack(name).any(), name
    if method != "lora":
        assert torch.equal(stack("norm_scale"), torch.ones(12, 768))
    if method in ("lora", "adapter"):
        for name in ("q_a", "v_a") if method == "lora" else ("down_kernel", "up_kernel"):
            w = stack(name)
            assert abs(w.mean()) < 1e-3 and w.std().item() == pytest.approx(0.02, rel=0.03), name
        assert not torch.equal(stack("q_a" if method == "lora" else "down_kernel")[0],
                               stack("q_a" if method == "lora" else "down_kernel")[1])
        return
    rule = port.shared.phm_rule.detach()
    assert rule.abs().max() <= 1.0 and rule.std().item() == pytest.approx(3 ** -0.5, rel=0.2)
    for name in ("down_w_left", "down_w_right", "up_w_left", "up_w_right"):
        w = stack(name)
        bound = tcp.glorot_bound(w.shape)
        assert bound == pytest.approx(np.sqrt(2.0) * np.sqrt(6.0 / sum(w.shape[-2:])))
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound, name


def test_peft_num_params_match_jax_at_vit_b32():
    want = {"lora": 147_456, "adapter": 1_208_064, "compacter": 48_448, "kadaptation": 50_176}
    for method, n in want.items():
        assert jbase.peft_num_params(JaxPeftConfig(method=method), JAX_VIT_B32) == n
        assert peft_num_params(PeftConfig(method=method), VIT_B32) == n, method
        module = init_peft(torch.Generator().manual_seed(0), PeftConfig(method=method), VIT_B32,
                           device="cpu")
        assert sum(p.numel() for p in module.parameters()) == n, method
    assert tcp.num_params(12, 768) - 12 * 4032 == tcp.PHM_DIM ** 3  # 64 of them frozen


@pytest.mark.parametrize("method", BASELINES)
def test_bridge_round_trip_is_bit_exact(method):
    bundle, bn = jax_bundle(method=method)
    ported, bn_t = port_bundle(bundle, bn, method=method)
    assert type(ported["peft"]).__name__ == {"lora": "LoRA", "adapter": "Adapter",
                                             "compacter": "Compacter"}[method]
    back, bn_back = bridge.to_jax(ported, bn_t)
    _assert_same_tree(back, bundle)
    _assert_same_tree(bn_back, bn)
    if method == "compacter":
        assert np.array_equal(ported["peft"].shared.phm_rule.detach().numpy(),
                              bundle["peft"]["shared"]["phm_rule"])


# ---------------------------------------------------------------------------
# the block's MLP route under an mlp_post hook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["adapter", "compacter"])
def test_mlp_post_block_takes_the_unfused_route(method, monkeypatch):
    """With ``use_fused_mlp=True`` a hooked block still computes the bare
    MLP output and adds the hook's result; the fused kernel, which never
    writes that output, is not called.  Without the hook the same block
    gives another output."""
    bundle, bn = jax_bundle(method=method)
    ported, _ = port_bundle(bundle, bn, method=method)
    peft = ported["peft"]
    with torch.no_grad():
        for p in peft.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    blk = ported["clip"].visual.blocks[0]
    x = torch.from_numpy(_x(9, n=PORT_TINY.vision.seq_len))
    hooks = make_hooks(PeftConfig(method=method), PORT_TINY, train=False)
    post = lambda m: hooks.mlp_post(peft.shared, peft.layers[0], None, m)

    def fused_is_off(*a, **k):
        raise AssertionError("an mlp_post block reached the fused MLP")

    no_hook = layers.residual_attention_block(blk, x, n_head=PORT_TINY.vision.heads, use_fused_mlp=True)
    monkeypatch.setattr(layers, "fused_mlp_residual", fused_is_off)
    got = layers.residual_attention_block(blk, x, n_head=PORT_TINY.vision.heads, mlp_post_fn=post,
                                          use_fused_mlp=True)
    unfused = layers.residual_attention_block(blk, x, n_head=PORT_TINY.vision.heads, mlp_post_fn=post,
                                              use_fused_mlp=False)
    assert torch.equal(got, unfused)
    assert (got - no_hook).abs().max() > 1e-3 * no_hook.abs().max()
