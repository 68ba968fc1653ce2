"""Bridge between the JAX reference's serving bundle and the PyTorch port.

Also holds the shared fixtures of the port's tests: a tiny CLIP spec on both
sides, a JAX-built bundle with seeded NON-ZERO KAdaptation factors (at init
they are zero, which would hide the raw-reshape scramble), and a fixture
pinning the JAX attention layout to the reference-shaped bnhd path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pevit_tpu.core import CLIPSpec, TextSpec, VisionSpec, init_clip_params
from pevit_tpu.core import layers as jax_layers
from pevit_tpu.peft import PeftConfig, init_peft
from pevit_tpu.train.head import init_head
from pevit_tpu_torch import bridge
from pevit_tpu_torch.core import clip as port_clip
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig

RES = 32
NUM_CLASSES = 4
TINY = CLIPSpec(
    embed_dim=32,
    vision=VisionSpec(input_resolution=RES, patch_size=16, width=64, layers=2, heads=2,
                      output_dim=32),
    text=TextSpec(context_length=12, vocab_size=100, width=32, heads=2, layers=2, output_dim=32),
)
PORT_TINY = port_clip.CLIPSpec(
    embed_dim=TINY.embed_dim,
    vision=port_clip.VisionSpec(**dataclasses.asdict(TINY.vision)),
    text=port_clip.TextSpec(**dataclasses.asdict(TINY.text)),
)


@pytest.fixture(scope="module", autouse=True)
def bnhd_layout():
    """The JAX reference-shaped attention layout, restored afterwards."""
    prev = jax_layers._ATTN_LAYOUT
    jax_layers.set_attn_layout("bnhd")
    yield
    jax_layers.set_attn_layout(prev)


def jax_bundle(seed: int = 0, method: str = "kadaptation"):
    """(bundle, bn_state) as numpy, built by the JAX package, with seeded
    non-zero KAdaptation factors (for another PEFT method, every per-layer
    leaf moved off its init by seeded noise) and random BN running
    statistics."""
    cfg = PeftConfig(method=method)
    bundle = {
        "clip": init_clip_params(jax.random.PRNGKey(seed), TINY),
        "peft": init_peft(jax.random.PRNGKey(seed + 1), cfg, TINY),
        "head": init_head(jax.random.PRNGKey(seed + 2), TINY.embed_dim, NUM_CLASSES),
    }
    bundle = jax.tree.map(lambda a: np.array(a), bundle)
    rng = np.random.default_rng(seed)
    if method == "kadaptation":
        layers = bundle["peft"]["layers"]
        for name in ("q_left", "q_right", "v_left", "v_right"):
            layers[name] = rng.standard_normal(layers[name].shape).astype(np.float32)
        layers["b"] = (0.1 * rng.standard_normal(layers["b"].shape)).astype(np.float32)
    elif bundle["peft"] is not None:
        layers = bundle["peft"]["layers"]
        for name in sorted(layers):
            noise = 0.05 * rng.standard_normal(layers[name].shape)
            layers[name] = (layers[name] + noise).astype(np.float32)
    bn = {"mean": (0.1 * rng.standard_normal(TINY.embed_dim)).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, TINY.embed_dim).astype(np.float32)}
    return bundle, bn


def port_bundle(bundle_np, bn_np, method: str = "kadaptation", reference_compat: bool = True):
    cfg = PortPeftConfig(method=method, reference_compat=reference_compat)
    return bridge.from_jax(bundle_np, bn_np, PORT_TINY, cfg, device="cpu")


def _assert_same_tree(a, b, path=()):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same_tree(a[k], b[k], path + (k,))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        assert np.array_equal(a, b), path


def test_round_trip_is_bit_exact():
    bundle, bn = jax_bundle()
    back, bn_back = bridge.to_jax(*port_bundle(bundle, bn))
    _assert_same_tree(back, bundle)  # both towers, the text tower included
    _assert_same_tree(bn_back, bn)


def test_layers_unstack_onto_modules():
    bundle, bn = jax_bundle()
    ported, bn_t = port_bundle(bundle, bn)
    blocks = bundle["clip"]["visual"]["blocks"]
    for i, blk in enumerate(ported["clip"].visual.blocks):
        assert np.array_equal(blk.attn.in_proj.kernel.detach().numpy(), blocks["attn"]["in_proj"]["kernel"][i])
        assert np.array_equal(blk.mlp.c_proj.bias.detach().numpy(), blocks["mlp"]["c_proj"]["bias"][i])
        assert np.array_equal(ported["peft"].layers[i].q_left.detach().numpy(),
                              bundle["peft"]["layers"]["q_left"][i])
    assert np.array_equal(ported["head"].linear.kernel.detach().numpy(),
                          bundle["head"]["linear"]["kernel"])
    assert np.array_equal(bn_t["var"].numpy(), bn["var"])


def test_no_peft_bundle_round_trips():
    bundle, bn = jax_bundle(method="linear_probe")
    ported, bn_t = port_bundle(bundle, bn, method="linear_probe")
    assert ported["peft"] is None
    back, _ = bridge.to_jax(ported, bn_t)
    assert back["peft"] is None
    _assert_same_tree(back["head"], bundle["head"])


def test_shape_or_name_mismatch_is_refused():
    bundle, bn = jax_bundle()
    del bundle["clip"]["visual"]["ln_post"]
    with pytest.raises(ValueError, match="ln_post"):
        port_bundle(bundle, bn)
    bundle, bn = jax_bundle()
    bundle["head"]["linear"]["bias"] = np.zeros(NUM_CLASSES + 1, np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_bundle(bundle, bn)


def test_from_jax_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle, bn = jax_bundle()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.from_jax(bundle, bn, PORT_TINY, PortPeftConfig(method="kadaptation"))


@pytest.mark.parametrize("kind", ["sgd", "adam", "rmsprop"])
def test_optimizer_state_round_trip_is_bit_exact(kind):
    """A reference optimiser state over the trainable tree (None at frozen
    leaves) -> the port's named dicts -> back, bit for bit; the port's keys
    are the bundle's parameter names."""
    from pevit_tpu.train import optim as jo
    from pevit_tpu_torch.train import named_parameters

    bundle, bn = jax_bundle()
    trainable = {"clip": jax.tree.map(lambda _: None, bundle["clip"]), "peft": bundle["peft"],
                 "head": {"linear": bundle["head"]["linear"], "logit_scale": None}}
    init, _ = jo.make_optimizer(kind)
    rng = np.random.default_rng(5)
    state = init(trainable)
    state = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape), np.asarray(a).dtype)
                         if np.asarray(a).ndim else np.int32(7), state)
    ported = bridge.opt_state_from_jax(state, device="cpu")
    names = set(named_parameters(port_bundle(bundle, bn)[0]))
    for field, val in ported._asdict().items():
        if field == "step":
            assert val == 7
        else:
            assert set(val) <= names and "peft.layers.1.q_left" in val and "head.linear.bias" in val
    back = bridge.opt_state_to_jax(ported)
    assert type(back).__name__ == type(state).__name__
    for field, val in state._asdict().items():
        if field == "step":
            assert back.step.dtype == np.int32 and back.step == val
        else:
            _assert_same_tree(getattr(back, field), _prune(jax.tree.map(np.asarray, val)))


def _prune(tree):
    """Drop None leaves and the dicts left empty (the frozen side)."""
    out = {}
    for k, v in tree.items():
        v = _prune(v) if isinstance(v, dict) else v
        if v is not None and not (isinstance(v, dict) and not v):
            out[k] = v
    return out
