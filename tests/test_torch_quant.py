"""Weight-only int8 serving quantization: the port's ``quant`` and quantized
``make_serving_fn`` against the JAX reference's.

The port holds one tensor a layer where the reference stacks a tower's
layers, so the decision and the scales must come from the reference's
stacked leaf: the int8 values and scales are compared bit for bit, for the
KAdaptation, LoRA, adapter and Compacter bundles carried through the bridge,
LoRA's factors at ViT-B/32 width (quantized stacked, below ``MIN_SIZE`` a
layer), and a 16-layer tower whose (L, C) biases are scaled over their
layer axis.  Quantized serving logits are held to JAX's at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core import CLIPSpec as JaxCLIPSpec
from pevit_tpu.core import VisionSpec as JaxVisionSpec
from pevit_tpu.core import init_clip_params
from pevit_tpu.peft import PeftConfig, init_peft
from pevit_tpu.quant import quantize_tree as jax_quantize_tree
from pevit_tpu.serve import make_serving_fn as jax_make_serving_fn
from pevit_tpu.train.trainer import TaskStatic as JaxStatic
from pevit_tpu_torch import bridge, quant
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.serve import make_serving_fn, serving_weights
from pevit_tpu_torch.train import named_parameters, partition, trainable_pred
from pevit_tpu_torch.train.trainer import UNFUSED_MLP_METHODS, TaskStatic

from .test_torch_bridge import (  # noqa: F401  (bnhd_layout: autouse fixture)
    NUM_CLASSES, PORT_TINY, RES, TINY, bnhd_layout, jax_bundle, port_bundle)
from .test_torch_serve import PREPROC, _images

METHODS = ("kadaptation", "lora", "adapter", "compacter")
# the default threshold quantizes only the tiny spec's visual GEMM kernels;
# 256 also reaches its PEFT factors and stacked biases
MIN_SIZES = (quant.MIN_SIZE, 256)


def _jax_quantized(bundle_np, bn_np, min_size):
    q = jax_quantize_tree(jax.tree.map(jnp.asarray, bundle_np), min_size=min_size)
    return {"bundle": jax.tree.map(np.asarray, q), "bn_state": bn_np}


def _assert_leaves_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        assert isinstance(g, dict) == isinstance(w, dict), name
        pairs = [(g[k], w[k]) for k in ("_q8", "scale")] if isinstance(w, dict) else [(g, w)]
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
            assert torch.equal(a, b), name


def _assert_trees_equal(got, want, path=()):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], path + (k,))
    elif want is None:
        assert got is None, path
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("min_size", MIN_SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_int8_values_and_scales_are_the_references(method, min_size):
    bundle, bn = jax_bundle(method=method)
    want = _jax_quantized(bundle, bn, min_size)
    ported, _ = port_bundle(bundle, bn, method=method)
    got = quant.quantize_tree({n: p for n, p in named_parameters(ported).items()},
                              min_size=min_size)
    _assert_leaves_equal(got, bridge.serving_weights_from_jax(want, device="cpu")["bundle"])
    assert quant.is_quantized(got)
    # and back: the reference's stacked int8 tree, bit for bit
    back = bridge.serving_weights_to_jax({"bundle": got, "bn_state": {
        k: torch.from_numpy(v) for k, v in bn.items()}})
    _assert_trees_equal(back, want)


def test_lora_factors_quantize_on_their_stacked_size():
    """LoRA's (12, 768, 4) factors at ViT-B/32 width: 36,864 elements stacked,
    3,072 a layer.  The reference quantizes them; the port decides on the
    stacked leaf and gives one (1, 4) scale a layer."""
    peft = jax.tree.map(np.asarray, init_peft(jax.random.PRNGKey(0), PeftConfig(method="lora"),
                                              JaxCLIPSpec.vit_b32()))
    rng = np.random.default_rng(0)
    peft["layers"]["q_b"] = (0.02 * rng.standard_normal(peft["layers"]["q_b"].shape)
                             ).astype(np.float32)
    want = _jax_quantized({"peft": peft}, {}, quant.MIN_SIZE)
    plain = bridge.serving_weights_from_jax({"bundle": {"peft": peft}, "bn_state": {}},
                                            device="cpu")["bundle"]
    assert plain["peft.layers.0.q_a"].numel() < quant.MIN_SIZE
    got = quant.quantize_tree(plain)
    for name in ("q_a", "v_a"):
        leaf = got[f"peft.layers.5.{name}"]
        assert leaf["_q8"].shape == (768, 4) and leaf["scale"].shape == (1, 4)
    _assert_leaves_equal(got, bridge.serving_weights_from_jax(want, device="cpu")["bundle"])


def test_stacked_biases_scale_over_their_layer_axis():
    """A 16-layer tower: each (16, C) stacked bias has the layer axis as its
    axis -2, so the reference scales it over the layers and the port's
    layers share one (C,) scale row."""
    deep = dataclasses.replace(TINY, vision=JaxVisionSpec(
        input_resolution=RES, patch_size=16, width=64, layers=16, heads=2, output_dim=32))
    clip = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(3), deep))
    clip["visual"]["blocks"]["mlp"]["c_fc"]["bias"] = np.random.default_rng(1).standard_normal(
        (16, 256)).astype(np.float32)
    tree = {"clip": {"visual": clip["visual"]}}
    want = _jax_quantized(tree, {}, 1024)
    got = quant.quantize_tree(bridge.serving_weights_from_jax(
        {"bundle": tree, "bn_state": {}}, device="cpu")["bundle"], min_size=1024)
    bias = [got[f"clip.visual.blocks.{i}.mlp.c_fc.bias"] for i in range(16)]
    assert bias[0]["_q8"].shape == (256,) and bias[0]["scale"].shape == (256,)
    assert all(torch.equal(b["scale"], bias[0]["scale"]) for b in bias)
    _assert_leaves_equal(got, bridge.serving_weights_from_jax(want, device="cpu")["bundle"])
    _assert_trees_equal(bridge.serving_weights_to_jax({"bundle": got, "bn_state": {}}), want)


def test_min_size_guard_and_small_contraction_axis():
    w = {"w": torch.ones(8, 8), "ints": torch.ones(200, 200, dtype=torch.int32),
         "flat": torch.ones(20000), "short": torch.ones(4, 15, 400),
         "just_under": torch.ones(16, quant.MIN_SIZE // 16 - 1),
         "at": torch.ones(16, quant.MIN_SIZE // 16)}
    q = quant.quantize_tree(w)
    assert quant.MIN_SIZE > 8 * 8 and not quant.is_quantized({k: q[k] for k in w if k != "at"})
    assert q["at"]["_q8"].dtype == torch.int8 and q["at"]["scale"].shape == (1, quant.MIN_SIZE // 16)


def test_round_trip_within_half_a_step():
    """Symmetric round to nearest: |W - deq(q(W))| <= scale / 2 per element,
    and the int8 leaf is ~4x smaller."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 64)).astype(np.float32))
    q = quant.quantize_tree({"big": w, "bias": torch.ones(64)}, min_size=1024)
    assert q["big"]["_q8"].dtype == torch.int8 and q["big"]["scale"].shape == (1, 64)
    assert not quant.is_quantized(q["bias"])
    deq = quant.dequantize_tree(q)
    assert (deq["big"] - w).abs().le(q["big"]["scale"] / 2 + 1e-8).all()
    assert deq["big"].dtype == torch.float32
    assert quant.dequantize_tree(q, torch.bfloat16)["big"].dtype == torch.bfloat16
    assert quant.tree_nbytes(q["big"]) < w.numel() * 4 / 3.5


@pytest.mark.parametrize("method", METHODS)
def test_quantized_serving_matches_jax(method):
    """Quantized serving logits, port vs reference, fp32, at 1e-5."""
    bundle, bn = jax_bundle(method=method)
    static = JaxStatic(spec=TINY, peft_cfg=PeftConfig(method=method), num_classes=NUM_CLASSES,
                       compute_dtype="float32", use_fused_mlp=False)
    jb = jax.tree.map(jnp.asarray, bundle)
    jax_fn = jax_make_serving_fn(static, jb, jax.tree.map(lambda _: None, jb),
                                 jax.tree.map(jnp.asarray, bn),
                                 {k: jnp.asarray(v) for k, v in PREPROC.items()}, quantize=True)
    pstatic = TaskStatic(spec=PORT_TINY, peft_cfg=PortPeftConfig(method=method),
                         num_classes=NUM_CLASSES, compute_dtype="float32",
                         use_fused_mlp=method not in UNFUSED_MLP_METHODS)
    ported, bn_t = port_bundle(bundle, bn, method=method)
    trainable, frozen = partition(ported, trainable_pred(pstatic))
    port_fn = make_serving_fn(pstatic, trainable, frozen, bn_t, PREPROC, quantize=True,
                              device="cpu")
    fp_fn = make_serving_fn(pstatic, trainable, frozen, bn_t, PREPROC, device="cpu")
    x = _images(6, seed=2)
    want = np.asarray(jax_fn(jnp.asarray(x)))
    got = port_fn(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - fp_fn(x).numpy()).max() > 1e-6  # the int8 weights are live
    weights = serving_weights(trainable, frozen, bn_t, quantize=True)
    assert quant.is_quantized(weights["bundle"])
    assert quant.tree_nbytes(weights["bundle"]) < quant.tree_nbytes(
        serving_weights(trainable, frozen, bn_t)["bundle"])
