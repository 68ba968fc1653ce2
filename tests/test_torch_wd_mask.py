"""The timm weight-decay filter (TRAIN.OPTIMIZER: timm, filter_bias_and_bn)
against pevit_tpu/train: the reference reads each leaf's rank on its stacked
trainable tree, so a per-layer KAdaptation bias ``peft.layers.b`` of shape
(L, C) has rank 2 and is decayed.  The port keeps one (C,) tensor per layer
and counts the stacked layer axis back (``bridge.stacked_layer_axes``).

* the port's ``TrainTask._wd_mask()`` equals the JAX trainer's mask leaf for
  leaf, each layer's tensor taking its stacked leaf's value, for the
  KAdaptation, adapter and Compacter trees (their per-layer biases are
  (L, n) in the reference, so they are decayed);
* ``build_wd_mask`` on a tree with stacked visual blocks, unstacked through
  the bridge, equals the reference's mask on the stacked tree;
* one SGD step with wd > 0 and non-zero ``b`` gives the reference's
  ``peft.layers.b``, fp32, rtol = atol = 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.train import optim as jo
from pevit_tpu_torch import bridge
from pevit_tpu_torch.train import optim as to

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_trainer import _flat, _jax_task, _port_side, clip_params  # noqa: F401

TIMM = dict(OPTIMIZER="timm")
LR, WD = 0.1, 0.05


def _unstacked(name: str) -> str:
    """The reference's dotted leaf path of a port parameter name."""
    parts = name.split(".")
    if bridge.stacked_layer_axes(name):
        parts = [p for p in parts if not p.isdigit()]
    return ".".join(parts)


@pytest.mark.parametrize("name,axes", [
    ("peft.layers.0.b", 1), ("peft.layers.11.q_left", 1), ("clip.visual.blocks.3.ln_1.scale", 1),
    ("peft.layers.b", 0), ("clip.visual.ln_post.scale", 0), ("clip.visual.blocks", 0),
    ("head.linear.bias", 0), ("peft.shared.phm_rule1_left", 0), ("clip.logit_scale", 0),
    ("peft.layers.2.down_bias", 1), ("peft.layers.0.up_b", 1), ("peft.shared.phm_rule", 0),
])
def test_stacked_layer_axes(name, axes):
    assert bridge.stacked_layer_axes(name) == axes


def _task_masks(clip_params, method):
    """(port mask, reference mask) of one task under the timm filter."""
    task, _, trainable, frozen, bn = _jax_task(clip_params, method=method, **TIMM)
    assert task.static.timm_filter
    want = _flat(task._wd_mask())
    ptask, pstatic, _, _, params = _port_side(trainable, frozen, bn, method=method, **TIMM)
    assert pstatic.timm_filter
    got = ptask._wd_mask()
    assert set(got) == set(params)
    assert {_unstacked(n) for n in got} == set(want)
    for n, m in got.items():
        assert m == float(want[_unstacked(n)]), n
    return got


def test_task_mask_matches_reference(clip_params):  # noqa: F811
    got = _task_masks(clip_params, "kadaptation")
    assert got["peft.layers.0.b"] == 1.0  # (L, C) in the reference: decayed


@pytest.mark.parametrize("method,biases", [("adapter", ("down_bias", "up_bias")),
                                          ("compacter", ("down_b", "up_b"))])
def test_adapter_trees_mask_matches_reference(clip_params, method, biases):  # noqa: F811
    """The adapter's and Compacter's per-layer biases and LayerNorms are
    (L, n) in the reference, so timm decays them; the head's bias is not;
    Compacter's frozen rule has no entry."""
    got = _task_masks(clip_params, method)
    for name in biases + ("norm_scale", "norm_bias"):
        assert got[f"peft.layers.1.{name}"] == 1.0, name
    assert got["head.linear.bias"] == 0.0
    assert not any("shared" in n for n in got)


def test_build_wd_mask_on_stacked_blocks_matches():
    rng = np.random.default_rng(4)
    shapes = {"clip": {"visual": {"blocks": {"ln_1": {"scale": (3, 8), "bias": (3, 8)},
                                             "attn": {"in_proj": {"kernel": (3, 8, 24)}}},
                                  "ln_post": {"scale": (8,)}, "proj": (8, 4)}},
              "peft": {"layers": {"b": (3, 8), "q_left": (3, 2, 2, 1)}},
              "head": {"linear": {"kernel": (4, 5), "bias": (5,)}}}
    tree = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    for rules in ([], ["ln"]):
        want = _flat(jo.build_wd_mask(tree, rules, timm_filter=True))
        got = to.build_wd_mask(bridge._tree_to_port(tree, "cpu"), rules, timm_filter=True)
        assert len(got) == 3 * 3 + 2 + 3 * 2 + 2
        assert got == {n: float(want[_unstacked(n)]) for n in got}


def test_one_sgd_step_decays_b_as_the_reference(clip_params):  # noqa: F811
    task, static, trainable, frozen, bn = _jax_task(clip_params, **TIMM)
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                         trainable)
    j_init, j_upd = jo.make_optimizer(static.optimizer, momentum=static.momentum,
                                      nesterov=static.nesterov, wd_mask=task._wd_mask())
    jp, _ = j_upd(grads, trainable, j_init(trainable), LR, WD)

    ptask, pstatic, _, _, params = _port_side(trainable, frozen, bn, **TIMM)
    t_init, t_upd = to.make_optimizer(pstatic.optimizer, momentum=pstatic.momentum,
                                      nesterov=pstatic.nesterov, wd_mask=ptask._wd_mask())
    pgrads = bridge._tree_to_port(jax.tree.map(np.asarray, grads), "cpu")
    t_upd({n: pgrads[n] for n in params}, params, t_init(params), LR, WD)

    b0 = np.asarray(trainable["peft"]["layers"]["b"])
    want = np.asarray(jp["peft"]["layers"]["b"])
    got = np.stack([params[f"peft.layers.{i}.b"].detach().numpy() for i in range(len(want))])
    assert np.abs(b0).min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
