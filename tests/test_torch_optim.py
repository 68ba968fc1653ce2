"""The port's optimisers against pevit_tpu/train/optim.py on the same numpy
trees (the port's dicts are the trees' leaves under dotted names), several
steps, fp32, rtol = atol = 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.train import optim as jo
from pevit_tpu_torch.train import optim as to

TOL = dict(rtol=1e-6, atol=1e-6)
LR, WD, STEPS = 0.05, 0.01, 4
SHAPES = {
    "peft": {"shared": {"phm_rule1_left": (4, 4, 1)},
             "layers": {"q_left": (2, 4, 2, 1), "b": (2, 8)}},
    "head": {"linear": {"kernel": (8, 3), "bias": (3,)}},
    "clip": {"visual": {"ln_post": {"scale": (8,), "bias": (8,)},
                        "bn_mid": {"scale": (5,)}, "proj": (8, 6)}},
}


def _tree(rng, shapes=SHAPES):
    return {k: _tree(rng, v) if isinstance(v, dict) else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _port(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in _flat(tree).items()}


def _assert_tree(port: dict, tree, what=""):
    for n, a in _flat(jax.tree.map(np.asarray, tree)).items():
        np.testing.assert_allclose(port[n].numpy(), a, err_msg=f"{what} {n}", **TOL)


def _run(name, *, momentum=0.9, nesterov=False, lr_scales=None, wd_mask=None, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    j_init, j_upd = jo.make_optimizer(name, momentum=momentum, nesterov=nesterov,
                                      lr_scales=lr_scales, wd_mask=wd_mask)
    t_init, t_upd = to.make_optimizer(
        name, momentum=momentum, nesterov=nesterov,
        lr_scales=None if lr_scales is None else _flat(lr_scales),
        wd_mask=None if wd_mask is None else _flat(wd_mask))
    jp = jax.tree.map(jnp.asarray, params)
    js = j_init(jp)
    tp = _port(params)
    ts = t_init(tp)
    for g in grads:
        jp, js = j_upd(jax.tree.map(jnp.asarray, g), jp, js, LR, WD)
        ts = t_upd(_port(g), tp, ts, LR, WD)
    _assert_tree(tp, jp, name)
    for field, val in ts._asdict().items():
        if field == "step":
            assert val == int(js.step) == STEPS
        else:
            _assert_tree(val, getattr(js, field), f"{name} {field}")


@pytest.mark.parametrize("name,nesterov", [("sgd", False), ("sgd", True), ("adam", False),
                                           ("adamw", False), ("rmsprop", False)])
def test_update_rules_match(name, nesterov):
    _run(name, nesterov=nesterov)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_lr_scales_match(nesterov):
    scales = jax.tree_util.tree_map_with_path(
        lambda kp, _: 0.1 if kp[0].key in ("clip", "peft") else 1.0, _tree(np.random.default_rng(0)))
    _run("sgd", nesterov=nesterov, lr_scales=scales)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "rmsprop"])
def test_wd_mask_matches(name):
    mask = jo.build_wd_mask(_tree(np.random.default_rng(0)), ["ln", "bias"])
    _run(name, wd_mask=mask)


@pytest.mark.parametrize("rules,timm", [(["ln"], False), (["bn"], False), (["bias"], False),
                                        (["ln", "bn", "bias"], False), ([], True),
                                        (["ln"], True), ([], False)])
def test_build_wd_mask_matches(rules, timm):
    tree = _tree(np.random.default_rng(1))
    want = jo.build_wd_mask(tree, rules, timm_filter=timm)
    got = to.build_wd_mask(_port(tree), rules, timm_filter=timm)
    if want is None:
        assert got is None
    else:
        assert got == _flat(want)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_grad_norm_matches(max_norm):
    g = _tree(np.random.default_rng(2))
    _assert_tree(to.clip_grad_norm(_port(g), max_norm),
                 jo.clip_grad_norm(jax.tree.map(jnp.asarray, g), max_norm))


@pytest.mark.parametrize("epoch", [0, 4, 5, 9, 12])
def test_step_decay_lr_matches(epoch):
    assert to.step_decay_lr(0.1, epoch, [5, 10]) == jo.step_decay_lr(0.1, epoch, [5, 10])


def test_update_is_in_place_and_unknown_name_raises():
    p = {"w": torch.ones(3, requires_grad=True)}
    ref = p["w"]
    init, upd = to.make_optimizer("sgd")
    upd({"w": torch.ones(3)}, p, init(p), 0.1, 0.0)
    assert p["w"] is ref and torch.allclose(ref.detach(), torch.full((3,), 0.9))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        to.make_optimizer("lamb")
