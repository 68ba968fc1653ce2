"""The linear probe and full fine-tuning over the auxiliary backbones and an
RN CLIP tower, against pevit_tpu/train/trainer.py, at toy size (a MAE ViT
64 wide, 2 layers; a DeCLIP ViT-B/32 layout 64 wide at 64 px; an RN tower
of width 8 with live BatchNorms), K = 4 classes:

* a whole run: ``build_fit_eval_fn`` on both stacks (the reference's
  compiled without XLA's excess precision, see ``AS_WRITTEN``), two epochs of 20
  images in batches of 8 (a natural tail of 4), eval of 70 images after
  each epoch, the port replaying the JAX shuffle; the per-epoch val logits,
  the trained parameters and the head's BN state at 1e-5 of their largest
  magnitude.  In float32, and for the ViT and DeCLIP backbones under the
  bfloat16 task dtype, where both packages normalise the images in
  bfloat16 and run the backbone in float32 on them; a control shows that
  the check fails when the port moves that rounding point;
* ``trainable_pred``, ``model_info`` and the weight-decay masks equal the
  reference's on every tree: under full_finetune a generic backbone trains
  whole, a DeCLIP model's ``text`` subtree and ``logit_scale`` stay frozen,
  an RN tower trains with its BatchNorm statistics (leaves of the
  reference's tree);
* the serving forward with ``forward_fn`` (``make_serving_fn`` and an
  exported artifact) against the reference's ``make_serving_fn`` at 1e-5;
* the DeCLIP backbone's MLP route follows the task: the fused MLP on a
  frozen tower, the unfused one under full_finetune.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.core import clip as jc
from pevit_tpu.peft import PeftConfig
from pevit_tpu.serve import make_serving_fn as jax_serving_fn
from pevit_tpu.train import optim as jo
from pevit_tpu.train import trainer as jt
from pevit_tpu.train.partition import combine as jcombine
from pevit_tpu_torch import bridge
from pevit_tpu_torch.core import clip as pc
from pevit_tpu_torch.core import layers as tl
from pevit_tpu_torch.models import get_model
from pevit_tpu_torch.peft import PeftConfig as PortPeftConfig
from pevit_tpu_torch.serve import export_classifier, exported_callable, make_serving_fn
from pevit_tpu_torch.train import (
    TaskStatic,
    TrainState,
    TrainTask,
    build_fit_eval_fn,
    make_optimizer,
    partition,
    trainable_params,
    trainable_pred,
)

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_factory import pair
from .test_torch_resnet import randomize_bn
from .test_torch_trainer import _jax_perms
from .test_torch_vit import flat, np_tree

K, B = 4, 8
N_TRAIN, N_VAL, EPOCHS = 20, 70, 2
WD = 1e-3
TOL = 1e-5
# per backbone: the model YAML, the image size and the learning rate of the
# whole run (full fine-tuning of the RN tower at 1e-3 is chaotic in fp32:
# the stacks' summation-order differences grow to 1.1e-5 of the logits in
# one epoch)
KINDS = {"vit": ("mae_vitb16", 32, 0.01), "declip": ("vitb32_DeCLIP", 64, 0.01),
         "rn": (None, 64, 3e-4)}
# leaves whose fine-tuning gradient vanishes in exact arithmetic, so that
# what either stack trains there is rounding noise (1e-8 of the largest
# parameter): a bias that shifts every feature by one vector, which the
# head's train-mode BN subtracts (the MAE pool's fc_norm, DeCLIP's ln_post,
# the RN attention pool's c_proj and v_proj, whose softmax weights sum to
# one); k_proj's bias, which adds one constant to a query's logits; and
# q_proj's, whose gradient sums the softmax's zero-sum logit gradients
# against keys that a 2 x 2 grid makes nearly equal.  They are held to the
# largest magnitude of the trained tree.
VANISHING = {"vit": ("clip.norm.bias",), "declip": ("clip.visual.ln_post.bias",),
             "rn": tuple(f"clip.visual.attnpool.{n}_proj.bias" for n in "cvkq")}
RN_SPEC = (64, 8, (1, 2, 1, 1), 32)
# XLA's CPU compiler drops the bfloat16 rounding of the normalised images by
# default (excess precision: it removes the f32 -> bf16 -> f32 convert pair
# in front of the float32 backbone, 2e-3 of the logits here); compiled
# without it, the reference's program rounds where it is written, as it does
# run eagerly, and as the port does
AS_WRITTEN = {"xla_allow_excess_precision": False}
TEXT = dict(context_length=8, vocab_size=64, width=32, heads=2, layers=1, output_dim=32)


def _config(cfg, dtype):
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = K
    cfg.TRAIN.BATCH_SIZE_PER_GPU = B
    cfg.TEST.METRIC = ""
    cfg.TPU.PARITY_FP32 = dtype == "float32"
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    return cfg


def _rn_specs():
    from pevit_tpu.core import resnet as jr
    from pevit_tpu_torch.core import resnet as pr

    rs = jr.ResNetSpec(*RN_SPEC)
    js = jc.CLIPSpec(embed_dim=32, text=jc.TextSpec(**TEXT), vision_rn=rs)
    ps = pc.CLIPSpec(embed_dim=32, text=pc.TextSpec(**TEXT),
                     vision_rn=pr.ResNetSpec(**dataclasses.asdict(rs)))
    return js, ps


def tasks(kind, method, dtype="float32"):
    """The JAX task and bundle, and the port's task, bundle and trainable
    parameters on the same weights."""
    name, res, _ = KINDS[kind]
    if kind == "rn":
        jcfg, pcfg = pair("vitb32_CLIP", res=res)
        jspec, pspec = _rn_specs()
        params = jax.tree.map(np.array, jc.init_clip_params(jax.random.PRNGKey(0), jspec))
        randomize_bn(params["visual"], np.random.default_rng(0))
        jb = pb = None
        feat_dim = 0
        clip_params = jax.tree.map(jnp.asarray, params)
    else:
        jcfg, pcfg = pair(name, res=res)
        from pevit_tpu.models import get_model as jax_get_model

        jb, pb = jax_get_model(jcfg), get_model(pcfg, device="cpu")
        jspec = jc.CLIPSpec.from_config(jcfg)
        pspec = pc.CLIPSpec.from_config(pcfg)
        feat_dim, clip_params = jb.feat_dim, None
    jcfg, pcfg = _config(jcfg, dtype), _config(pcfg, dtype)
    jstatic = jt.TaskStatic.from_config(jcfg, jspec, PeftConfig(method=method), feat_dim=feat_dim)
    jtask = jt.TrainTask(jcfg, jstatic, clip_params, backbone=jb, eval_chunk=64)
    trainable, frozen, bn = jtask.init_bundle(jax.random.PRNGKey(1))

    pstatic = TaskStatic.from_config(pcfg, pspec, PortPeftConfig(method=method),
                                     feat_dim=feat_dim)
    bundle, bn_t = bridge.from_jax(np_tree(jcombine(trainable, frozen)), np_tree(bn), pspec,
                                   pstatic.peft_cfg, device="cpu",
                                   backbone=None if pb is None else pb.params)
    ptask = TrainTask(pcfg, pstatic, bundle["clip"], device="cpu", backbone=pb, eval_chunk=64)
    t_tree, _ = partition(bundle, trainable_pred(pstatic))
    return (jtask, trainable, frozen, bn), (ptask, bundle, bn_t, trainable_params(t_tree))


def _data(n, res, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, res, res, 3), dtype=np.uint8),
            rng.integers(0, K, (n,)).astype(np.int32))


def _gap(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def whole_run(kind, method, dtype, *, port_dtype=None):
    """(JAX's val logits, trained tree and BN state; the port's), after the
    same whole run on both stacks.  ``port_dtype`` runs the port's task in
    another compute dtype (the control)."""
    (jtask, trainable, frozen, bn), (ptask, bundle, bn_t, params) = tasks(kind, method, dtype)
    res, lr = KINDS[kind][1], KINDS[kind][2]
    images, labels = _data(N_TRAIN, res, seed=2)
    val, _ = _data(N_VAL, res, seed=3)
    js = jtask.static
    fit_eval = jax.jit(jt.build_fit_eval_fn(js, N_TRAIN, EPOCHS, jtask.preproc, eval_chunk=64,
                                            n_val=N_VAL, forward_fn=jtask._forward_fn),
                       compiler_options=AS_WRITTEN)
    opt_init, _ = jo.make_optimizer(js.optimizer, momentum=js.momentum, nesterov=js.nesterov)
    key = jax.random.PRNGKey(2)
    state, want = fit_eval(frozen, jtask.prepack(images), jnp.asarray(labels), jtask.prepack(val),
                           (trainable, opt_init(trainable), bn, key),
                           jnp.full((EPOCHS,), lr, jnp.float32), jnp.float32(WD))
    st = ptask.static
    if port_dtype is not None:
        st = dataclasses.replace(st, compute_dtype=port_dtype)
    assert not ptask.use_prepack
    p_init, _ = make_optimizer(st.optimizer, momentum=st.momentum, nesterov=st.nesterov)
    fe = build_fit_eval_fn(st, N_TRAIN, EPOCHS, ptask.preproc, eval_chunk=64, n_val=N_VAL,
                           forward_fn=ptask._forward_fn)
    pstate = TrainState(params, p_init(params), bn_t, torch.Generator().manual_seed(0))
    pstate, logits = fe(bundle, ptask.prepack(images), torch.from_numpy(labels).long(),
                        ptask.prepack(val), pstate, [lr] * EPOCHS, WD,
                        orders=_jax_perms(key, N_TRAIN, EPOCHS))
    return (np.asarray(want), np_tree(state[0]), np_tree(state[2]),
            logits.numpy(), bridge._tree_to_jax(params), {k: v.numpy() for k, v in pstate.bn.items()},
            np_tree(trainable))


RUNS = [(k, m, d) for k in KINDS for m in ("linear_probe", "full_finetune")
        for d in ("float32", "bfloat16") if d == "float32" or k != "rn"]


@pytest.mark.parametrize("kind,method,dtype", RUNS)
def test_whole_run_matches(kind, method, dtype):
    want, jtrained, jbn, got, ptrained, pbn, init = whole_run(kind, method, dtype)
    assert got.shape == (EPOCHS, N_VAL, K)
    assert _gap(got[1], got[0]) > 100 * TOL  # training moved the logits
    for e in range(EPOCHS):
        assert _gap(got[e], want[e]) <= TOL, f"val logits, epoch {e}: {_gap(got[e], want[e])}"
    got_t, want_t, init_t = flat(ptrained), flat(jtrained), flat(init)
    assert got_t.keys() == want_t.keys()
    if method == "full_finetune":
        assert any(k.startswith("clip.") for k in want_t)
    else:
        assert all(k.startswith("head.") for k in want_t)
    moved = 0
    largest = max(float(np.abs(v).max()) for v in want_t.values())
    for k in want_t:
        if method == "full_finetune" and k in VANISHING[kind]:
            assert float(np.abs(want_t[k]).max()) <= 1e-5 * largest, k
            assert float(np.abs(got_t[k] - want_t[k]).max()) <= TOL * largest, k
            continue
        assert _gap(got_t[k], want_t[k]) <= TOL, f"trained {k}: {_gap(got_t[k], want_t[k])}"
        moved += _gap(want_t[k], init_t[k]) > 100 * TOL
    assert moved >= len(want_t) // 2
    for k in ("mean", "var"):
        assert _gap(pbn[k], jbn[k]) <= TOL, k


@pytest.mark.parametrize("kind", ["vit", "declip"])
def test_moving_the_bf16_rounding_point_fails(kind):
    """The control: the port normalising in float32 (no bfloat16 rounding
    of the images before the float32 backbone) is off by far more than the
    tolerance."""
    want, _, _, got, _, _, _ = whole_run(kind, "linear_probe", "bfloat16",
                                         port_dtype="float32")
    assert _gap(got[0], want[0]) > 10 * TOL


@pytest.mark.parametrize("method", ["linear_probe", "full_finetune"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_trainable_pred_model_info_and_wd_masks_match(kind, method):
    (jtask, trainable, _, _), (ptask, bundle, _, params) = tasks(kind, method)
    want = {k for k, v in flat(np_tree(trainable)).items()}
    got = set(flat(bridge._tree_to_jax(params)))
    assert got == want
    if kind == "declip" and method == "full_finetune":
        assert not any(k.startswith(("clip.text.", "clip.logit_scale")) for k in got)
        assert "clip.visual.proj" in got
    if kind == "rn" and method == "full_finetune":
        assert "clip.visual.layer1.0.bn1.var" in got
    assert ptask.model_info(ptask.init_bundle(torch.Generator().manual_seed(0))[0]) == \
        jtask.model_info(trainable)
    for rules, timm in ((("ln", "bias"), False), ((), True)):
        for t in (jtask, ptask):
            t.static = dataclasses.replace(t.static, without_wd=rules, timm_filter=timm)
        jmask = {k: float(v) for k, v in flat(jax.tree.map(np.asarray, jtask._wd_mask())).items()}
        pmask = ptask._wd_mask()
        for name, m in pmask.items():
            top, rest = name.split(".", 1)
            path = bridge._reference_path(tuple(rest.split(".")), bridge._STACKED.get(top, ()))
            assert m == jmask[".".join((top,) + path)], name
        assert {".".join((n.split(".", 1)[0],) + bridge._reference_path(
            tuple(n.split(".", 1)[1].split(".")), bridge._STACKED.get(n.split(".")[0], ())))
            for n in pmask} == set(jmask)


@pytest.mark.parametrize("kind", ["vit", "declip"])
def test_serving_with_forward_fn_matches(kind):
    (jtask, trainable, frozen, bn), (ptask, bundle, bn_t, _) = tasks(kind, "linear_probe")
    res = KINDS[kind][1]
    images, _ = _data(5, res, seed=4)
    jserve = jax_serving_fn(jtask.static, trainable, frozen, bn, jtask.preproc,
                            forward_fn=jtask._forward_fn)
    want = np.asarray(jserve(jnp.asarray(images)))
    ptrain, pfrozen = partition(bundle, trainable_pred(ptask.static))
    serve = make_serving_fn(ptask.static, ptrain, pfrozen, bn_t, ptask.preproc,
                            forward_fn=ptask._forward_fn, device="cpu")
    assert _gap(serve(images).numpy(), want) <= TOL
    for bake in (True, False):
        ep = export_classifier(ptask.static, ptrain, pfrozen, bn_t, ptask.preproc,
                               image_size=res, bake_weights=bake, device="cpu",
                               forward_fn=ptask._forward_fn)
        if bake:  # the baked artifact holds no text tower
            assert not any("text" in n for n in ep.state_dict)
            call = exported_callable(ep, device="cpu")
        else:
            from pevit_tpu_torch.serve import serving_weights

            call = exported_callable(ep, serving_weights(ptrain, pfrozen, bn_t), device="cpu")
        for n in (1, 5):
            assert _gap(call(images[:n]).numpy(), want[:n]) <= TOL


@pytest.mark.parametrize("method,fused", [("linear_probe", 1), ("full_finetune", 0)])
def test_the_declip_mlp_route_follows_the_task(monkeypatch, method, fused):
    calls = []
    real = tl.fused_mlp_residual
    monkeypatch.setattr(tl, "fused_mlp_residual",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, (ptask, bundle, bn_t, _) = tasks("declip", method)
    images, _ = _data(2, 64, seed=5)
    ptask.evaluate(*partition(bundle, trainable_pred(ptask.static)), bn_t, images,
                   np.zeros(2, np.int32))
    assert ptask.static.use_fused_mlp is bool(fused)
    assert len(calls) == 2 * fused  # one a block, 2 blocks
