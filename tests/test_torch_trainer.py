"""The training slice against pevit_tpu/train/trainer.py, fp32, on a tiny
ViT (width 128, 2 heads, 2 layers, 64 px, patch 32, so N = 5) with seeded
NON-ZERO KAdaptation factors, K = 4 classes, dropout 0:

* one step: the loss and the gradient of every trainable leaf against
  jax.value_and_grad of the reference's loss, with the reference's fused
  MLP (Pallas kernels in interpret mode) off and on;
* a whole run: build_fit_eval_fn on both stacks, two epochs of 20 images in
  batches of 8 (a natural tail of 4), eval of 70 images after each epoch
  (a chunk of 64 and a natural remainder of 6), the port replaying the JAX
  shuffle through its injectable order; the per-epoch val logits and the
  trained trainables are compared relative to their largest magnitude.  Run
  on the NHWC path (TPU.PARITY_FP32) and on the pre-patchified uint8 path
  with the normalisation folded into the patch embedding;
* smaller cases: a size-1 tail is skipped; TrainTask.evaluate and
  train_trials' selection (strict >, best-epoch probabilities) match.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.core import CLIPSpec, TextSpec, VisionSpec, init_clip_params
from pevit_tpu.peft import PeftConfig
from pevit_tpu.train import optim as jo
from pevit_tpu.train import trainer as jt
from pevit_tpu.train.partition import combine as jcombine
from pevit_tpu_torch import bridge
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.core import clip as port_clip
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import (
    TaskStatic,
    TrainState,
    TrainTask,
    build_fit_eval_fn,
    make_optimizer,
    model_forward,
    partition,
    trainable_params,
    trainable_pred,
)
from pevit_tpu_torch.train.trainer import _loss

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)

RES, K, B = 64, 4, 8
N_TRAIN, N_VAL, EPOCHS = 20, 70, 2
LR, WD = 0.01, 1e-3
TOL = 1e-5
# Scale of the seeded KAdaptation factors.  At 0.5 the q delta makes the
# attention so sharp that float32 rounding differences between the stacks
# grow to ~1e-4 of the logits within two epochs (the parameters still agree
# to ~5e-6); at 0.1 both stay near 1e-6.
FACTOR = 0.1
TINY = CLIPSpec(
    embed_dim=32,
    vision=VisionSpec(input_resolution=RES, patch_size=32, width=128, layers=2, heads=2,
                      output_dim=32),
    text=TextSpec(context_length=8, vocab_size=64, width=32, heads=2, layers=1, output_dim=32),
)
PORT_TINY = port_clip.CLIPSpec(
    embed_dim=TINY.embed_dim,
    vision=port_clip.VisionSpec(**dataclasses.asdict(TINY.vision)),
    text=port_clip.TextSpec(**dataclasses.asdict(TINY.text)),
)


def _cfg(make, *, parity=True, fused=True, **train):
    cfg = make()
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = K
    cfg.TRAIN.BATCH_SIZE_PER_GPU = B
    cfg.TPU.PARITY_FP32 = parity
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.FUSED_MLP = fused
    for k, v in train.items():
        cfg.TRAIN[k] = v
    cfg.freeze()
    return cfg


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, RES, RES, 3), dtype=np.uint8),
            rng.integers(0, K, (n,)).astype(np.int32))


@pytest.fixture(scope="module")
def clip_params():
    return init_clip_params(jax.random.PRNGKey(0), TINY)


def _jax_task(clip_params, *, parity=True, fused=True, **train):
    cfg = _cfg(jax_defaults, parity=parity, fused=fused, **train)
    static = jt.TaskStatic.from_config(cfg, TINY, PeftConfig(method="kadaptation",
                                                             kadapt_dropout_p=0.0))
    task = jt.TrainTask(cfg, static, clip_params)
    trainable, frozen, bn = task.init_bundle(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    layers = trainable["peft"]["layers"]
    for name in ("q_left", "q_right", "v_left", "v_right"):  # non-zero: q grads live
        layers[name] = jnp.asarray(FACTOR * rng.standard_normal(layers[name].shape), jnp.float32)
    layers["b"] = jnp.asarray(0.05 * rng.standard_normal(layers["b"].shape), jnp.float32)
    return task, static, trainable, frozen, bn


def _port_side(trainable, frozen, bn, *, parity=True, **train):
    """The port's task on the same parameters as the JAX side."""
    cfg = _cfg(get_default_config, parity=parity, **train)
    peft_cfg = PortPeftConfig(method="kadaptation", kadapt_dropout_p=0.0)
    static = TaskStatic.from_config(cfg, PORT_TINY, peft_cfg)
    bundle_np = jax.tree.map(np.asarray, jcombine(trainable, frozen))
    bundle, bn_t = bridge.from_jax(bundle_np, jax.tree.map(np.asarray, bn), PORT_TINY, peft_cfg,
                                   device="cpu")
    task = TrainTask(cfg, static, bundle["clip"], device="cpu")
    t_tree, _ = partition(bundle, trainable_pred(static))
    return task, static, bundle, bn_t, trainable_params(t_tree)


def _jax_perms(key, n, epochs):
    """The reference fit's per-epoch shuffle: rng, perm_rng, _ = split(rng, 3)."""
    perms = []
    for _ in range(epochs):
        key, perm_rng, _ = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
    return perms


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_one_step_loss_and_grads_match(clip_params, fused):
    task, static, trainable, frozen, bn = _jax_task(clip_params, fused=fused)
    images, labels = _data(B, seed=1)
    ones = jnp.ones((B,), jnp.float32)

    def loss_fn(tr):
        logits, _ = jt.model_forward(static, jcombine(tr, frozen), bn, jnp.asarray(images),
                                     task.preproc, train=True, rng=jax.random.PRNGKey(5),
                                     mask=ones)
        return jt._loss(static, logits, jnp.asarray(labels), ones)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(trainable)
    ptask, pstatic, bundle, bn_t, params = _port_side(trainable, frozen, bn)
    assert pstatic.use_fused_mlp and pstatic.compute_dtype == "float32"
    valid = torch.ones(B)
    logits, _ = model_forward(pstatic, bundle, bn_t, torch.from_numpy(images), ptask.preproc,
                              train=True, mask=valid)
    loss = _loss(pstatic, logits, torch.from_numpy(labels), valid)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    _close(loss.item(), float(want_loss), "loss")
    got = bridge._tree_to_jax({n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(params.items(), grads)})
    want = _flat(jax.tree.map(np.asarray, want_grads))
    got = _flat(got)
    assert got.keys() == want.keys()
    for name in want:
        if name.split(".")[-1] in ("v_left", "v_right"):  # quirk 1: unused, zero on both
            assert not np.any(got[name]) and not np.any(want[name])
        else:
            assert np.any(want[name]), name
            _close(got[name], want[name], f"grad {name}")


@pytest.mark.parametrize("parity", [True, False], ids=["nhwc", "prepack"])
def test_whole_run_matches(clip_params, parity):
    task, static, trainable, frozen, bn = _jax_task(clip_params, parity=parity)
    assert task.use_prepack is (not parity)
    images, labels = _data(N_TRAIN, seed=2)
    val, _ = _data(N_VAL, seed=3)
    fit_eval = jax.jit(jt.build_fit_eval_fn(static, N_TRAIN, EPOCHS, task.preproc,
                                            eval_chunk=64, n_val=N_VAL))
    opt_init, _ = jo.make_optimizer(static.optimizer, momentum=static.momentum,
                                    nesterov=static.nesterov)
    key = jax.random.PRNGKey(2)
    state, want_logits = fit_eval(frozen, task.prepack(images), jnp.asarray(labels),
                                  task.prepack(val), (trainable, opt_init(trainable), bn, key),
                                  jnp.full((EPOCHS,), LR, jnp.float32), jnp.float32(WD))

    ptask, pstatic, bundle, bn_t, params = _port_side(trainable, frozen, bn, parity=parity)
    packed = ptask.prepack(images)
    assert packed.dim() == (4 if parity else 3) and packed.dtype == torch.uint8
    p_init, _ = make_optimizer(pstatic.optimizer, momentum=pstatic.momentum,
                               nesterov=pstatic.nesterov)
    fe = build_fit_eval_fn(pstatic, N_TRAIN, EPOCHS, ptask.preproc, eval_chunk=64, n_val=N_VAL)
    pstate = TrainState(params, p_init(params), bn_t, torch.Generator().manual_seed(0))
    pstate, logits = fe(bundle, packed, torch.from_numpy(labels).long(), ptask.prepack(val),
                        pstate, [LR] * EPOCHS, WD, orders=_jax_perms(key, N_TRAIN, EPOCHS))
    assert logits.shape == (EPOCHS, N_VAL, K) and torch.isfinite(pstate.loss)
    # the second epoch moved the logits by far more than the tolerance
    assert (logits[1] - logits[0]).abs().max() > 100 * TOL * logits.abs().max()
    for e in range(EPOCHS):
        _close(logits[e].numpy(), np.asarray(want_logits[e]), f"val logits, epoch {e}")
    got = _flat(bridge._tree_to_jax(params))
    want = _flat(jax.tree.map(np.asarray, state[0]))
    assert got.keys() == want.keys()
    for name in want:
        _close(got[name], want[name], f"trained {name}")
        if name.split(".")[-1] not in ("v_left", "v_right"):
            moved = np.abs(want[name] - _flat(jax.tree.map(np.asarray, trainable))[name]).max()
            assert moved > 100 * TOL * np.abs(want[name]).max(), name
    for k in ("mean", "var"):
        _close(pstate.bn[k].numpy(), np.asarray(state[2][k]), f"bn {k}")


@pytest.mark.parametrize("n_train,steps", [(9, 1), (10, 2), (16, 2)])
def test_size_one_tail_is_skipped(clip_params, n_train, steps):
    _, _, trainable, frozen, bn = _jax_task(clip_params)
    task, static, bundle, bn_t, params = _port_side(trainable, frozen, bn, OPTIMIZER="adam")
    images, labels = _data(n_train, seed=4)
    fe = build_fit_eval_fn(static, n_train, 1, task.preproc, eval_chunk=64, n_val=3)
    init, _ = make_optimizer("adam")
    state = TrainState(params, init(params), bn_t, torch.Generator().manual_seed(0))
    state, _ = fe(bundle, task.prepack(images), torch.from_numpy(labels).long(),
                  task.prepack(images[:3]), state, [LR], WD)
    assert state.opt.step == steps


def test_evaluate_matches(clip_params):
    task, static, trainable, frozen, bn = _jax_task(clip_params)
    val, labels = _data(N_VAL, seed=5)
    stack = lambda t: jax.tree.map(lambda a: a[None], t)
    (want_score,), (want_probs,) = task.evaluate(frozen, stack(trainable), stack(bn), val,
                                                 labels, 1)
    ptask, _, bundle, bn_t, _ = _port_side(trainable, frozen, bn)
    t_tree, f_tree = partition(bundle, trainable_pred(ptask.static))
    score, probs = ptask.evaluate(t_tree, f_tree, bn_t, val, labels)
    assert score == pytest.approx(want_score, abs=1e-9)
    _close(probs, want_probs, "eval probs")


def _canned_logits():
    """(trials, epochs, n_val, K) logits with accuracies [50, 50, 83.3, 66.7]
    and [0, 33.3, 33.3, 100] percent on labels 0, 1, 2, 0, 1, 2."""
    labels = np.array([0, 1, 2, 0, 1, 2])
    hits = [[3, 3, 5, 4], [0, 2, 2, 6]]
    out = np.zeros((2, 4, 6, 3), np.float32)
    for t in range(2):
        for e in range(4):
            for i, y in enumerate(labels):
                out[t, e, i, y if i < hits[t][e] else (y + 1) % 3] = 2.0 + 0.1 * e
    return labels, out


@pytest.mark.parametrize("keep_logits", [False, True])
def test_train_trials_selection_matches(clip_params, monkeypatch, keep_logits):
    labels, canned = _canned_logits()
    task, static, trainable, frozen, bn = _jax_task(clip_params)
    monkeypatch.setattr(task, "_fit_eval_fn",
                        lambda *a, **k: (lambda fr, im, lb, vi, st, lr, wd: (st, canned)))
    images, train_labels = _data(4, seed=6)
    val, _ = _data(6, seed=7)
    hp = [(0.1, 0.0), (0.01, 1e-4)]
    want = task.train_trials(hp, images, train_labels, val, labels, end_epoch=4,
                             keep_logits=keep_logits)

    ptask, *_ = _port_side(trainable, frozen, bn)
    calls = iter(range(2))

    def fake_fit_eval(bundle, im, lb, vi, state, lr_table, wd):
        return state, torch.from_numpy(canned[next(calls)])

    monkeypatch.setattr(ptask, "_fit_eval_fn", lambda *a: fake_fit_eval)
    got = ptask.train_trials(hp, images, train_labels, val, labels, end_epoch=4,
                             keep_logits=keep_logits)
    for g, w in zip(got, want):
        assert g["best_score"] == pytest.approx(w["best_score"], abs=1e-9)
        assert g["last_score"] == pytest.approx(w["last_score"], abs=1e-9)
        if keep_logits:
            np.testing.assert_allclose(g["best_logits"], w["best_logits"], rtol=1e-6, atol=1e-7)
        else:
            assert g["best_logits"] is None and w["best_logits"] is None


def test_train_trials_runs_on_the_cpu_when_asked(clip_params):
    """The entry points end to end on the CPU: TaskStatic.from_config ->
    TrainTask.init_bundle -> train_trials; the frozen tower stays put, the
    trainables move."""
    _, _, trainable, frozen, bn = _jax_task(clip_params)
    task, static, bundle, _, _ = _port_side(trainable, frozen, bn, parity=False)
    images, labels = _data(12, seed=8)
    val, val_labels = _data(5, seed=9)
    before = {n: p.detach().clone() for n, p in task.clip.named_parameters()}
    res = task.train_trials([(LR, WD)], images, labels, val, val_labels, end_epoch=2,
                            keep_logits=True)
    assert 0.0 <= res[0]["best_score"] <= 100.0 and res[0]["best_logits"].shape == (5, K)
    assert all(torch.equal(p, before[n]) for n, p in task.clip.named_parameters())
    state = task.last_state
    assert torch.isfinite(state.loss) and state.opt.momentum_buf["peft.layers.0.b"].any()
    info = task.model_info(partition(task.last_bundle, trainable_pred(static))[0])
    assert info["n_trainable_params"] == sum(p.numel() for p in state.params.values())
