"""A sweep chunk's trials trained as one batch (``TrainTask.train_trials``)
under full fine-tuning and on the auxiliary backbones, fp32, K = 4, 3
trials of distinct (lr, wd), 2 epochs of 20 images in batches of 8 (a
natural tail of 4), 70 val images (a chunk of 64 and a natural remainder of
6), at toy geometry: the tiny CLIP ViT of ``test_torch_trainer`` (width
128, 2 layers, 64 px), an RN CLIP tower (width 8, live BatchNorms, 64 px),
a timm ViT-B/16 layout (width 64, 2 layers, 32 px), a DeCLIP ViT-B/32
layout (width 64, 2 layers, 64 px) and a Swin-T layout (two stages of two
16-wide blocks, window 4, 32 px):

* batched against the port's serial path (``_train_trials_serial``):
  full_finetune on the CLIP ViT and the RN tower, linear_probe and
  full_finetune on the ViT, DeCLIP and Swin with drop path 0.1 (each
  trial's draws from its own generators, draw for draw), and full_finetune
  under Nesterov SGD with the gradient clip, TRAIN.TWO_LR and timm's
  weight-decay filter: every (trial, epoch) val logit and every trained
  parameter within 1e-5 of the largest;
* batched against the reference's vmapped ``train_trials`` (the JAX
  package on the CPU, each trial's JAX orders injected): full_finetune on
  the CLIP ViT, linear_probe and full_finetune on the ViT, DeCLIP and Swin
  with drop path 0;
* controls: the trial axis does not leak (permuting trial 1's tower weights
  leaves trial 0's logits bit for bit); a stacked (T, C) bias under timm's
  filter takes no weight decay; a chunk of one trial is the serial run bit
  for bit; ``last_*`` and the checkpoint round trip give the last trial's
  own tower at its lone shape; a streamed batched epoch equals the preloaded
  one handed its orders; the tower's kernels launch once a block a step for
  the whole chunk.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.models import get_model as jax_get_model
from pevit_tpu.peft import PeftConfig
from pevit_tpu.train import trainer as jt
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import restore_trainable, save_trainable
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.core import clip as pc
from pevit_tpu_torch.core import resnet as pr
from pevit_tpu_torch.models import get_model
from pevit_tpu_torch.ops import attention as attn_ops
from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig
from pevit_tpu_torch.train import (
    TaskStatic,
    TrainTask,
    make_optimizer,
    model_forward,
    partition,
    trainable_params,
    trainable_pred,
)
from pevit_tpu_torch.train import streaming as ps

from .test_torch_backbone_probe import RN_SPEC, TEXT
from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_factory import listless, pair
from .test_torch_swin import TOY_SWIN
from .test_torch_swin import _pair as swin_pair
from .test_torch_trainer import (
    PORT_TINY,
    TINY,
    _cfg,
    _flat,
    _jax_perms,
    clip_params,  # noqa: F401  (fixture)
)

K, B = 4, 8
N_TRAIN, N_VAL, EPOCHS = 20, 70, 2
HPARAMS = [(0.01, 1e-3), (0.003, 1e-2), (0.02, 0.0)]
TOL = 1e-5
SEED = 3
# the toy backbones: (model YAML or Swin name, image size)
BACKBONES = {"vit": ("vit_base_patch16_224", 32), "declip": ("vitb32_DeCLIP", 64),
             "swin": ("cls_swin_tiny", 32)}
RES = {"clip": 64, "rn": 64, **{k: v[1] for k, v in BACKBONES.items()}}
DROP_PATH = 0.1
# The RN tower is float32-fragile: a lone trial's first-step gradients move
# by 2e-4 of their largest value when only its batch's order changes, and
# its pooled features on uniform noise vary by 0.8% of their size across a
# batch (the median over features of std / mean), which the head's
# train-mode BN magnifies.  So, as in ``test_torch_backbone_probe``, it
# trains at rates near 3e-4, and its images are 80% a tint of their own
# (a spread of 6%): the batched run then parts from the serial one by 2e-6
# of the largest val logit, against 1.4e-4 on noise images.
RN_TINT = 0.8
# each kind's rates as a multiple of HPARAMS'.  Against the reference, full
# fine-tuning of the DeCLIP tower at HPARAMS' rates is chaotic in float32
# (trial 2's val logits reach 45 and part from the reference's by 2e-4 of
# the largest in two epochs, the other cases by at most 5e-6): it runs at a
# tenth of them, where it parts by 1.7e-6.
LR_SCALE = {"rn": 0.03}
REFERENCE_LR_SCALE = {("declip", "full_finetune"): 0.1}
# leaves whose fine-tuning gradient vanishes in exact arithmetic, so that
# what either path trains there is rounding noise: a bias that shifts every
# feature by one vector, which the head's train-mode BN subtracts, and the
# RN attention pool's biases (``test_torch_backbone_probe.VANISHING``).
# Their gaps are held to the largest magnitude of the trained tree.
VANISHING = {"clip": ("clip.visual.ln_post.bias",), "declip": ("clip.visual.ln_post.bias",),
             "vit": ("clip.norm.bias",), "swin": ("clip.norm.bias",),
             "rn": tuple(f"clip.visual.attnpool.{n}_proj.bias" for n in "cvkq")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's many small operators, restored
    afterwards (as ``test_torch_trial_batch``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


def _data(n, res, seed, kind=None):
    """Uniform-noise uint8 images and labels; for the RN tower each image is
    mostly a tint of its own (``RN_TINT``)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, res, res, 3), dtype=np.uint8)
    if kind == "rn":
        tint = rng.integers(0, 256, (n, 1, 1, 3))
        images = (RN_TINT * tint + (1 - RN_TINT) * images).astype(np.uint8)
    return images, rng.integers(0, K, (n,)).astype(np.int32)


def _fp32(cfg, **train):
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = K
    cfg.TRAIN.BATCH_SIZE_PER_GPU = B
    cfg.TEST.METRIC = ""
    cfg.TPU.PARITY_FP32 = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for k, v in train.items():
        cfg.TRAIN[k] = v
    cfg.freeze()
    return cfg


def _backbone_cfgs(kind, drop_path=0.0, **train):
    name, res = BACKBONES[kind]
    if kind == "swin":
        jcfg, pcfg = swin_pair(name, **TOY_SWIN, DROP_PATH_RATE=drop_path)
    else:
        jcfg, pcfg = pair(name, res=res)
    return _fp32(jcfg, **train), _fp32(pcfg, **train)


def _rn_clip():
    """An RN CLIP tower of width 8 with live BatchNorm affine and statistics."""
    spec = pc.CLIPSpec(embed_dim=32, text=pc.TextSpec(**TEXT), vision_rn=pr.ResNetSpec(*RN_SPEC))
    clip = pc.init_clip_params(torch.Generator().manual_seed(0), spec, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in clip.visual.modules():
            if isinstance(m, pr.BatchNorm):
                m.scale.copy_(1 + 0.1 * torch.randn(m.scale.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.mean.copy_(0.2 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(torch.rand(m.var.shape, generator=gen) + 0.5)
    return clip, spec


def port_task(kind, method, clip_params=None, *, drop_path=0.0, **train):
    """The port's task of ``kind`` for ``method``, fp32: the tiny CLIP ViT
    (bridged from ``clip_params``), the RN CLIP tower, or a backbone from
    its toy YAML (random weights from the factory's seed)."""
    peft = PortPeftConfig(method=method, kadapt_dropout_p=0.0)
    if kind == "clip":
        cfg = _cfg(get_default_config, **train)
        clip = bridge.clip_from_jax(jax.tree.map(np.asarray, clip_params), PORT_TINY, device="cpu")
        return TrainTask(cfg, TaskStatic.from_config(cfg, PORT_TINY, peft), clip, device="cpu")
    if kind == "rn":
        cfg = _fp32(pair("vitb32_CLIP", res=RES["rn"])[1], **train)
        clip, spec = _rn_clip()
        return TrainTask(cfg, TaskStatic.from_config(cfg, spec, peft), clip, device="cpu")
    _, cfg = _backbone_cfgs(kind, drop_path, **train)
    pb = get_model(cfg, device="cpu")
    static = TaskStatic.from_config(cfg, pc.CLIPSpec.from_config(cfg), peft, feat_dim=pb.feat_dim)
    return TrainTask(cfg, static, None, device="cpu", backbone=pb, eval_chunk=64)


def _spy_fit_eval(task, seen: list, **extra):
    """Record each fit_eval call's (trained params, val logits); ``extra``
    goes to every call (injected orders)."""
    build = task._fit_eval_fn

    def wrapped(*a, **k):
        fit_eval = build(*a, **k)

        def run(*args, **kw):
            state, logits = fit_eval(*args, **kw, **extra)
            seen.append(({n: p.detach().clone() for n, p in state.params.items()},
                         logits.numpy()))
            return state, logits
        return run

    task._fit_eval_fn = wrapped


def _trained_close(got: dict, want: dict, kind: str, what: str) -> None:
    """Every trained parameter within 1e-5 of its largest value; a
    vanishing leaf (``VANISHING``) within 1e-5 of the tree's largest."""
    assert got.keys() == want.keys()
    largest = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if name in VANISHING[kind]:
            assert float(np.abs(g - w).max()) <= TOL * largest, f"{what} {name}"
            continue
        _close(g, w, f"{what} {name}")


def _run(task, kind, serial: bool, hparams=None):
    """Per trial: (val logits (epochs, n_val, K), {name: trained param})."""
    images, labels = _data(N_TRAIN, RES[kind], seed=2, kind=kind)
    val, val_labels = _data(N_VAL, RES[kind], seed=3, kind=kind)
    seen = []
    hparams = hparams or [(lr * LR_SCALE.get(kind, 1.0), wd) for lr, wd in HPARAMS]
    _spy_fit_eval(task, seen)
    train = task._train_trials_serial if serial else task.train_trials
    train(hparams, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    if serial:
        return [(logits, params) for params, logits in seen]
    ((params, logits),) = seen  # one batched call
    return [(logits[t], {n: p[t] for n, p in params.items()}) for t in range(len(hparams))]


SERIAL_CASES = [
    pytest.param("clip", "full_finetune", {}, id="clip-full_finetune"),
    pytest.param("rn", "full_finetune", {}, id="rn-full_finetune"),
    *[pytest.param(k, m, {}, id=f"{k}-{m}") for k in ("vit", "declip", "swin")
      for m in ("linear_probe", "full_finetune")],
    pytest.param("vit", "full_finetune",
                 {"OPTIMIZER": "timm", "OPTIMIZER_ARGS": {"opt": "sgd", "momentum": 0.9},
                  "CLIP_GRAD_NORM": 0.05, "TWO_LR": True},
                 id="vit-full_finetune-nesterov-clip-twolr-timmfilter"),
]


@pytest.mark.parametrize("kind,method,train", SERIAL_CASES)
def test_batched_equals_serial(clip_params, kind, method, train):
    make = lambda: port_task(kind, method, clip_params, drop_path=DROP_PATH, **train)
    task = make()
    assert task.batches_trials
    if train:
        assert task.static.nesterov and task.static.timm_filter
    got = _run(task, kind, serial=False)
    want = _run(make(), kind, serial=True)
    assert len(got) == len(want) == len(HPARAMS)
    for t, ((g_logits, g_params), (w_logits, w_params)) in enumerate(zip(got, want)):
        assert g_logits.shape == (EPOCHS, N_VAL, K)
        # training moved the logits by far more than the tolerance
        assert np.abs(w_logits[1] - w_logits[0]).max() > 100 * TOL * np.abs(w_logits).max()
        for e in range(EPOCHS):
            _close(g_logits[e], w_logits[e], f"trial {t} epoch {e} val logits")
        assert any(n.startswith("clip.") for n in w_params) == (method == "full_finetune")
        _trained_close(g_params, w_params, kind, f"trial {t} trained")
    # the trials differ: each kept its own (lr, wd) and draws
    assert np.abs(got[0][0] - got[1][0]).max() > 1e-3


def _live_biases(tree):
    """The tree with N(0, 0.02) added to every bias, as a pretrained tower's
    are live: a bias trained from zero for two epochs holds values near
    1e-4, where float32 summation order alone moves it by 1e-5 of itself."""
    rng = np.random.default_rng(5)

    def live(path, leaf):
        if getattr(path[-1], "key", None) != "bias":
            return leaf
        return leaf + (0.02 * rng.standard_normal(np.shape(leaf))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(live, jax.tree.map(np.asarray, tree))


def _reference_tasks(kind, method, clip_params):
    """The reference's task and the port's on the same weights (the tower's
    biases live, ``_live_biases``)."""
    peft = PeftConfig(method=method, kadapt_dropout_p=0.0)
    if kind == "clip":
        jcfg = _cfg(jax_defaults)
        clip_params = _live_biases(clip_params)
        jtask = jt.TrainTask(jcfg, jt.TaskStatic.from_config(jcfg, TINY, peft), clip_params)
        return jtask, port_task(kind, method, clip_params)
    jcfg, _ = _backbone_cfgs(kind)
    jb = jax_get_model(jcfg)
    jb = dataclasses.replace(jb, params=_live_biases(jb.params))
    from pevit_tpu.core import clip as jc

    jstatic = jt.TaskStatic.from_config(jcfg, jc.CLIPSpec.from_config(jcfg), peft,
                                        feat_dim=jb.feat_dim)
    jtask = jt.TrainTask(jcfg, jstatic, None, backbone=jb, eval_chunk=64)
    ptask = port_task(kind, method)
    bridge.module_from_jax(jax.tree.map(np.asarray, jb.params), ptask.clip, device="cpu")
    return jtask, ptask


REFERENCE_CASES = [pytest.param("clip", "full_finetune", id="clip-full_finetune"),
                   *[pytest.param(k, m, id=f"{k}-{m}") for k in ("vit", "declip", "swin")
                     for m in ("linear_probe", "full_finetune")]]


@pytest.mark.parametrize("kind,method", REFERENCE_CASES)
def test_batched_equals_the_reference_vmapped_trials(clip_params, monkeypatch, kind, method):
    T, res = len(HPARAMS), RES[kind]
    hparams = [(lr * REFERENCE_LR_SCALE.get((kind, method), 1.0), wd) for lr, wd in HPARAMS]
    images, labels = _data(N_TRAIN, res, seed=4)
    val, val_labels = _data(N_VAL, res, seed=5)
    jtask, ptask = _reference_tasks(kind, method, clip_params)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), 17), T)
    inits = [jtask.init_bundle(keys[t]) for t in range(T)]
    orders = [_jax_perms(jax.random.fold_in(keys[t], 23), N_TRAIN, EPOCHS) for t in range(T)]
    monkeypatch.setattr(jtask, "init_bundle", lambda key: inits[
        next(t for t in range(T) if np.array_equal(np.asarray(keys[t]), np.asarray(key)))])
    jseen = []
    real_fe = jtask._fit_eval_fn

    def jax_fit_eval_fn(*a, **k):
        fe = real_fe(*a, **k)
        return lambda *args: (lambda out: (jseen.append(out), out)[1])(fe(*args))

    monkeypatch.setattr(jtask, "_fit_eval_fn", jax_fit_eval_fn)
    with jax.default_matmul_precision("highest"):
        jtask.train_trials(hparams, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    ((jstate, jlogits),) = jseen
    want_logits = np.asarray(jlogits)  # (T, E, n_val, K)

    def port_init(gen, tower=None):
        """Trial t's bundle from the reference's: its head and BN state
        bridged, the tower the task's (an alias of it under full_finetune,
        whose reference trials all start from the pretrained tower)."""
        t = (gen.initial_seed() - SEED * 1_000_003) // 2
        trainable, frozen, bn = inits[t]
        bundle, bn_t = bridge.from_jax(
            jax.tree.map(np.asarray, jt.combine(trainable, frozen)),
            jax.tree.map(np.asarray, bn), PORT_TINY, ptask.static.peft_cfg, device="cpu",
            backbone=None if ptask.backbone is None else copy.deepcopy(ptask.clip))
        bundle["clip"] = ptask.clip if tower is None else tower
        return (*partition(bundle, trainable_pred(ptask.static)), bn_t)

    monkeypatch.setattr(ptask, "init_bundle", port_init)
    pseen = []
    _spy_fit_eval(ptask, pseen, orders=[np.stack([o[e] for o in orders]) for e in range(EPOCHS)])
    ptask.train_trials(hparams, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    ((pparams, plogits),) = pseen
    assert plogits.shape == want_logits.shape == (T, EPOCHS, N_VAL, K)
    # the second epoch moved the logits by far more than the tolerance
    assert np.abs(want_logits[:, 1] - want_logits[:, 0]).max() > 100 * TOL * np.abs(want_logits).max()
    for t in range(T):
        for e in range(EPOCHS):
            _close(plogits[t, e], want_logits[t, e], f"trial {t} epoch {e} val logits")
    for t in range(T):
        got = _flat(listless(bridge._tree_to_jax({n: p[t] for n, p in pparams.items()})))
        want = _flat(listless(jax.tree.map(lambda a: np.asarray(a)[t], jstate[0])))
        assert any(k.startswith("clip.") for k in want) == (method == "full_finetune")
        _trained_close(got, want, kind, f"trial {t} trained")


def _eval_logits(task, bundle, bn, x, trials):
    with torch.no_grad():
        return model_forward(task.static, bundle, bn, x, task.preproc, train=False,
                             forward_fn=task._forward_fn, trials=trials)[0]


@pytest.mark.parametrize("kind", ["clip", "rn", "vit", "swin"])
def test_the_trial_axis_does_not_leak(clip_params, kind):
    """Two trials' stacked towers on one folded batch: permuting the
    entries of every tower weight of trial 1 leaves trial 0's logits bit
    for bit, while trial 1's move."""
    task = port_task(kind, "full_finetune", clip_params)
    batch = task._init_trials(SEED, 2)
    images, _ = _data(8, RES[kind], seed=6, kind=kind)
    x = task.prepack(images)
    x = torch.cat([x, x])
    before = _eval_logits(task, batch.bundle, batch.state.bn, x, 2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in batch.bundle["clip"].parameters():
            if p.requires_grad and p[1].numel() > 1:
                flat = p[1].flatten()
                p[1].copy_(flat[torch.randperm(flat.numel(), generator=gen)].view(p[1].shape))
    after = _eval_logits(task, batch.bundle, batch.state.bn, x, 2)
    assert torch.equal(after[0], before[0])
    assert (after[1] - before[1]).abs().max() > 1e-3 * before[1].abs().max()


def test_a_stacked_bias_under_the_timm_filter_takes_no_weight_decay(clip_params):
    """The timm filter reads a lone trial's shapes: a bias or a LayerNorm
    scale is (C,) alone and (T, C) in the stack, and takes no decay in
    either; a kernel decays in every trial."""
    task = port_task("vit", "full_finetune",
                     OPTIMIZER="timm", OPTIMIZER_ARGS={"opt": "sgd", "momentum": 0.9})
    mask = task._wd_mask()
    bias, scale, kernel = "clip.patch_embed.bias", "clip.norm.scale", "clip.patch_embed.kernel"
    assert mask[bias] == mask[scale] == 0.0 and mask[kernel] == 1.0
    # a block's bias is (L, C) in the reference's layer-stacked tree, so it decays
    assert mask["clip.blocks.0.attn.in_proj.bias"] == 1.0 and mask["clip.cls_token"] == 0.0
    batch = task._init_trials(SEED, 3)
    params = batch.state.params
    assert params[bias].shape == params[scale].shape == (3, 64)
    before = {n: p.detach().clone() for n, p in params.items()}
    _, update = make_optimizer("sgd", momentum=0.9, nesterov=True, wd_mask=mask)
    update({n: torch.zeros_like(p) for n, p in params.items()}, params, batch.state.opt,
           torch.tensor([0.1, 0.2, 0.3]), torch.tensor([0.1, 0.1, 0.1]))
    for n in (bias, scale):
        assert torch.equal(params[n], before[n]), n
    for t in range(3):
        assert not torch.equal(params[kernel][t], before[kernel][t])


@pytest.mark.parametrize("kind", ["clip", "rn", "swin"])
def test_a_chunk_of_one_trial_is_the_serial_run(clip_params, kind):
    """A chunk of one (the final run) goes through the batched path on a
    stack of one trial, whose primitives take the lone operations: the val
    logits and every trained parameter equal the serial run's bit for bit."""
    hp = [(HPARAMS[0][0] * LR_SCALE.get(kind, 1.0), HPARAMS[0][1])]
    make = lambda: port_task(kind, "full_finetune", clip_params, drop_path=DROP_PATH)
    ((g_logits, g_params),) = _run(make(), kind, serial=False, hparams=hp)
    ((w_logits, w_params),) = _run(make(), kind, serial=True, hparams=hp)
    np.testing.assert_array_equal(g_logits, w_logits)
    assert g_params.keys() == w_params.keys()
    for n in w_params:
        assert torch.equal(g_params[n], w_params[n]), n


@pytest.mark.parametrize("kind", ["clip", "swin"])
def test_the_last_trial_is_kept_and_round_trips(clip_params, tmp_path, kind):
    res = RES[kind]
    images, labels = _data(N_TRAIN, res, seed=9)
    val, val_labels = _data(N_VAL, res, seed=10)
    kept = {}
    for name, serial in (("batched", False), ("serial", True)):
        task = port_task(kind, "full_finetune", clip_params, drop_path=DROP_PATH)
        train = task._train_trials_serial if serial else task.train_trials
        train(HPARAMS, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
        kept[name] = task
    got, want = kept["batched"], kept["serial"]
    g_params, w_params = trainable_params(got.last_trainable), trainable_params(want.last_trainable)
    assert g_params.keys() == w_params.keys()
    assert any(n.startswith("clip.") for n in g_params)
    for n in w_params:
        assert g_params[n].shape == w_params[n].shape  # the lone shape
        _close(g_params[n].detach().numpy(), w_params[n].detach().numpy(), f"last trainable {n}")
    bundle_params = trainable_params(partition(got.last_bundle, trainable_pred(got.static))[0])
    assert all(bundle_params[n] is p for n, p in g_params.items())
    assert all(got.last_state.params[n] is p for n, p in g_params.items())
    assert got.model_info(got.last_trainable) == want.model_info(want.last_trainable)
    save_trainable(str(tmp_path), got.last_bundle, step=EPOCHS)
    restored = restore_trainable(str(tmp_path), got.last_bundle)
    assert restored.keys() == g_params.keys()
    assert all(torch.equal(restored[n], g_params[n].detach()) for n in g_params)
    score, _ = got.evaluate(got.last_trainable,
                            partition(got.last_bundle, trainable_pred(got.static))[1],
                            got.last_state.bn, val, val_labels)
    assert 0.0 <= score <= 100.0


@pytest.mark.parametrize("kind", ["clip", "swin"])
def test_a_streamed_batched_epoch_equals_the_preloaded_one(clip_params, kind):
    res = RES[kind]
    images, labels = _data(N_TRAIN + 1, res, seed=11)  # 8 + 8 + a tail of 5
    val, val_labels = _data(N_VAL, res, seed=12)
    task = port_task(kind, "full_finetune", clip_params, drop_path=DROP_PATH)
    task.config.defrost()
    task.config.TPU.MAX_DEVICE_DATA_GB = 1e-9
    task.config.freeze()
    seen = []
    real = task._evaluate_trials
    task._evaluate_trials = lambda *a: (lambda out: (seen.append(out), out)[1])(real(*a))
    task.train_trials(HPARAMS, images, labels, val, val_labels, end_epoch=EPOCHS, seed=SEED)
    assert len(seen) == EPOCHS
    streamed_last = {n: p.detach().clone() for n, p in trainable_params(task.last_trainable).items()}

    twin = port_task(kind, "full_finetune", clip_params, drop_path=DROP_PATH)
    T = len(HPARAMS)
    fit_eval = twin._fit_eval_fn(len(labels), EPOCHS, N_VAL, T)
    batch = twin._init_trials(SEED, T)
    orders = [ps.epoch_order(len(labels), SEED * 1000 + e) for e in range(EPOCHS)]
    _, logits = fit_eval(batch.bundle, twin.prepack(images), twin._labels(labels),
                         twin.prepack(val), batch.state, [[lr] * EPOCHS for lr, _ in HPARAMS],
                         [wd for _, wd in HPARAMS], orders=orders)
    for e in range(EPOCHS):
        for t in range(T):
            z = logits[t, e].numpy()
            z = z - z.max(-1, keepdims=True)
            np.testing.assert_array_equal(seen[e][t][1], np.exp(z) / np.exp(z).sum(-1, keepdims=True))
    twin_last = trainable_params(batch.trees[-1][0])
    assert streamed_last.keys() == twin_last.keys()
    for n, p in streamed_last.items():
        assert torch.equal(p, twin_last[n].detach())


@pytest.mark.parametrize("kind,method", [("clip", "full_finetune"), ("vit", "full_finetune"),
                                         ("declip", "linear_probe")])
def test_the_tower_launches_once_a_block_a_step_for_the_chunk(clip_params, monkeypatch, kind,
                                                              method):
    """A chunk of 3 trials calls the attention core's plain version (K1's
    stand-in on the CPU) exactly as often as a chunk of 1: once a block a
    train step and an eval chunk."""
    calls = []
    real = attn_ops.attention_ref
    monkeypatch.setattr(attn_ops, "attention_ref", lambda *a: calls.append(a[0].shape) or real(*a))
    res = RES[kind]
    images, labels = _data(N_TRAIN, res, seed=6)
    val, val_labels = _data(N_VAL, res, seed=7)
    counts = []
    for hparams in (HPARAMS[:1], HPARAMS):
        task = port_task(kind, method, clip_params)
        calls.clear()
        task.train_trials(hparams, images, labels, val, val_labels, end_epoch=EPOCHS)
        counts.append(len(calls))
        # the largest call: every trial's copy of the first eval chunk
        assert max(shape[0] for shape in calls) == len(hparams) * min(task.eval_chunk, N_VAL)
    steps = EPOCHS * 3  # 8 + 8 + 4 images
    chunks = EPOCHS * -(-N_VAL // task.eval_chunk)
    assert counts == [2 * (steps + chunks)] * 2  # 2 blocks
