"""The task trainer: task configuration, the forward and loss, whole
training runs with per-epoch evaluation (training subset of
``pevit_tpu/train/trainer.py``).

The reference runs an epoch as one XLA computation and trains a chunk of
hyperparameter trials at once under ``vmap``, on a device mesh.  The port
runs eagerly, one process a card, and trains a chunk of trials as one batched
computation too (``TrainTask.train_trials``), for every method and backbone,
with the trial axis written out: the tower runs once a step on the chunk's
T*B images, so its kernels launch once for the whole chunk, and only what
differs per trial carries a leading trial axis: the PEFT parameters, the
head, the BN state and the optimiser state, and under ``full_finetune`` the
trained tower itself, stacked (T, ...) (``partition.stack_trials``, each
trial's own modules views into the stack), and the PEFT hooks, the tower's
primitives (``core.trial_axis``), the head's BN, the loss (the sum of each
trial's masked mean), the gradient clip and the optimisers apply trial t's
parameters, learning rate and weight decay to trial t's rows.  A frozen
tower, the CLIP's or an auxiliary backbone's, is shared.
``_train_trials_serial`` trains one trial after another: the yardstick the
batched path is held to.  The math is the reference's:

* each epoch visits the train split in a shuffled order, each trial its own
  (drawn from the trial's generator, or injected by the caller so that a
  run can replay another's order); full batches, then the tail at its
  NATURAL size — padding is not equivalent because KAdaptation's
  raw-reshape scramble mixes batch rows — and a tail of one image is
  skipped;
* gradients are taken for the trainable partition only (the frozen
  parameters have ``requires_grad`` False); a trainable tensor that the
  forward does not use (KAdaptation's v factors, quirk 1) gets a zero
  gradient, so weight decay still applies to it as in the reference;
* each step draws each trial's dropout (KAdaptation's, a Swin backbone's
  stochastic depth and dropout) from a fresh generator on the card, seeded
  from the trial's epoch seed and the step index;
* after every epoch the val split is evaluated in chunks of ``eval_chunk``
  plus a natural-size remainder, never padded, every trial on the same
  chunk; the best epoch is picked on the host (strict ``>``, keeping the
  best epoch's probabilities);
* a numpy train split above ``TPU.MAX_DEVICE_DATA_GB`` stays in host memory
  and is streamed (``streaming.py``): there the reference's numpy epoch
  orders are used, one for every trial, and the chunk's trials take one
  batched step on each batch.

In a world of several ranks (``utils.dist``) a call lays its trials and
batches over a (trial, data, model) mesh of them as the reference does
(``TrainTask._mesh_plan``, ``parallel.mesh``): a chunk's trials cut over
the trial ranks, a lone trial's full batches cut over the data ranks
(natural tails and eval remainders replicated), and with
``TPU.MESH_MODEL`` a frozen CLIP tower's blocks cut over model ranks.  A
world of one, or a plan of (1, 1, 1), takes the single-process code, bit
for bit.

Other TPU-side knobs of the config's ``TPU`` node are read and ignored, see
``IGNORED_TPU_KNOBS``.  ``TPU.FUSED_MLP`` is not read: on the card the fused
kernel is the MLP's route for every method whose MLP weights are frozen and
whose blocks need no bare MLP output (``UNFUSED_MLP_METHODS`` are the rest).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..core.clip import CLIPSpec, encode_image, patchify_images
from ..evaluation.metrics import MULTILABEL_DATASETS, get_metric
from ..peft.base import (
    PEFT_METHODS,
    PeftConfig,
    init_peft,
    make_hooks,
    peft_num_params,
    peft_trainable_filter,
)
from ..utils import dist as comm
from ..utils.device import compute_dtype, resolve_device, to_numpy
from .head import head_forward, init_bn_state, init_head
from .optim import build_wd_mask, clip_grad_norm, make_optimizer, step_decay_lr
from .partition import (
    alias,
    combine,
    count_params,
    named_parameters,
    partition,
    stack_trials,
)

# TPU-side knobs the port reads from the config and ignores, with their
# defaults.  FAST_LN and FAST_LN_SWEEP change numerics in the reference
# (LayerNorm statistics in the activation dtype, for the whole run or for
# the sweep's trials); the others change only how XLA schedules the same
# math (remat, unrolling, layouts, a concatenated delta GEMM, folding LN2's
# affine into c_fc) or pick a kernel the port always runs.  The mesh knobs
# (SWEEP_TRIALS_OVER_MESH, MESH_DATA, MESH_MODEL) are read by
# ``TrainTask._mesh_plan``.
IGNORED_TPU_KNOBS = {
    "FAST_LN": False,
    "FAST_LN_SWEEP": False,
    "FOLD_LN2": False,
    "SCAN_UNROLL": 0,
    "STEP_UNROLL": 1,
    "ATTN_LAYOUT": "auto",
    "KADAPT_CONCAT_DELTA": False,
    "REMAT": False,
    "USE_PALLAS_ATTENTION": False,
}


# the methods whose blocks take the unfused MLP: full_finetune trains the
# MLP weights, and the adapter and Compacter hook the bare MLP output, which
# the fused kernel never writes
UNFUSED_MLP_METHODS = ("full_finetune", "adapter", "compacter")
# the methods whose PEFT parameters enter through the attention's q/v delta
ATTENTION_DELTA_METHODS = ("kadaptation", "lora")


@dataclasses.dataclass(frozen=True)
class TaskStatic:
    """Static task configuration."""

    spec: CLIPSpec
    peft_cfg: PeftConfig
    num_classes: int
    batch_size: int = 64
    use_bn: bool = True
    normalize_feature: bool = False
    apply_logit_scale: bool = False
    trainable_logit_scale: bool = False
    multilabel: bool = False
    compute_dtype: str = "bfloat16"
    # the fused residual MLP (its backward gives dx only): every method
    # whose MLP weights are frozen and whose blocks need no bare MLP output,
    # i.e. all but full_finetune, the adapter and Compacter
    use_fused_mlp: bool = True
    optimizer: str = "sgd"
    momentum: float = 0.9
    nesterov: bool = False
    emulate_zero_shot: bool = False
    highest_precision: bool = False
    clip_grad_norm: float = 0.0
    two_lr: bool = False
    without_wd: tuple = ()  # TRAIN.WITHOUT_WD_LIST
    timm_filter: bool = False  # timm create_optimizer's filter_bias_and_bn
    merge_encoder_head_proj: bool = False
    feat_dim: int = 0  # 0 => spec.embed_dim (classifier-head input width)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)

    @property
    def head_dim(self) -> int:
        if self.feat_dim:
            return self.feat_dim
        if self.merge_encoder_head_proj:
            return self.spec.vision.width
        return self.spec.embed_dim

    @staticmethod
    def from_config(config, spec: CLIPSpec, peft_cfg: PeftConfig, feat_dim: int = 0) -> "TaskStatic":
        opt_name, opt_momentum, opt_nesterov, opt_timm_filter = _resolve_optimizer(config)
        for knob, default in IGNORED_TPU_KNOBS.items():
            if config.TPU.get(knob, default) != default:
                logging.info("TPU.%s=%r is a TPU-side knob; the port ignores it",
                             knob, config.TPU.get(knob))
        parity = config.TPU.PARITY_FP32
        return TaskStatic(
            spec=spec,
            peft_cfg=peft_cfg,
            num_classes=config.DATASET.NUM_CLASSES,
            batch_size=config.TRAIN.BATCH_SIZE_PER_GPU,
            use_bn=config.TRAIN.USE_CHANNEL_BN,
            normalize_feature=config.TRAIN.NORMALIZE_VISUAL_FEATURE,
            apply_logit_scale=peft_cfg.method in ("linear_probe", "full_finetune"),
            trainable_logit_scale=config.TRAIN.TRAINABLE_LOGIT_SCALE,
            multilabel=config.DATASET.DATASET in MULTILABEL_DATASETS,
            compute_dtype="float32" if (parity or config.MODEL.CLIP_FP32) else config.TPU.COMPUTE_DTYPE,
            use_fused_mlp=peft_cfg.method not in UNFUSED_MLP_METHODS,
            optimizer=opt_name,
            momentum=opt_momentum,
            nesterov=opt_nesterov,
            without_wd=tuple(config.TRAIN.WITHOUT_WD_LIST or ()),
            timm_filter=opt_timm_filter,
            emulate_zero_shot=config.TRAIN.EMULATE_ZERO_SHOT,
            highest_precision=parity,
            clip_grad_norm=config.TRAIN.CLIP_GRAD_NORM,
            two_lr=config.TRAIN.TWO_LR,
            merge_encoder_head_proj=config.TRAIN.MERGE_ENCODER_AND_HEAD_PROJ,
            feat_dim=feat_dim,
        )


def _resolve_optimizer(config) -> tuple:
    """(name, momentum, nesterov, timm_filter) from TRAIN.OPTIMIZER.

    TRAIN.OPTIMIZER='timm' reads TRAIN.OPTIMIZER_ARGS as timm's
    create_optimizer does: 'sgd'/'nesterov' enable Nesterov momentum,
    'momentum' is plain SGD, and filter_bias_and_bn defaults on."""
    name = str(config.TRAIN.OPTIMIZER).lower()
    if name != "timm":
        return name, config.TRAIN.MOMENTUM, config.TRAIN.NESTEROV, False
    args = {str(k).lower(): v for k, v in dict(config.TRAIN.OPTIMIZER_ARGS or {}).items()}
    opt = str(args.get("opt", "sgd")).lower()
    momentum = float(args.get("momentum", config.TRAIN.MOMENTUM))
    table = {
        "sgd": ("sgd", True),
        "nesterov": ("sgd", True),
        "momentum": ("sgd", False),
        "adam": ("adam", False),
        "adamw": ("adamw", False),
        "rmsprop": ("rmsprop", False),
        "rmsproptf": ("rmsprop", False),
    }
    if opt not in table:
        raise ValueError(f"Unsupported timm optimizer: {opt!r}")
    mapped, nesterov = table[opt]
    return mapped, momentum, nesterov, bool(args.get("filter_bias_and_bn", True))


def trainable_pred(static: TaskStatic):
    """Trainability of a parameter path (see partition.py): the head (its
    logit scale only with TRAIN.TRAINABLE_LOGIT_SCALE), the PEFT parameters
    the method's filter selects, and under full_finetune the whole backbone
    but a ``text`` subtree and ``logit_scale``: CLIP's visual tower
    (kadaptation_clip.py:104-116), a generic ViT whole, a DeCLIP model's
    visual tower and mapping heads."""
    method = static.peft_cfg.method
    peft_filter = peft_trainable_filter(static.peft_cfg)

    def pred(path: tuple) -> bool:
        top = path[0]
        if top == "head":
            if len(path) > 1 and path[1] == "logit_scale":
                return static.trainable_logit_scale
            return True
        if top == "peft":
            return method in PEFT_METHODS and peft_filter(path[1:])
        if top == "clip":
            return method == "full_finetune" and not (len(path) > 1
                                                      and path[1] in ("text", "logit_scale"))
        return False

    return pred


def trainable_params(trainable: dict) -> dict:
    """``{name: tensor}`` of the parameters in a partitioned tree that
    require a gradient (the trainable side of :func:`partition`)."""
    return {n: p for n, p in named_parameters(trainable).items() if p.requires_grad}


# ---------------------------------------------------------------------------
# Forward + loss
# ---------------------------------------------------------------------------

def model_forward(
    static: TaskStatic,
    bundle: dict,
    bn_state: dict,
    images_u8: torch.Tensor,
    preproc: dict,
    *,
    train: bool,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    forward_fn=None,
    trials: int = 0,
    shard=None,
):
    """uint8 images -> (logits float32, bn_state).

    ``images_u8`` is (B, H, W, 3) raw uint8, normalised on its device in the
    compute dtype (``x = u8 / 255``, then ``(x - mean) / std``), or
    (B, G*G, p*p*3) pre-patchified uint8 (:func:`patchify_images`), whose
    normalisation folds into the patch-embedding GEMM.  ``generator`` (on
    the images' device) draws KAdaptation's train-time dropout.

    ``forward_fn(backbone, x, train, generator, trials=0) -> feats``
    replaces the CLIP visual tower (an auxiliary backbone of
    ``models.factory``).  It gets the images normalised in the compute
    dtype, as the reference's does (``pevit_tpu/train/trainer.py:259-262``);
    the backbones then cast them to float32, so under a bfloat16 task they
    run in float32 on bfloat16-rounded images.

    ``trials`` > 0 runs a batch of T trials: the bundle's PEFT module and
    head hold every parameter stacked (T, ...), and its tower too where it
    trains (``full_finetune``), ``bn_state`` is (T, D), ``images_u8`` the
    trials' batches folded into one (T*B, ...), ``generator`` one generator
    per trial and ``mask`` (T, B); the tower runs once on the T*B images and
    the logits come back (T, B, K).

    ``shard`` (a ``parallel.mesh.RowShard``) marks ``images_u8`` as this
    rank's rows of a batch cut over a data axis: the attention delta reads
    the whole batch (quirk 4) and the head's BN takes the whole batch's
    statistics in training."""
    dt = static.dtype
    if forward_fn is not None:
        if images_u8.dim() != 4:
            raise ValueError("an auxiliary backbone takes (B, H, W, 3) images, got "
                             f"{tuple(images_u8.shape)}")
        x = images_u8.to(dt) / torch.tensor(255.0, dtype=dt, device=images_u8.device)
        x = (x - preproc["mean"].to(dt)) / preproc["std"].to(dt)
        feats = forward_fn(bundle["clip"], x, train, generator, trials=trials)
    else:
        feats = _encode_clip(static, bundle, images_u8, preproc, train, generator, trials, shard)
    feats = feats.float()
    if trials:
        feats = feats.view(trials, -1, feats.shape[-1])
    return head_forward(
        bundle["head"],
        bn_state,
        feats,
        train=train,
        mask=mask,
        use_bn=static.use_bn,
        normalize_feature=static.normalize_feature,
        apply_logit_scale=static.apply_logit_scale,
        reduce=shard.total if shard is not None and train else None,
    )


def _encode_clip(static: TaskStatic, bundle: dict, images_u8: torch.Tensor, preproc: dict,
                 train: bool, generator, trials: int, shard=None) -> torch.Tensor:
    """The CLIP visual tower's features of :func:`model_forward`'s images,
    with the PEFT hooks of the task's method (reading the whole batch under
    a ``shard``)."""
    dt = static.dtype
    hooks = make_hooks(static.peft_cfg, static.spec, train=train, trials=trials)
    if shard is not None and static.peft_cfg.reference_compat:
        hooks = shard.hooks(hooks, trials)
    kw = dict(spec=static.spec, peft=bundle.get("peft"), hooks=hooks,
              generator=generator,
              compute_dtype=dt, use_fused_mlp=static.use_fused_mlp,
              apply_proj=not static.merge_encoder_head_proj)
    if images_u8.dim() == 3:
        feats = encode_image(bundle["clip"], images_u8,
                             patch_fold=(preproc["mean"], preproc["std"]), **kw)
    elif images_u8.dim() == 4:
        x = images_u8.to(dt) / torch.tensor(255.0, dtype=dt, device=images_u8.device)
        x = (x - preproc["mean"].to(dt)) / preproc["std"].to(dt)
        feats = encode_image(bundle["clip"], x, **kw)
    else:
        raise ValueError(f"want (B, H, W, 3) or pre-patchified (B, G*G, p*p*3) uint8 images, "
                         f"got {tuple(images_u8.shape)}")
    return feats


def _loss(static: TaskStatic, logits, labels, mask, count=None):
    """Masked-mean CE (or BCE for multilabel): a scalar for (B, K) logits;
    for a batch of trials' (T, B, K), with labels and mask (T, B), each
    trial's own masked mean, (T,).  ``count`` replaces the mask's count as
    the denominator (a batch cut over a data axis: the whole batch's)."""
    if static.multilabel:
        per = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs()))).mean(-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        per = logz - logits.gather(-1, labels[..., None].long())[..., 0]
    if count is None:
        count = mask.sum(-1)
    return (per * mask).sum(-1) / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# Epoch / eval builders
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """What a training run carries from step to step.  ``params`` are the
    trainable tensors of the bundle (updated in place); ``generator`` is a
    CPU generator for epoch orders and per-step dropout seeds; ``loss`` is
    the last step's loss (a detached tensor, None before the first step).
    A batch of T trials holds the stacked (T, ...) parameters, optimiser and
    BN state, a list of T generators and (T,) losses."""

    params: dict
    opt: Any
    bn: dict
    generator: torch.Generator
    loss: Optional[torch.Tensor] = None


def build_step_fn(static: TaskStatic, preproc: dict, lr_scales=None, wd_mask=None,
                  forward_fn=None, trials: int = 0, mesh=None):
    """One training step on an explicit batch, the step of every epoch.

    Returns ``step(bundle, state, images, labels, lr, wd, generator) ->
    state``: the forward and loss of the batch in train mode (dropout from
    ``generator``, on the images' device), the gradients of
    ``state.params``, the optional gradient clip and the optimiser update,
    which changes the parameters in place.  It never waits on the card.

    With ``trials`` > 0 the step is a batch of T trials' (:func:`model_forward`):
    ``images`` (T*B, ...), ``labels`` (T, B), ``lr`` and ``wd`` (T,) tensors
    on the card, ``generator`` one per trial; the gradients are those of the
    sum of the trials' losses, so each trial's parameters get its own.

    On a ``mesh`` (``parallel.mesh.Mesh``) the step takes ``shard=`` (a
    ``RowShard``) where its batch is this rank's rows of a batch cut over
    the data axis: the loss divides by the whole batch's count and every
    gradient is summed over the data axis.  Under tensor parallelism (the
    bundle's tower cut over the model axis) the gradients of an attention
    delta's PEFT parameters (KAdaptation's, LoRA's), of which each model
    rank computed its heads' share, are summed over the model axis; the
    head's, and an MLP hook's, are whole on every rank."""
    _, opt_update = make_optimizer(static.optimizer, momentum=static.momentum,
                                   nesterov=static.nesterov, lr_scales=lr_scales,
                                   wd_mask=wd_mask)

    def step(bundle, state: TrainState, imgs, labs, lr, wd, generator,
             shard=None) -> TrainState:
        params = state.params
        names = list(params)
        valid = torch.ones(labs.shape[:2] if trials else imgs.shape[:1], device=imgs.device)
        count = None if shard is None else shard.total(valid.sum(-1))
        with torch.enable_grad():
            logits, new_bn = model_forward(static, bundle, state.bn, imgs, preproc,
                                           train=True, generator=generator, mask=valid,
                                           forward_fn=forward_fn, trials=trials, shard=shard)
            loss = _loss(static, logits, labs, valid, count)
            grads = torch.autograd.grad(loss.sum(), [params[n] for n in names],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        if mesh is not None:
            loss = _reduce_grads(grads, loss.detach(), shard, mesh, static)
        if static.clip_grad_norm > 0:
            grads = clip_grad_norm(grads, static.clip_grad_norm, trials)
        opt_state = opt_update(grads, params, state.opt, lr, wd)
        return TrainState(params, opt_state, {k: v.detach() for k, v in new_bn.items()},
                          state.generator, loss.detach())

    return step


def _reduce_grads(grads: dict, loss: torch.Tensor, shard, mesh,
                  static: TaskStatic) -> torch.Tensor:
    """A mesh step's gradients summed in place: all of them over the data
    axis where the batch was cut over it, an attention delta's PEFT ones
    over the model axis (a method with an attention delta runs on a frozen
    CLIP ViT tower, which a model axis always cuts:
    ``TrainTask._tensor_parallel``).  Returns the loss, the whole batch's."""
    from ..parallel.collectives import sum_tensors_

    if shard is not None:
        sum_tensors_(list(grads.values()) + [loss], shard.axis)
    if static.peft_cfg.method in ATTENTION_DELTA_METHODS:
        sum_tensors_([g for n, g in grads.items() if n.startswith("peft.")], mesh.model)
    return loss


def build_epoch_fn(static: TaskStatic, n_train: int, preproc: dict, lr_scales=None,
                   wd_mask=None, forward_fn=None, trials: int = 0, mesh=None,
                   shard_steps: bool = True):
    """One training epoch over a split on the card.

    Returns ``epoch(bundle, images, labels, state, lr, wd, order=None) ->
    state``: ``order`` (the epoch's permutation of the train split) is drawn
    from ``state.generator`` unless given.  ``lr_scales`` (TRAIN.TWO_LR) and
    ``wd_mask`` are per-parameter dicts; ``forward_fn`` as in
    :func:`model_forward`.

    With ``trials`` > 0 the epoch is a batch of T trials' (:func:`build_step_fn`):
    each trial draws its order, then its dropout seed, from its own
    generator; a given ``order`` is one permutation for every trial or
    (T, n_train), one each; step i gathers each trial's batch i into one
    (T*B, ...) batch.

    On a ``mesh`` with a data axis (and ``shard_steps``) each full step is cut
    over it, every rank taking its rows of each trial's batch; the natural
    tail runs whole on every rank, as the reference's replicated tail."""
    from ..parallel.mesh import row_shard

    B = static.batch_size
    step = build_step_fn(static, preproc, lr_scales, wd_mask, forward_fn, trials, mesh)
    shard = row_shard(mesh, B) if shard_steps else None

    def epoch(bundle, images, labels, state: TrainState, lr, wd, order=None) -> TrainState:
        gens = list(state.generator) if trials else [state.generator]
        if order is None:
            order = [torch.randperm(n_train, generator=g) for g in gens]
        drop_seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=g)) for g in gens]
        order = torch.as_tensor(np.array(order), dtype=torch.long).to(images.device)
        order = order.expand(len(gens), n_train)

        def run_step(cols, step_i, part=None):
            nonlocal state
            step_gens = [torch.Generator(device=images.device).manual_seed(s + step_i)
                         for s in drop_seeds]
            idx = order[:, cols]
            if part is not None:
                idx = idx[:, part.lo:part.hi]
            idx = idx.reshape(-1)
            imgs, labs = images.index_select(0, idx), labels.index_select(0, idx)
            if trials:
                labs = labs.view(trials, -1, *labels.shape[1:])
            state = step(bundle, state, imgs, labs, lr, wd, step_gens if trials else step_gens[0],
                         **({} if part is None else {"shard": part}))

        steps_full = n_train // B
        for i in range(steps_full):
            run_step(slice(i * B, (i + 1) * B), i, shard)
        if n_train - steps_full * B > 1:  # a size-1 tail is skipped
            run_step(slice(steps_full * B, n_train), steps_full)
        return state

    return epoch


def build_eval_fn(static: TaskStatic, preproc: dict, forward_fn=None, trials: int = 0,
                  mesh=None, eval_chunk: int = 0):
    """``eval_chunk(bundle, bn_state, imgs) -> float32 logits`` in eval
    mode, without autograd.  With ``trials`` > 0 every trial evaluates the
    same chunk: it is repeated T times on its device (one copy), the tower
    runs once on them all, and the logits come back (T, chunk, K).

    On a ``mesh`` with a data axis a full chunk of ``eval_chunk`` images is
    cut over it and every rank's logits gathered; a shorter chunk (the
    natural remainder) runs whole on every rank, as the reference's."""
    from ..parallel.mesh import row_shard

    def eval_chunk_fn(bundle, bn_state, imgs):
        shard = row_shard(mesh, len(imgs)) if len(imgs) == eval_chunk else None
        if shard is not None:
            imgs = shard.take(imgs)
        with torch.no_grad():
            if trials:
                imgs = imgs.unsqueeze(0).expand(trials, *imgs.shape).reshape(-1, *imgs.shape[1:])
            logits, _ = model_forward(static, bundle, bn_state, imgs, preproc, train=False,
                                      forward_fn=forward_fn, trials=trials, shard=shard)
            if shard is not None:
                rest = logits.shape[-2:]
                logits = shard.gather(logits.reshape(-1, rest[-1]), max(trials, 1))
                logits = logits.view(*((trials,) if trials else ()), -1, rest[-1])
        return logits.float()

    return eval_chunk_fn


def build_fit_eval_fn(static: TaskStatic, n_train: int, n_epochs: int, preproc: dict, *,
                      eval_chunk: int, n_val: int, lr_scales=None, wd_mask=None,
                      forward_fn=None, trials: int = 0, mesh=None, shard_steps: bool = True):
    """Train ``n_epochs`` and evaluate after every epoch.

    Returns ``fit_eval(bundle, images, labels, val_images, state, lr_table,
    wd, orders=None) -> (state, logits)`` with ``logits`` (n_epochs, n_val,
    K) float32; ``orders[e]`` injects epoch e's order.  Eval runs in full
    chunks of ``eval_chunk`` and a natural-size remainder, never padded: the
    scramble makes a chunk's composition part of its logits.

    With ``trials`` > 0 it is a batch of T trials' (:func:`build_epoch_fn`):
    ``lr_table`` is (T, n_epochs) and ``wd`` (T,), copied to the images'
    device once, and ``logits`` come back (T, n_epochs, n_val, K).

    ``mesh`` cuts full steps and full eval chunks over its data axis
    (:func:`build_epoch_fn`, :func:`build_eval_fn`); every rank gets every
    logit."""
    epoch = build_epoch_fn(static, n_train, preproc, lr_scales, wd_mask, forward_fn, trials,
                           mesh, shard_steps)
    one_chunk = build_eval_fn(static, preproc, forward_fn, trials, mesh, eval_chunk)

    def fit_eval(bundle, images, labels, val_images, state, lr_table, wd, orders=None):
        lrs = lr_table
        if trials:  # (n_epochs, T) and (T,) on the card
            lrs = torch.tensor(np.asarray(lr_table, np.float64).T, dtype=torch.float32,
                               device=images.device)
            wd = torch.tensor(wd, dtype=torch.float32, device=images.device)
        logits = []
        for e in range(n_epochs):
            if not static.emulate_zero_shot:
                state = epoch(bundle, images, labels, state, lrs[e], wd,
                              None if orders is None else orders[e])
            logits.append(torch.cat([one_chunk(bundle, state.bn, val_images[s:s + eval_chunk])
                                     for s in range(0, n_val, eval_chunk)], dim=-2))
        return state, torch.stack(logits, dim=-3)

    return fit_eval


# ---------------------------------------------------------------------------
# Host-side orchestration
# ---------------------------------------------------------------------------

def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(z)
    return probs / probs.sum(axis=-1, keepdims=True)


class TrainTask:
    """Owns the frozen CLIP tower (or an auxiliary backbone) on the card and
    runs trainings of one task: a chunk of trials as one batched computation
    (:meth:`train_trials`), or one trial after another
    (:meth:`_train_trials_serial`).

    ``backbone`` (a ``models.factory.Backbone``) replaces the CLIP: its
    module is the bundle's ``clip`` and its forward the visual tower, on
    the task's MLP route (the fused kernel unless the method trains the
    MLP weights); ``clip`` is then ignored."""

    def __init__(self, config, static: TaskStatic, clip, *,
                 text_init_weights: Optional[np.ndarray] = None,
                 eval_chunk: Optional[int] = None, device=None, backbone=None):
        self.device = resolve_device(device)
        self.backbone = backbone
        self._forward_fn = None
        if backbone is not None:
            clip = backbone.params
            fused = static.use_fused_mlp
            if backbone.forward_features_train is not None:
                # train-time randomness (Swin's stochastic depth) draws from
                # the step's generator, one per trial of a batch (reference
                # trainer.py:546-549)
                self._forward_fn = lambda p, x, train, generator=None, trials=0: (
                    backbone.forward_features_train(p, x, generator, trials=trials) if train
                    else backbone.forward_features(p, x, use_fused_mlp=fused, trials=trials))
            else:
                self._forward_fn = lambda p, x, train, generator=None, trials=0: (
                    backbone.forward_features(p, x, use_fused_mlp=fused, trials=trials))
        self.config = config
        self.static = static
        if eval_chunk is None:
            # the scramble makes logits depend on the chunk's composition, so
            # the chunk is the reference's val/test batch of 64
            eval_chunk = 64 if static.peft_cfg.method in ("lora", "kadaptation") else 512
        self.eval_chunk = eval_chunk
        self.clip = clip.to(self.device)
        self.text_init_weights = text_init_weights
        self.metric = get_metric(config.TEST.METRIC or "accuracy")
        self.metric_name = getattr(self.metric, "__name__", "accuracy")
        self._opt_init, _ = make_optimizer(static.optimizer, momentum=static.momentum,
                                           nesterov=static.nesterov)
        self.preproc = {k: torch.tensor(np.asarray(v, np.float32), device=self.device)
                        for k, v in (("mean", config.INPUT.MEAN), ("std", config.INPUT.STD))}
        self._tp_towers = {}  # a model rank's tower a mesh shape (``_tp_tower``)

    # -- input path ---------------------------------------------------------

    @property
    def use_prepack(self) -> bool:
        """The pre-patchified uint8 path, except under TPU.PARITY_FP32, which
        keeps the reference's normalise-then-patchify order, and for
        auxiliary backbones and RN towers, which take (B, H, W, 3) images."""
        return (self._forward_fn is None and not self.static.highest_precision
                and self.static.spec.vision_rn is None)

    def prepack(self, images) -> torch.Tensor:
        """Images to the card as uint8, pre-patchified when the fast path
        applies.  Already-packed (N, G*G, p*p*3) tensors pass through."""
        x = torch.as_tensor(images).to(self.device)
        p = self.static.spec.vision.patch_size
        if not self.use_prepack or x.dim() != 4 or x.shape[1] % p or x.shape[2] % p:
            return x
        return patchify_images(x, p).contiguous()

    # -- bundle ------------------------------------------------------------

    def init_bundle(self, generator: torch.Generator, tower=None) -> tuple:
        """(trainable, frozen, bn_state) for one trial; the PEFT parameters
        and then the head are drawn from ``generator`` (a CPU generator).
        ``tower`` is the backbone the bundle holds in place of the trial's
        own (:meth:`_trial_clip`): a batch of trials gives each trial an
        alias of the pretrained tower, which ``stack_trials`` stacks."""
        bundle = self._fresh_bundle(generator, self._trial_clip() if tower is None else tower)
        trainable, frozen = partition(bundle, trainable_pred(self.static))
        return trainable, frozen, init_bn_state(self.static.head_dim, device=self.device)

    def _fresh_bundle(self, generator: torch.Generator, tower) -> dict:
        """``{"clip": tower, "peft": ..., "head": ...}``, the PEFT parameters
        and then the head drawn from ``generator``, not yet partitioned."""
        st = self.static
        peft = (init_peft(generator, st.peft_cfg, st.spec, device=self.device)
                if self.backbone is None else None)
        scale = getattr(self.clip, "logit_scale", None)
        backbone_ls = math.log(1 / 0.07) if scale is None else scale.item()
        text_weights = self.text_init_weights
        if text_weights is not None and st.merge_encoder_head_proj:
            # the visual projection folds into the head: (width, K) = proj @ (E, K)
            proj = self.clip.visual.proj.detach().float().cpu().numpy()
            text_weights = proj @ np.asarray(text_weights, np.float32)
        head = init_head(generator, st.head_dim, st.num_classes,
                         text_init_weights=text_weights,
                         logit_scale_init=self.config.TRAIN.LOGIT_SCALE_INIT,
                         backbone_logit_scale=backbone_ls, device=self.device)
        return {"clip": tower, "peft": peft, "head": head}

    def _trial_clip(self):
        """The backbone a trial's bundle holds: the task's own, except under
        full_finetune, where the optimiser updates it in place, so each trial
        trains a copy (sharing the frozen text tower and logit scale, where
        the backbone has them) and every trial starts from the pretrained
        weights, as the reference's trials start from its immutable
        parameters."""
        if self.static.peft_cfg.method != "full_finetune":
            return self.clip
        return copy.deepcopy(self.clip, {id(m): m for m in self._shared_parts()})

    def _shared_parts(self) -> list:
        """The parts of the backbone that every trial shares under
        full_finetune: its text tower and logit scale, where it has them."""
        return [getattr(self.clip, n) for n in ("text", "logit_scale") if hasattr(self.clip, n)]

    def max_parallel_trials(self) -> int:
        """The sweep's trial chunk: TPU.SWEEP_PARALLEL_TRIALS a card, the
        trials that ``train_trials`` trains as one batch on each, times the
        world's cards when trials are laid over the mesh
        (TPU.SWEEP_TRIALS_OVER_MESH; reference trainer.py:794-801)."""
        per_dev = max(1, self.config.TPU.SWEEP_PARALLEL_TRIALS)
        if not bool(self.config.TPU.get("SWEEP_TRIALS_OVER_MESH", True)):
            return per_dev
        return per_dev * comm.world_size()

    def _mesh_plan(self, n_trials: int):
        """(mesh, n_trial, n_data): the mesh of the world's ranks for a call
        of ``n_trials`` trials, as the reference plans its devices
        (``pevit_tpu/train/trainer.py:745-792``).  Trials claim ranks first
        (each trains its share, no collective); a single trial (the final
        run) cuts its batch over a "data" axis instead (TPU.MESH_DATA: -1
        auto, 0/1 off, >1 a cap; at least two images a rank);
        TPU.MESH_MODEL > 1 adds a "model" axis of tensor parallelism on a
        CLIP tower.  ``(None, 1, 1)`` when every axis collapses, and then
        the call takes the single-process code."""
        D = comm.world_size()
        if D <= 1:
            return None, 1, 1
        tpu = self.config.TPU
        n_m = max(1, int(tpu.get("MESH_MODEL", 1)))
        if n_m > 1 and (self.backbone is not None or D // n_m < 1):
            n_m = 1
        D_td = D // n_m
        n_t = 1
        if bool(tpu.get("SWEEP_TRIALS_OVER_MESH", True)) and n_trials > 1:
            n_t = min(D_td, n_trials)
            while n_t > 1 and n_trials % n_t:
                n_t -= 1
        md = int(tpu.get("MESH_DATA", -1))
        if 0 <= md <= 1:
            n_d = 1
        elif n_trials == 1 or md > 1:
            n_d = D_td // n_t if md < 0 else min(D_td // n_t, md)
        else:
            n_d = 1
        n_d = min(n_d, max(1, self.static.batch_size // 2))
        if n_t == 1 and n_d == 1 and n_m == 1:
            return None, 1, 1
        from ..parallel.mesh import make_mesh

        return make_mesh(n_data=n_d, n_model=n_m, n_trial=n_t), n_t, n_d

    def _tensor_parallel(self, mesh) -> bool:
        """Whether the mesh's model axis cuts the tower: a frozen CLIP ViT
        tower only (the reference shards the frozen CLIP tree; under
        full_finetune the tower trains, and it stays whole on every rank)."""
        return (mesh.model.size > 1 and self.backbone is None and not self._trains_tower
                and self.static.spec.vision_rn is None)

    def _tp_tower(self, mesh):
        """The task's tower as this model rank holds it
        (``parallel.mesh.shard_params``), built once a mesh."""
        if mesh.shape not in self._tp_towers:
            from ..parallel.mesh import shard_params

            self._tp_towers[mesh.shape] = shard_params(self.clip, mesh,
                                                       self.static.spec.vision.heads)
        return self._tp_towers[mesh.shape]

    @property
    def _row_local_train(self) -> bool:
        """Whether a train-mode forward reads each row alone but for the
        attention delta (which :class:`RowShard` gathers): not a backbone
        that draws train-time randomness a row (Swin's drop path), whose
        draws depend on the whole batch; its data axis runs whole batches."""
        return self.backbone is None or self.backbone.forward_features_train is None

    @property
    def batches_trials(self) -> bool:
        """Whether ``train_trials`` trains a chunk's trials as one batched
        computation: for every method and backbone (a trained tower is
        stacked over the trials, a frozen one shared)."""
        return True

    @property
    def _trains_tower(self) -> bool:
        return self.static.peft_cfg.method == "full_finetune"

    def model_info(self, trainable) -> dict:
        """Parameter counts, as the reference's (kadaptation_clip.py:284-289):
        the backbone is the whole CLIP (both towers and its logit scale), or
        the whole auxiliary backbone, whose visual part is its ``visual``
        subtree where it has one."""
        st = self.static
        clip_n = count_params(self.clip)
        peft_n = peft_num_params(st.peft_cfg, st.spec) if self.backbone is None else 0
        head_n = st.head_dim * st.num_classes + st.num_classes
        return {
            "n_trainable_params": count_params(trainable_params(trainable)),
            "n_visual_params": count_params(getattr(self.clip, "visual", self.clip)) + peft_n,
            "n_backbone_params": clip_n + peft_n,
            "n_params": clip_n + peft_n + head_n + 1,  # +1 classifier logit_scale
        }

    def _trainable_names(self) -> dict:
        """``{name: tensor}`` of a lone trial's trainable parameters, at their
        lone shapes: the task's own tower (not a trial's copy of it) beside a
        fresh PEFT module and head, nothing partitioned."""
        pred = trainable_pred(self.static)
        bundle = self._fresh_bundle(torch.Generator().manual_seed(0), self.clip)
        return {n: p for n, p in named_parameters(bundle).items() if pred(tuple(n.split(".")))}

    def _lr_scales(self):
        """TRAIN.TWO_LR per-parameter multipliers: backbone-side (clip, peft)
        at 0.1, the head at 1."""
        if not self.static.two_lr:
            return None
        return {n: 0.1 if n.split(".")[0] in ("clip", "peft") else 1.0
                for n in self._trainable_names()}

    def _wd_mask(self):
        """TRAIN.WITHOUT_WD_LIST / timm filter_bias_and_bn per-parameter
        weight-decay multipliers."""
        if not self.static.without_wd and not self.static.timm_filter:
            return None
        mask = build_wd_mask(self._trainable_names(), self.static.without_wd,
                             timm_filter=self.static.timm_filter)
        if mask is not None and self.config.VERBOSE:
            for n, m in mask.items():
                if not m:
                    logging.info("no weight decay: %s", n)
        return mask

    def _fit_eval_fn(self, n_train: int, n_epochs: int, n_val: int, trials: int = 0,
                     mesh=None):
        """:func:`build_fit_eval_fn` for one trial, or for a batch of
        ``trials``, on ``mesh`` where given."""
        return build_fit_eval_fn(self.static, n_train, n_epochs, self.preproc,
                                 eval_chunk=self.eval_chunk, n_val=n_val,
                                 lr_scales=self._lr_scales(), wd_mask=self._wd_mask(),
                                 forward_fn=self._forward_fn, trials=trials, mesh=mesh,
                                 shard_steps=self._row_local_train)

    def _labels(self, labels) -> torch.Tensor:
        dt = torch.float32 if self.static.multilabel else torch.long
        return torch.as_tensor(labels).to(self.device, dt)

    def _score(self, labels_np: np.ndarray, probs: np.ndarray) -> float:
        try:
            score = 100.0 * self.metric(labels_np, probs)
        except Exception:  # noqa: BLE001 - the reference scores any metric error 0
            return 0.0
        return float(score) if np.isfinite(score) else 0.0

    # -- evaluation -------------------------------------------------------------

    def evaluate(self, trainable, frozen, bn_state, images_u8, labels) -> tuple:
        """One trial over a whole split in natural-size chunks; returns
        (score, probs)."""
        bundle = combine(trainable, frozen)
        one_chunk = build_eval_fn(self.static, self.preproc, self._forward_fn)
        n = len(labels)
        logits = torch.cat([one_chunk(bundle, bn_state, self.prepack(images_u8[s:s + self.eval_chunk]))
                            for s in range(0, n, self.eval_chunk)])
        probs = _softmax(logits.cpu().numpy())
        return self._score(to_numpy(labels), probs), probs

    def _evaluate_trials(self, bundle, bn_state, images_u8, labels, trials: int,
                         mesh=None) -> list:
        """A batch of trials (the stacked ``bundle`` and (T, D) ``bn_state``)
        over a whole split in natural-size chunks, every trial on each chunk
        in one forward (full chunks cut over ``mesh``'s data axis); returns
        each trial's (score, probs)."""
        one_chunk = build_eval_fn(self.static, self.preproc, self._forward_fn, trials=trials,
                                  mesh=mesh, eval_chunk=self.eval_chunk)
        n = len(labels)
        logits = torch.cat([one_chunk(bundle, bn_state, self.prepack(images_u8[s:s + self.eval_chunk]))
                            for s in range(0, n, self.eval_chunk)], dim=1).cpu().numpy()
        labels_np = to_numpy(labels)
        return [(self._score(labels_np, probs), probs) for probs in map(_softmax, logits)]

    # -- training ------------------------------------------------------------

    def train_trials(self, hparams: list, train_images, train_labels, val_images, val_labels, *,
                     end_epoch: int, begin_epoch: int = 0, seed: int = 0,
                     keep_logits: bool = False, log_every: int = 0) -> list:
        """Train one trial per ``(lr, wd)`` in ``hparams``, evaluating after
        every epoch: as one batched computation, the reference's vmapped
        trials, for every method and backbone.

        Trial t's PEFT parameters and head come from a CPU generator seeded
        ``seed * 1_000_003 + 2 t``, its epoch orders and dropout seeds from
        one seeded ``+ 1``, on either path.  Returns per-trial dicts
        {"best_score", "last_score", "best_logits"}; ``last_trainable``,
        ``last_bundle`` and ``last_state`` then hold the last trial's
        trainable partition, trained bundle and state (on the batched path
        views of its slice of the stacks).  A numpy ``train_images`` above
        ``TPU.MAX_DEVICE_DATA_GB`` is streamed from host memory
        (:meth:`_train_trials_streaming`).

        In a world of several ranks the call lays its trials and batches
        over the mesh :meth:`_mesh_plan` gives (:meth:`_train_trials_mesh`);
        every rank returns every trial's result."""
        kw = dict(end_epoch=end_epoch, begin_epoch=begin_epoch, seed=seed,
                  keep_logits=keep_logits, log_every=log_every)
        T = len(hparams)
        results = [{"best_score": 0.0, "last_score": 0.0, "best_logits": None} for _ in hparams]
        if end_epoch - begin_epoch <= 0:
            self._keep_untrained(seed, T)
            return results
        mesh, _, _ = self._mesh_plan(T)
        if mesh is not None:
            return self._train_trials_mesh(mesh, hparams, train_images, train_labels, val_images,
                                           val_labels, results=results, **kw)
        batch = self._init_trials(seed, T)
        self._train_batch(batch, hparams, train_images, train_labels, val_images, val_labels,
                          results=results, **kw)
        return results

    def _train_batch(self, batch: "TrialBatch", hparams: list, train_images, train_labels,
                     val_images, val_labels, *, results: list, end_epoch: int, begin_epoch: int,
                     seed: int, keep_logits: bool, log_every: int, first: int = 0,
                     mesh=None) -> None:
        """Train ``batch`` (trials ``first`` .. ``first + T - 1`` of the
        call), evaluating after every epoch, into ``results``; on ``mesh``
        its full steps and eval chunks cut over the data axis."""
        kw = dict(end_epoch=end_epoch, begin_epoch=begin_epoch, seed=seed,
                  keep_logits=keep_logits, log_every=log_every)
        T = len(hparams)
        n_train, n_val = len(train_labels), len(val_labels)
        n_epochs = end_epoch - begin_epoch
        if self._streams(train_images):
            self._train_trials_streaming(hparams, train_images, train_labels, val_images,
                                         val_labels, results=results, batch=batch, mesh=mesh,
                                         **kw)
            return
        images, labels = self.prepack(train_images), self._labels(train_labels)
        val = self.prepack(val_images)
        labels_np = to_numpy(val_labels)
        schedule = list(self.config.TRAIN.SCHEDULE or [])
        lr_table = [[step_decay_lr(float(lr), e, schedule) for e in range(begin_epoch, end_epoch)]
                    for lr, _ in hparams]
        # a mesh by keyword only: the single-process call is the one it was
        fit_eval = self._fit_eval_fn(n_train, n_epochs, n_val, T,
                                     **({} if mesh is None else {"mesh": mesh}))
        t0 = time.perf_counter()
        state, logits = fit_eval(batch.bundle, images, labels, val, batch.state, lr_table,
                                 [float(wd) for _, wd in hparams])
        logits_np = logits.cpu().numpy()  # (T, E, n_val, K)
        run_s = time.perf_counter() - t0
        for t, res in enumerate(results):
            self._score_epochs(first + t, res, logits_np[t], labels_np, begin_epoch, keep_logits,
                               log_every)
        if log_every:
            logging.info("=> %d trials x %d epochs in %.2fs | best: %s", T, n_epochs, run_s,
                         " ".join(f"{r['best_score']:.3f}" for r in results))
        self._keep_last(batch, state)

    def _train_trials_mesh(self, mesh, hparams: list, train_images, train_labels, val_images,
                           val_labels, *, results: list, seed: int, **kw) -> list:
        """:meth:`train_trials` on a mesh of the world's ranks.

        Trial rank i trains trials ``i * T / n_t`` .. of the call, drawn by
        their global index (a trial gives the same result on any rank); its
        data ranks cut each full batch, its model ranks the tower
        (:meth:`_tensor_parallel`).  Then every rank sends its outcome and
        one rank of each trial part its results, so that every rank returns
        every result and takes the same decisions after.  A failure on any
        rank raises on every rank, as the same kind: running out of card
        memory (``torch.cuda.OutOfMemoryError``, which the sweep halves),
        another device error (``sweep.RankDeviceError``), or anything else.
        ``last_*`` then hold trial T-1's, broadcast from its trial rank."""
        T, n_t = len(hparams), mesh.shape[0]
        per = T // n_t
        first = mesh.trial.index * per
        local, failure = None, None
        try:
            if mesh.member:
                batch = self._init_trials(seed, per, first)
                if self._tensor_parallel(mesh):
                    batch = batch._replace(bundle={**batch.bundle, "clip": self._tp_tower(mesh)})
                local = results[first:first + per]
                self._train_batch(batch, hparams[first:first + per], train_images, train_labels,
                                  val_images, val_labels, results=local, seed=seed, first=first,
                                  mesh=mesh, **kw)
        except Exception as e:  # noqa: BLE001 - every rank must hear of it
            failure = e
        sends = mesh.member and mesh.data.index == 0 and mesh.model.index == 0
        from .sweep import failure_kind

        outcomes = comm.all_gather_object(
            (failure_kind(failure), None if failure is None else f"{type(failure).__name__}: "
             f"{failure}", first if sends and failure is None else None, local if sends else None))
        for r, (kind, msg, _, _) in enumerate(outcomes):
            if kind is not None:
                if failure is not None:
                    raise failure
                raise _rank_failure(kind, r, msg)
        for _, _, at, res in outcomes:
            if at is not None:
                results[at:at + len(res)] = res
        if n_t > 1 or math.prod(mesh.shape) < comm.world_size():  # a rank lacks trial T-1
            self._share_last(mesh, seed, T)
        return results

    def _share_last(self, mesh, seed: int, n_trials: int) -> None:
        """``last_trainable``, ``last_bundle`` and ``last_state`` of trial
        T-1 on every rank: broadcast from the first rank of its trial part;
        a rank that did not train it draws its bundle and copies the trained
        values in."""
        import torch.distributed as dist

        owner = mesh.rank_of(mesh.shape[0] - 1, 0, 0)
        payload = [None]
        if comm.rank() == owner:
            st = self.last_state
            payload = [{"params": {n: p.detach().cpu() for n, p in st.params.items()},
                        "opt": _tensor_leaves(st.opt), "bn": {k: v.cpu() for k, v in st.bn.items()},
                        "generator": st.generator.get_state(),
                        "loss": None if st.loss is None else st.loss.cpu()}]
        dist.broadcast_object_list(payload, src=owner)
        if mesh.member and mesh.trial.index == mesh.shape[0] - 1:
            return
        got = payload[0]
        batch = self._init_trials(seed, 1, n_trials - 1)
        self._keep_last(batch, batch.state)
        st = self.last_state
        with torch.no_grad():
            for n, p in st.params.items():
                p.copy_(got["params"][n])
            for dst, src in zip(_tensor_leaves(st.opt), got["opt"]):
                dst.copy_(src)
            for k, v in st.bn.items():
                v.copy_(got["bn"][k])
        st.generator.set_state(got["generator"])
        loss = None if got["loss"] is None else got["loss"].to(self.device)
        self.last_state = st._replace(loss=loss)

    def _train_trials_serial(self, hparams: list, train_images, train_labels, val_images,
                             val_labels, *, end_epoch: int, begin_epoch: int = 0, seed: int = 0,
                             keep_logits: bool = False, log_every: int = 0) -> list:
        """:meth:`train_trials` one trial after another, each through the
        single-trial :func:`build_fit_eval_fn`: the yardstick the batched
        path is held to."""
        n_train = len(train_labels)
        n_val = len(val_labels)
        n_epochs = end_epoch - begin_epoch
        results = [{"best_score": 0.0, "last_score": 0.0, "best_logits": None} for _ in hparams]
        if n_epochs <= 0:
            self._keep_untrained(seed, len(hparams))
            return results
        if self._streams(train_images):
            return self._train_trials_streaming(
                hparams, train_images, train_labels, val_images, val_labels, results=results,
                begin_epoch=begin_epoch, end_epoch=end_epoch, seed=seed,
                keep_logits=keep_logits, log_every=log_every)
        images, labels = self.prepack(train_images), self._labels(train_labels)
        val = self.prepack(val_images)
        labels_np = to_numpy(val_labels)
        schedule = list(self.config.TRAIN.SCHEDULE or [])
        fit_eval = self._fit_eval_fn(n_train, n_epochs, n_val)
        for t, (lr, wd) in enumerate(hparams):
            trainable, frozen, state = self._init_trial(seed, t)
            lr_table = [step_decay_lr(float(lr), e, schedule) for e in range(begin_epoch, end_epoch)]
            t0 = time.perf_counter()
            state, logits = fit_eval(combine(trainable, frozen), images, labels, val, state,
                                     lr_table, float(wd))
            logits_np = logits.cpu().numpy()
            run_s = time.perf_counter() - t0
            res = results[t]
            self._score_epochs(t, res, logits_np, labels_np, begin_epoch, keep_logits, log_every)
            if log_every:
                logging.info("=> trial %d: %d epochs in %.2fs | best %.3f", t, n_epochs, run_s,
                             res["best_score"])
            self.last_trainable = trainable
            self.last_bundle, self.last_state = combine(trainable, frozen), state
        return results

    def _score_epochs(self, t: int, res: dict, logits: np.ndarray, labels_np: np.ndarray,
                      begin_epoch: int, keep_logits: bool, log_every: int) -> None:
        """Trial t's (epochs, n_val, K) val logits into its result, epoch by
        epoch."""
        n_epochs = len(logits)
        for e in range(n_epochs):
            probs = _softmax(logits[e])
            _update_result(res, self._score(labels_np, probs), probs, e == 0, keep_logits)
            if log_every and (e % log_every == 0 or e == n_epochs - 1):
                logging.info("[Trial %d epoch %d] Val %s: %.3f", t, begin_epoch + e,
                             self.metric_name, res["last_score"])

    def _streams(self, train_images) -> bool:
        """A numpy train split too big for the card streams from host
        memory (reference trainer.py:1010-1016); a tensor never streams."""
        max_bytes = float(self.config.TPU.MAX_DEVICE_DATA_GB) * 1e9
        return isinstance(train_images, np.ndarray) and train_images.nbytes > max_bytes

    def _keep_untrained(self, seed: int, n_trials: int) -> None:
        """``last_trainable`` and ``last_bundle`` of a call that trains no
        epoch: the last trial's freshly drawn bundle."""
        trainable, frozen, _ = self.init_bundle(
            torch.Generator().manual_seed(seed * 1_000_003 + 2 * (n_trials - 1)))
        self.last_trainable, self.last_bundle = trainable, combine(trainable, frozen)

    def _init_trial(self, seed: int, t: int) -> tuple:
        """Trial t's (trainable, frozen, state): the PEFT parameters and head
        from a CPU generator seeded ``seed * 1_000_003 + 2 t``, the epoch
        orders and dropout seeds from one seeded ``+ 1``."""
        base = seed * 1_000_003 + 2 * t
        trainable, frozen, bn = self.init_bundle(torch.Generator().manual_seed(base))
        params = trainable_params(trainable)
        return trainable, frozen, TrainState(params, self._opt_init(params), bn,
                                             torch.Generator().manual_seed(base + 1))

    def _init_trials(self, seed: int, n_trials: int, first: int = 0) -> "TrialBatch":
        """Trials ``first`` .. ``first + T - 1`` as one batch: each drawn by
        :meth:`init_bundle` from the generators :meth:`_init_trial` seeds
        for its index, then stacked
        (``partition.stack_trials``; each trial's modules become views of its
        slice), with a (T, D) BN state, the optimiser state of the stacked
        parameters and the trials' T generators.  Under full_finetune each
        trial's bundle holds an alias of the pretrained tower (no copy), so
        the stack is the only copy of it the batch makes."""
        trees, bundles, bns, gens = [], [], [], []
        for t in range(first, first + n_trials):
            base = seed * 1_000_003 + 2 * t
            tower = (alias(self.clip, self._shared_parts()),) if self._trains_tower else ()
            trainable, frozen, bn = self.init_bundle(torch.Generator().manual_seed(base), *tower)
            trees.append((trainable, frozen))
            bundles.append(combine(trainable, frozen))
            bns.append(bn)
            gens.append(torch.Generator().manual_seed(base + 1))
        bundle = stack_trials(bundles)
        params = trainable_params(partition(bundle, trainable_pred(self.static))[0])
        bn = {k: torch.stack([b[k] for b in bns]) for k in bns[0]}
        return TrialBatch(trees, bundle, TrainState(params, self._opt_init(params), bn, gens))

    def _keep_last(self, batch: "TrialBatch", state: TrainState) -> None:
        """``last_trainable``, ``last_bundle`` and ``last_state``: the batch's
        last trial, as views of its slice of the stacks."""
        t = len(batch.trees) - 1
        trainable, frozen = batch.trees[t]
        self.last_trainable = trainable
        self.last_bundle = combine(trainable, frozen)
        self.last_state = TrainState(trainable_params(trainable), _trial_slice(state.opt, t),
                                     _trial_slice(state.bn, t), state.generator[t],
                                     None if state.loss is None else state.loss[t])

    def _train_trials_streaming(self, hparams, train_images: np.ndarray, train_labels,
                                val_images, val_labels, *, results: list, begin_epoch: int,
                                end_epoch: int, seed: int, keep_logits: bool, log_every: int,
                                batch: Optional["TrialBatch"] = None, mesh=None) -> list:
        """``train_trials`` over a host-resident train split (``streaming.py``):
        the ``batch`` of trials takes one batched step on each streamed batch
        and is evaluated in one forward per val chunk after every epoch;
        without a batch (the serial path) every trial steps on each batch in
        turn and is evaluated through :meth:`evaluate`.  On ``mesh`` each
        data rank gathers and copies only its rows of each full batch."""
        from .streaming import StreamingEpochRunner

        T = len(hparams)
        runner = StreamingEpochRunner(self, lr_scales=self._lr_scales(), wd_mask=self._wd_mask(),
                                      trials=0 if batch is None else T, mesh=mesh,
                                      shard_steps=self._row_local_train)
        if batch is None:
            trials = [self._init_trial(seed, t) for t in range(T)]
            runs = [(combine(trainable, frozen), state) for trainable, frozen, state in trials]
        else:
            runs = [(batch.bundle, batch.state)]
        train_labels = to_numpy(train_labels)
        if isinstance(val_images, torch.Tensor):
            val_images = self.prepack(val_images)
        labels_np = to_numpy(val_labels)
        schedule = list(self.config.TRAIN.SCHEDULE or [])
        logging.info("streaming path: %d train images (%.1f GB) stay in host memory",
                     len(train_labels), train_images.nbytes / 1e9)
        for epoch in range(begin_epoch, end_epoch):
            if not self.static.emulate_zero_shot:
                states = runner.run_epoch(
                    runs, train_images, train_labels,
                    [step_decay_lr(float(lr), epoch, schedule) for lr, _ in hparams],
                    [float(wd) for _, wd in hparams], seed=seed * 1000 + epoch)
                runs = [(bundle, state) for (bundle, _), state in zip(runs, states)]
            if batch is None:
                scored = [self.evaluate(trainable, frozen, state.bn, val_images, labels_np)
                          for (trainable, frozen, _), (_, state) in zip(trials, runs)]
            else:
                scored = self._evaluate_trials(batch.bundle, runs[0][1].bn, val_images,
                                               labels_np, T, mesh)
            for res, (score, probs) in zip(results, scored):
                _update_result(res, score, probs, epoch == begin_epoch, keep_logits)
            if log_every and (epoch % log_every == 0 or epoch == end_epoch - 1):
                logging.info("[Epoch %d] Val %s: %s (streaming)", epoch, self.metric_name,
                             " ".join(f"{score:.3f}" for score, _ in scored))
        if batch is not None:
            self._keep_last(batch, runs[0][1])
            return results
        trainable, frozen, _ = trials[-1]
        self.last_trainable = trainable
        self.last_bundle, self.last_state = runs[-1]
        return results


class TrialBatch(NamedTuple):
    """A batch of trials: each trial's (trainable, frozen) trees, whose
    modules are views into the stacks; the stacked bundle; its state."""

    trees: list
    bundle: dict
    state: TrainState


def _tensor_leaves(x) -> list:
    """The tensors of an optimiser or BN state, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensor_leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensor_leaves(v)]
    return []


def _rank_failure(kind: str, rank: int, msg: str) -> BaseException:
    """The exception a rank raises for another rank's failure, of its kind."""
    from .sweep import RankDeviceError

    text = f"rank {rank} failed: {msg}"
    if kind == "oom":
        return torch.cuda.OutOfMemoryError(text)
    return RankDeviceError(text) if kind == "device" else RuntimeError(text)


def _trial_slice(x, t: int):
    """Trial t's part of a batch's optimiser or BN state: slice t of every
    tensor; Adam's shared step as it is."""
    if isinstance(x, torch.Tensor):
        return x[t]
    if isinstance(x, dict):
        return {k: _trial_slice(v, t) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_trial_slice(v, t) for v in x))
    return x


def _update_result(res: dict, score: float, probs: np.ndarray, first: bool,
                   keep_logits: bool) -> None:
    """One epoch's score into a trial's result (reference trainer.py:920-933):
    the best score by strict ``>``, with its probabilities kept, and the
    first epoch's probabilities kept in any case."""
    res["last_score"] = score
    if score > res["best_score"] or (first and keep_logits and res["best_logits"] is None):
        if keep_logits:
            res["best_logits"] = probs
    res["best_score"] = max(res["best_score"], score)
