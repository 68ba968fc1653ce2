"""The task trainer: task configuration, the forward and loss, whole
training runs with per-epoch evaluation (training subset of
``pevit_tpu/train/trainer.py``).

The reference runs an epoch as one XLA computation and trains a batch of
hyperparameter trials at once under ``vmap``, on a device mesh.  The port
runs eagerly, one trial after another, on one card; the math is the same:

* each epoch visits the train split in a shuffled order (drawn from the
  state's generator, or injected by the caller so that a run can replay
  another's order); full batches, then the tail at its NATURAL size — padding
  is not equivalent because KAdaptation's raw-reshape scramble mixes batch
  rows — and a tail of one image is skipped;
* gradients are taken for the trainable partition only (the frozen
  parameters have ``requires_grad`` False); a trainable tensor that the
  forward does not use (KAdaptation's v factors, quirk 1) gets a zero
  gradient, so weight decay still applies to it as in the reference;
* each step draws its dropout from a fresh generator on the card, seeded
  from the epoch's seed and the step index;
* after every epoch the val split is evaluated in chunks of ``eval_chunk``
  plus a natural-size remainder, never padded; the best epoch is picked on
  the host (strict ``>``, keeping the best epoch's probabilities).

TPU-side knobs of the config's ``TPU`` node are read and ignored, see
``IGNORED_TPU_KNOBS``.  ``TPU.FUSED_MLP`` is not read: on the card the fused
kernel is the MLP's route for every method whose MLP weights are frozen and
whose blocks need no bare MLP output (``UNFUSED_MLP_METHODS`` are the rest).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
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
from ..utils.device import compute_dtype, resolve_device, to_numpy
from .head import head_forward, init_bn_state, init_head
from .optim import build_wd_mask, clip_grad_norm, make_optimizer, step_decay_lr
from .partition import combine, count_params, named_parameters, partition

# TPU-side knobs the port reads from the config and ignores, with their
# defaults.  FAST_LN and FAST_LN_SWEEP change numerics in the reference
# (LayerNorm statistics in the activation dtype, for the whole run or for
# the sweep's trials); the others change only how XLA schedules the same
# math (remat, unrolling, layouts, a concatenated delta GEMM, folding LN2's
# affine into c_fc), pick a kernel the port always runs, or lay trials and
# batches over a device mesh (the port runs on one card).
IGNORED_TPU_KNOBS = {
    "FAST_LN": False,
    "FAST_LN_SWEEP": False,
    "SWEEP_TRIALS_OVER_MESH": True,
    "MESH_DATA": -1,
    "MESH_MODEL": 1,
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
    the method's filter selects, and under full_finetune the visual tower
    only: the text tower and CLIP's logit scale stay frozen
    (kadaptation_clip.py:104-116)."""
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
):
    """uint8 images -> (logits float32, bn_state).

    ``images_u8`` is (B, H, W, 3) raw uint8, normalised on its device in the
    compute dtype (``x = u8 / 255``, then ``(x - mean) / std``), or
    (B, G*G, p*p*3) pre-patchified uint8 (:func:`patchify_images`), whose
    normalisation folds into the patch-embedding GEMM.  ``generator`` (on
    the images' device) draws KAdaptation's train-time dropout."""
    dt = static.dtype
    kw = dict(spec=static.spec, peft=bundle.get("peft"),
              hooks=make_hooks(static.peft_cfg, static.spec, train=train), generator=generator,
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
    return head_forward(
        bundle["head"],
        bn_state,
        feats.float(),
        train=train,
        mask=mask,
        use_bn=static.use_bn,
        normalize_feature=static.normalize_feature,
        apply_logit_scale=static.apply_logit_scale,
    )


def _loss(static: TaskStatic, logits, labels, mask):
    """Masked-mean CE (or BCE for multilabel)."""
    if static.multilabel:
        per = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs()))).mean(-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        per = logz - logits.gather(-1, labels[:, None].long())[:, 0]
    count = torch.clamp(mask.sum(), min=1.0)
    return (per * mask).sum() / count


# ---------------------------------------------------------------------------
# Epoch / eval builders
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """What a training run carries from step to step.  ``params`` are the
    trainable tensors of the bundle (updated in place); ``generator`` is a
    CPU generator for epoch orders and per-step dropout seeds; ``loss`` is
    the last step's loss (a detached tensor, None before the first step)."""

    params: dict
    opt: Any
    bn: dict
    generator: torch.Generator
    loss: Optional[torch.Tensor] = None


def build_epoch_fn(static: TaskStatic, n_train: int, preproc: dict, lr_scales=None,
                   wd_mask=None):
    """One training epoch.

    Returns ``epoch(bundle, images, labels, state, lr, wd, order=None) ->
    state``: ``order`` (the epoch's permutation of the train split) is drawn
    from ``state.generator`` unless given.  ``lr_scales`` (TRAIN.TWO_LR) and
    ``wd_mask`` are per-parameter dicts."""
    B = static.batch_size
    _, opt_update = make_optimizer(static.optimizer, momentum=static.momentum,
                                   nesterov=static.nesterov, lr_scales=lr_scales,
                                   wd_mask=wd_mask)

    def epoch(bundle, images, labels, state: TrainState, lr, wd, order=None) -> TrainState:
        params, opt_state, bn_state, gen, loss = state
        if order is None:
            order = torch.randperm(n_train, generator=gen)
        drop_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        order = torch.as_tensor(np.array(order), dtype=torch.long).to(images.device)
        names = list(params)

        def run_step(idx, step_i):
            nonlocal opt_state, bn_state, loss
            imgs = images.index_select(0, idx)
            labs = labels.index_select(0, idx)
            step_gen = torch.Generator(device=images.device).manual_seed(drop_seed + step_i)
            valid = torch.ones(idx.shape[0], device=images.device)
            with torch.enable_grad():
                logits, new_bn = model_forward(static, bundle, bn_state, imgs, preproc,
                                               train=True, generator=step_gen, mask=valid)
                step_loss = _loss(static, logits, labs, valid)
                grads = torch.autograd.grad(step_loss, [params[n] for n in names],
                                            allow_unused=True)
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)}
            if static.clip_grad_norm > 0:
                grads = clip_grad_norm(grads, static.clip_grad_norm)
            opt_state = opt_update(grads, params, opt_state, lr, wd)
            bn_state = {k: v.detach() for k, v in new_bn.items()}
            loss = step_loss.detach()

        steps_full = n_train // B
        for i in range(steps_full):
            run_step(order[i * B:(i + 1) * B], i)
        if n_train - steps_full * B > 1:  # a size-1 tail is skipped
            run_step(order[steps_full * B:], steps_full)
        return TrainState(params, opt_state, bn_state, gen, loss)

    return epoch


def build_eval_fn(static: TaskStatic, preproc: dict):
    """``eval_chunk(bundle, bn_state, imgs) -> float32 logits`` in eval
    mode, without autograd."""

    def eval_chunk(bundle, bn_state, imgs):
        with torch.no_grad():
            logits, _ = model_forward(static, bundle, bn_state, imgs, preproc, train=False)
        return logits.float()

    return eval_chunk


def build_fit_eval_fn(static: TaskStatic, n_train: int, n_epochs: int, preproc: dict, *,
                      eval_chunk: int, n_val: int, lr_scales=None, wd_mask=None):
    """Train ``n_epochs`` and evaluate after every epoch.

    Returns ``fit_eval(bundle, images, labels, val_images, state, lr_table,
    wd, orders=None) -> (state, logits)`` with ``logits`` (n_epochs, n_val,
    K) float32; ``orders[e]`` injects epoch e's order.  Eval runs in full
    chunks of ``eval_chunk`` and a natural-size remainder, never padded: the
    scramble makes a chunk's composition part of its logits."""
    epoch = build_epoch_fn(static, n_train, preproc, lr_scales, wd_mask)
    one_chunk = build_eval_fn(static, preproc)

    def fit_eval(bundle, images, labels, val_images, state, lr_table, wd, orders=None):
        logits = []
        for e in range(n_epochs):
            if not static.emulate_zero_shot:
                state = epoch(bundle, images, labels, state, lr_table[e], wd,
                              None if orders is None else orders[e])
            logits.append(torch.cat([one_chunk(bundle, state.bn, val_images[s:s + eval_chunk])
                                     for s in range(0, n_val, eval_chunk)]))
        return state, torch.stack(logits)

    return fit_eval


# ---------------------------------------------------------------------------
# Host-side orchestration
# ---------------------------------------------------------------------------

def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(z)
    return probs / probs.sum(axis=-1, keepdims=True)


class TrainTask:
    """Owns the frozen CLIP tower on the card and runs trainings of one
    task, one trial after another."""

    def __init__(self, config, static: TaskStatic, clip, *,
                 text_init_weights: Optional[np.ndarray] = None,
                 eval_chunk: Optional[int] = None, device=None):
        self.device = resolve_device(device)
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

    # -- input path ---------------------------------------------------------

    @property
    def use_prepack(self) -> bool:
        """The pre-patchified uint8 path, except under TPU.PARITY_FP32, which
        keeps the reference's normalise-then-patchify order."""
        return not self.static.highest_precision

    def prepack(self, images) -> torch.Tensor:
        """Images to the card as uint8, pre-patchified when the fast path
        applies.  Already-packed (N, G*G, p*p*3) tensors pass through."""
        x = torch.as_tensor(images).to(self.device)
        p = self.static.spec.vision.patch_size
        if not self.use_prepack or x.dim() != 4 or x.shape[1] % p or x.shape[2] % p:
            return x
        return patchify_images(x, p).contiguous()

    # -- bundle ------------------------------------------------------------

    def init_bundle(self, generator: torch.Generator) -> tuple:
        """(trainable, frozen, bn_state) for one trial; the PEFT parameters
        and then the head are drawn from ``generator`` (a CPU generator)."""
        st = self.static
        peft = init_peft(generator, st.peft_cfg, st.spec, device=self.device)
        text_weights = self.text_init_weights
        if text_weights is not None and st.merge_encoder_head_proj:
            # the visual projection folds into the head: (width, K) = proj @ (E, K)
            proj = self.clip.visual.proj.detach().float().cpu().numpy()
            text_weights = proj @ np.asarray(text_weights, np.float32)
        head = init_head(generator, st.head_dim, st.num_classes,
                         text_init_weights=text_weights,
                         logit_scale_init=self.config.TRAIN.LOGIT_SCALE_INIT,
                         backbone_logit_scale=self.clip.logit_scale.item(), device=self.device)
        bundle = {"clip": self._trial_clip(), "peft": peft, "head": head}
        trainable, frozen = partition(bundle, trainable_pred(st))
        return trainable, frozen, init_bn_state(st.head_dim, device=self.device)

    def _trial_clip(self):
        """The CLIP a trial's bundle holds: the task's own, except under
        full_finetune, where the optimiser updates the visual tower in place,
        so each trial trains a copy of it (sharing the frozen text tower and
        logit scale) and every trial starts from the pretrained tower, as the
        reference's trials start from its immutable parameters."""
        if self.static.peft_cfg.method != "full_finetune":
            return self.clip
        shared = (self.clip.text, self.clip.logit_scale)
        return copy.deepcopy(self.clip, {id(m): m for m in shared})

    def max_parallel_trials(self) -> int:
        """The sweep's trial chunk: TPU.SWEEP_PARALLEL_TRIALS (one card; the
        chunk's trials run one after another)."""
        return max(1, self.config.TPU.SWEEP_PARALLEL_TRIALS)

    def model_info(self, trainable) -> dict:
        """Parameter counts, as the reference's (kadaptation_clip.py:284-289):
        the backbone is the whole CLIP (both towers and its logit scale)."""
        st = self.static
        clip_n = count_params(self.clip)
        peft_n = peft_num_params(st.peft_cfg, st.spec)
        head_n = st.head_dim * st.num_classes + st.num_classes
        return {
            "n_trainable_params": count_params(trainable_params(trainable)),
            "n_visual_params": count_params(self.clip.visual) + peft_n,
            "n_backbone_params": clip_n + peft_n,
            "n_params": clip_n + peft_n + head_n + 1,  # +1 classifier logit_scale
        }

    def _trainable_names(self) -> dict:
        trainable, _, _ = self.init_bundle(torch.Generator().manual_seed(0))
        return trainable_params(trainable)

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

    def _fit_eval_fn(self, n_train: int, n_epochs: int, n_val: int):
        return build_fit_eval_fn(self.static, n_train, n_epochs, self.preproc,
                                 eval_chunk=self.eval_chunk, n_val=n_val,
                                 lr_scales=self._lr_scales(), wd_mask=self._wd_mask())

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
        one_chunk = build_eval_fn(self.static, self.preproc)
        n = len(labels)
        logits = torch.cat([one_chunk(bundle, bn_state, self.prepack(images_u8[s:s + self.eval_chunk]))
                            for s in range(0, n, self.eval_chunk)])
        probs = _softmax(logits.cpu().numpy())
        return self._score(to_numpy(labels), probs), probs

    # -- training ------------------------------------------------------------

    def train_trials(self, hparams: list, train_images, train_labels, val_images, val_labels, *,
                     end_epoch: int, begin_epoch: int = 0, seed: int = 0,
                     keep_logits: bool = False, log_every: int = 0) -> list:
        """Train one trial per ``(lr, wd)`` in ``hparams``, one after another,
        evaluating after every epoch.

        Trial t's PEFT parameters and head come from a CPU generator seeded
        ``seed * 1_000_003 + 2 t``, its epoch orders and dropout seeds from
        one seeded ``+ 1``.  Returns per-trial dicts {"best_score", "last_score",
        "best_logits"}; ``last_trainable``, ``last_bundle`` and ``last_state``
        then hold the last trial's trainable partition, trained bundle and
        state."""
        n_train = len(train_labels)
        n_val = len(val_labels)
        n_epochs = end_epoch - begin_epoch
        results = [{"best_score": 0.0, "last_score": 0.0, "best_logits": None} for _ in hparams]
        if n_epochs <= 0:
            trainable, frozen, _ = self.init_bundle(
                torch.Generator().manual_seed(seed * 1_000_003 + 2 * (len(hparams) - 1)))
            self.last_trainable, self.last_bundle = trainable, combine(trainable, frozen)
            return results
        images, labels = self.prepack(train_images), self._labels(train_labels)
        val = self.prepack(val_images)
        labels_np = to_numpy(val_labels)
        schedule = list(self.config.TRAIN.SCHEDULE or [])
        fit_eval = self._fit_eval_fn(n_train, n_epochs, n_val)
        for t, (lr, wd) in enumerate(hparams):
            base = seed * 1_000_003 + 2 * t
            trainable, frozen, bn = self.init_bundle(torch.Generator().manual_seed(base))
            params = trainable_params(trainable)
            state = TrainState(params, self._opt_init(params), bn,
                               torch.Generator().manual_seed(base + 1))
            lr_table = [step_decay_lr(float(lr), e, schedule) for e in range(begin_epoch, end_epoch)]
            t0 = time.perf_counter()
            state, logits = fit_eval(combine(trainable, frozen), images, labels, val, state,
                                     lr_table, float(wd))
            logits_np = logits.cpu().numpy()
            run_s = time.perf_counter() - t0
            res = results[t]
            for e in range(n_epochs):
                probs = _softmax(logits_np[e])
                score = self._score(labels_np, probs)
                res["last_score"] = score
                if score > res["best_score"] or (e == 0 and keep_logits and res["best_logits"] is None):
                    if keep_logits:
                        res["best_logits"] = probs
                res["best_score"] = max(res["best_score"], score)
                if log_every and (e % log_every == 0 or e == n_epochs - 1):
                    logging.info("[Trial %d epoch %d] Val %s: %.3f", t, begin_epoch + e,
                                 self.metric_name, score)
            if log_every:
                logging.info("=> trial %d: %d epochs in %.2fs | best %.3f", t, n_epochs, run_s,
                             res["best_score"])
            self.last_trainable = trainable
            self.last_bundle, self.last_state = combine(trainable, frozen), state
        return results
