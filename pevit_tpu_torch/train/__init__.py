from .head import Head, batch_norm, head_forward, init_bn_state, init_head
from .optim import AdamState, RmspropState, SgdState, make_optimizer, step_decay_lr
from .partition import combine, count_params, named_parameters, partition
from .sweep import hyperparameter_sweep_lr, run_method, wd_grid
from .trainer import (
    TaskStatic,
    TrainState,
    TrainTask,
    build_epoch_fn,
    build_eval_fn,
    build_fit_eval_fn,
    model_forward,
    trainable_params,
    trainable_pred,
)

__all__ = [
    "AdamState",
    "Head",
    "RmspropState",
    "SgdState",
    "TaskStatic",
    "TrainState",
    "TrainTask",
    "batch_norm",
    "build_epoch_fn",
    "build_eval_fn",
    "build_fit_eval_fn",
    "combine",
    "count_params",
    "head_forward",
    "hyperparameter_sweep_lr",
    "init_bn_state",
    "init_head",
    "make_optimizer",
    "model_forward",
    "named_parameters",
    "partition",
    "run_method",
    "step_decay_lr",
    "trainable_params",
    "trainable_pred",
    "wd_grid",
]
