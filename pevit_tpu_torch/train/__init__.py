from .head import Head, batch_norm, head_forward, init_bn_state, init_head
from .partition import combine, partition
from .trainer import TaskStatic, model_forward, trainable_pred

__all__ = [
    "Head",
    "TaskStatic",
    "batch_norm",
    "combine",
    "head_forward",
    "init_bn_state",
    "init_head",
    "model_forward",
    "partition",
    "trainable_pred",
]
