"""CLIP weights and the trained state for the port's entry points.

Counterpart of ``pevit_tpu/ckpt``: ``load_clip`` reads an OpenAI CLIP ViT
checkpoint (or draws random weights) into the port's ``CLIP``
(``torch_loader``), and ``save_trainable`` / ``restore_trainable`` write and
read the trained state in the reference's npz format (``orbax_io``).
"""

from .orbax_io import restore_trainable, save_trainable
from .torch_loader import (
    MODEL_CKPT_NAMES,
    clip_to_state_dict,
    infer_spec_from_state_dict,
    load_clip,
    read_torch_state_dict,
    state_dict_to_params,
)

__all__ = [
    "MODEL_CKPT_NAMES",
    "clip_to_state_dict",
    "infer_spec_from_state_dict",
    "load_clip",
    "read_torch_state_dict",
    "restore_trainable",
    "save_trainable",
    "state_dict_to_params",
]
