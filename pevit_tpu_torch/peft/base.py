"""PEFT registry (counterpart of ``pevit_tpu/peft/base.py``).

Methods: kadaptation, lora, adapter and compacter carry PEFT parameters in
the visual tower; linear_probe, full_finetune and zeroshot carry none.  A
method contributes an ``init_params(generator, n_layers, width)`` module
with ``shared`` (None where nothing is shared) and per-layer ``layers``,
``BlockHooks`` callbacks and a trainability rule.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch

from ..core.clip import BlockHooks, CLIPSpec
from . import adapter as _adapter
from . import compacter as _compacter
from . import kadaptation as _kadaptation
from . import lora as _lora

PEFT_METHODS = ("kadaptation", "lora", "adapter", "compacter")
ALL_METHODS = PEFT_METHODS + ("linear_probe", "full_finetune", "zeroshot")
_MODULES = {"kadaptation": _kadaptation, "lora": _lora, "adapter": _adapter,
            "compacter": _compacter}
# the parameter module of each method, as ``bridge.from_jax`` builds it
MODULE_CLASSES = {"kadaptation": _kadaptation.KAdaptation, "lora": _lora.LoRA,
                  "adapter": _adapter.Adapter, "compacter": _compacter.Compacter}


@dataclasses.dataclass(frozen=True)
class PeftConfig:
    method: str = "linear_probe"
    reference_compat: bool = True
    kadapt_dropout_p: float = _kadaptation.KDROPOUT_P

    def __post_init__(self):
        if self.method not in ALL_METHODS:
            raise ValueError(f"Unknown PEFT method: {self.method}")

    @property
    def has_peft_params(self) -> bool:
        return self.method in PEFT_METHODS


def init_peft(generator: torch.Generator, cfg: PeftConfig, spec: CLIPSpec, *, device=None):
    """The PEFT parameter module for the visual tower, or None."""
    if not cfg.has_peft_params:
        return None
    return _MODULES[cfg.method].init_params(generator, spec.vision.layers, spec.vision.width,
                                            device=device)


def make_hooks(cfg: PeftConfig, spec: CLIPSpec, train: bool,
               trials: int = 0) -> Optional[BlockHooks]:
    """The per-block callbacks for the visual tower, or None.  With
    ``trials`` they are a batch of trials' hooks: the PEFT parameters
    stacked over a leading trial axis, the block input the trials' batches
    folded into one, one generator per trial (``BlockHooks``)."""
    n_head = spec.vision.heads
    if trials:
        kw = {"trials": trials}
        pick = lambda module, name: getattr(module, name + "_trials")
    else:
        kw = {}
        pick = getattr
    if cfg.method == "kadaptation":
        return BlockHooks(attn_delta=partial(
            pick(_kadaptation, "attn_delta"),
            n_head=n_head,
            train=train,
            reference_compat=cfg.reference_compat,
            dropout_p=cfg.kadapt_dropout_p,
            **kw,
        ))
    if cfg.method == "lora":
        return BlockHooks(attn_delta=partial(pick(_lora, "attn_delta"), n_head=n_head,
                                             train=train,
                                             reference_compat=cfg.reference_compat, **kw))
    if cfg.method in ("adapter", "compacter"):
        return BlockHooks(mlp_post=partial(pick(_MODULES[cfg.method], "mlp_post"), train=train,
                                           **kw))
    return None


def peft_num_params(cfg: PeftConfig, spec: CLIPSpec) -> int:
    """Parameter count of the method's PEFT module (0 for no-PEFT methods)."""
    if not cfg.has_peft_params:
        return 0
    return _MODULES[cfg.method].num_params(spec.vision.layers, spec.vision.width)


def peft_trainable_filter(cfg: PeftConfig):
    """``pred(path) -> bool`` over parameter paths inside the PEFT module,
    as the reference's name-substring freezing selects them: for
    KAdaptation, LoRA and the adapter the whole module trains (q/v factors,
    shared phm rules and per-layer biases); Compacter's shared phm rule stays
    frozen at its init."""
    if cfg.method == "compacter":
        return lambda path: len(path) > 0 and path[0] != "shared"
    return lambda path: True
