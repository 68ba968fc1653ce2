"""PEFT registry (counterpart of ``pevit_tpu/peft/base.py``).

The port carries KAdaptation and the methods without PEFT parameters
(linear_probe, full_finetune, zeroshot); LoRA, adapter and Compacter are
known names whose hooks come with a later slice.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch

from ..core.clip import BlockHooks, CLIPSpec
from . import kadaptation as _kadaptation

PEFT_METHODS = ("kadaptation", "lora", "adapter", "compacter")
ALL_METHODS = PEFT_METHODS + ("linear_probe", "full_finetune", "zeroshot")
_PORTED = ("kadaptation",)


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


def require_ported(cfg: PeftConfig) -> None:
    if cfg.has_peft_params and cfg.method not in _PORTED:
        raise NotImplementedError(f"PEFT method {cfg.method!r} is not ported yet")


def init_peft(generator: torch.Generator, cfg: PeftConfig, spec: CLIPSpec, *, device=None):
    """The PEFT parameter module for the visual tower, or None."""
    if not cfg.has_peft_params:
        return None
    require_ported(cfg)
    return _kadaptation.init_params(generator, spec.vision.layers, spec.vision.width,
                                    device=device)


def make_hooks(cfg: PeftConfig, spec: CLIPSpec, train: bool) -> Optional[BlockHooks]:
    """The per-block callbacks for the visual tower, or None."""
    require_ported(cfg)
    if cfg.method == "kadaptation":
        return BlockHooks(attn_delta=partial(
            _kadaptation.attn_delta,
            n_head=spec.vision.heads,
            train=train,
            reference_compat=cfg.reference_compat,
            dropout_p=cfg.kadapt_dropout_p,
        ))
    return None


def peft_num_params(cfg: PeftConfig, spec: CLIPSpec) -> int:
    """Parameter count of the method's PEFT module (0 for no-PEFT methods)."""
    if not cfg.has_peft_params:
        return 0
    require_ported(cfg)
    return _kadaptation.num_params(spec.vision.layers, spec.vision.width)


def peft_trainable_filter(cfg: PeftConfig):
    """``pred(path) -> bool`` over parameter paths inside the PEFT module,
    as the reference's name-substring freezing selects them: for
    KAdaptation, LoRA and the adapter the whole module trains (q/v factors,
    shared phm rules and per-layer biases); Compacter's shared phm rule stays
    frozen at its init."""
    if cfg.method == "compacter":
        return lambda path: len(path) > 0 and path[0] != "shared"
    return lambda path: True
