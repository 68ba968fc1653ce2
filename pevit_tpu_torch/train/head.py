"""Classification head: affine-free BatchNorm1d + linear.

Counterpart of ``pevit_tpu/train/head.py``.  BatchNorm follows torch
semantics (momentum 0.1, eps 1e-5, biased variance to normalise, unbiased
for the running update); its state is a ``{"mean", "var"}`` dict that
``batch_norm`` returns updated in training.  The linear kernel is stored
``(embed_dim, num_classes)``: logits = feats @ kernel + bias.

A batch of trials holds the head's parameters stacked over a leading trial
axis (kernel (T, D, K), bias (T, K), logit scale (T,)), the BN state as
(T, D), and takes features (T, B, D): every statistic is over a trial's own
B rows, and the same code serves one trial, whose features are (B, D).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.layers import Dense
from ..utils.device import resolve_device

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class Head(nn.Module):
    def __init__(self, embed_dim: int, num_classes: int):
        super().__init__()
        self.linear = Dense(embed_dim, num_classes)
        self.logit_scale = nn.Parameter(torch.zeros(()))


def init_bn_state(dim: int, *, device=None) -> dict:
    dev = resolve_device(device)
    return {"mean": torch.zeros(dim, device=dev), "var": torch.ones(dim, device=dev)}


def batch_norm(x: torch.Tensor, state: dict, *, train: bool,
               mask: Optional[torch.Tensor] = None, reduce=None):
    """torch BatchNorm1d(affine=False); x: (B, D) or (T, B, D), mask: (B,)
    or (T, B) validity, the statistics over the B rows, or with ``reduce``
    (a sum over a data axis) over every rank's rows.  Returns (y in x's
    dtype, state)."""
    x32 = x.float()
    if not train:
        y = (x32 - state["mean"].unsqueeze(-2)) * torch.rsqrt(state["var"].unsqueeze(-2) + BN_EPS)
        return y.to(x.dtype), state

    if reduce is not None:
        m = (torch.ones(x.shape[:-1], device=x.device) if mask is None else mask.float())[..., None]
        sums = reduce(torch.cat([(x32 * m).sum(-2, keepdim=True), m.sum(-2, keepdim=True)], -1))
        count = torch.clamp(sums[..., -1:], min=1.0)
        mean = sums[..., :-1] / count
        var = reduce((((x32 - mean) ** 2) * m).sum(-2, keepdim=True)) / count
    elif mask is None:
        count = torch.tensor(float(x.shape[-2]), device=x.device)
        mean = x32.mean(-2, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-2, keepdim=True)
    else:
        m = mask.float()[..., None]
        count = torch.clamp(m.sum(-2, keepdim=True), min=1.0)
        mean = (x32 * m).sum(-2, keepdim=True) / count
        var = (((x32 - mean) ** 2) * m).sum(-2, keepdim=True) / count

    y = (x32 - mean) * torch.rsqrt(var + BN_EPS)
    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
    new_state = {
        "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean.squeeze(-2),
        "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased.squeeze(-2),
    }
    if mask is not None:
        y = y * m
    return y.to(x.dtype), new_state


def init_head(
    generator: torch.Generator,
    embed_dim: int,
    num_classes: int,
    *,
    text_init_weights: Optional[np.ndarray] = None,
    logit_scale_init: str = "none",
    backbone_logit_scale: Optional[float] = None,
    device=None,
) -> Head:
    """Head parameters.  ``text_init_weights``: (embed_dim, num_classes)
    zero-shot class embeddings (bias zero); otherwise torch Linear's default
    U(+-1/sqrt(embed_dim)) from ``generator`` (a CPU generator).
    ``logit_scale_init``: "none" (0), "pretrained", "ln_cls" or "clip"."""
    dev = resolve_device(device)
    head = Head(embed_dim, num_classes)
    with torch.no_grad():
        if text_init_weights is not None:
            head.linear.kernel.copy_(torch.as_tensor(np.asarray(text_init_weights, np.float32)))
        else:
            bound = 1.0 / math.sqrt(embed_dim)
            for p in (head.linear.kernel, head.linear.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
        if logit_scale_init == "pretrained":
            ls = float(backbone_logit_scale if backbone_logit_scale is not None
                       else math.log(1 / 0.07))
        elif logit_scale_init == "ln_cls":
            ls = math.log(math.log(max(num_classes, 3)))
        elif logit_scale_init == "clip":
            ls = math.log(1 / 0.07)
        else:
            ls = 0.0
        head.logit_scale.fill_(ls)
    return head.to(dev)


def head_forward(
    head: Head,
    bn_state: dict,
    feats: torch.Tensor,
    *,
    train: bool,
    mask: Optional[torch.Tensor] = None,
    use_bn: bool = True,
    normalize_feature: bool = False,
    apply_logit_scale: bool = False,
    reduce=None,
):
    """Features (float32) -> (logits float32, bn_state); (B, D) features
    give (B, K) logits, a trial batch's (T, B, D) give (T, B, K).
    ``reduce``: the BN statistics' sum over a data axis (:func:`batch_norm`)."""
    x = feats.float()
    if use_bn:
        x, bn_state = batch_norm(x, bn_state, train=train, mask=mask, reduce=reduce)
    if normalize_feature:
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    logits = x @ head.linear.kernel + head.linear.bias.unsqueeze(-2)
    if apply_logit_scale:
        logits = torch.exp(head.logit_scale)[..., None, None] * logits
    return logits, bn_state
