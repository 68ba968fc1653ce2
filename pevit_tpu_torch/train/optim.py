"""Optimisers with torch-update semantics, as functional updates over the
trainable tensors (counterpart of ``pevit_tpu/train/optim.py``).

Parameters, gradients and per-leaf settings are ``{name: tensor}`` dicts
keyed by the bundle's dotted parameter names.  Updates run under
``torch.no_grad()`` and change the parameters in place (they are the
modules' own tensors); the optimiser state comes back as a new tuple.
``torch.optim`` is not used because the weight-decay mask and the per-leaf
learning-rate scales must fold in exactly as the reference folds them, with
``lr`` and ``wd`` as plain numbers per call.

torch SGD (dampening 0):
    g   = grad + wd * p
    buf = momentum * buf + g          (buf starts at 0, so the first buf = g)
    p  -= lr * (g + momentum * buf)   if nesterov else   lr * buf

Adam / AdamW: bias correction, eps outside the sqrt; Adam couples wd into
the gradient, AdamW decays decoupled.  As in the reference, ``lr_scales``
(TRAIN.TWO_LR) applies to SGD only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SgdState(NamedTuple):
    momentum_buf: dict


class AdamState(NamedTuple):
    step: int
    m: dict
    v: dict


class RmspropState(NamedTuple):
    sq: dict
    momentum_buf: dict


def _zeros_like(params: dict) -> dict:
    return {n: torch.zeros_like(p) for n, p in params.items()}


# --- SGD -------------------------------------------------------------------

def sgd_init(params: dict) -> SgdState:
    return SgdState(momentum_buf=_zeros_like(params))


@torch.no_grad()
def sgd_update(grads: dict, params: dict, state: SgdState, *, lr, wd, momentum=0.9,
               nesterov=False, lr_scales: Optional[dict] = None) -> SgdState:
    new_buf = {}
    for n, p in params.items():
        g = grads[n] + wd * p
        b = momentum * state.momentum_buf[n] + g
        step = g + momentum * b if nesterov else b
        p.sub_((lr if lr_scales is None else lr * lr_scales[n]) * step)
        new_buf[n] = b
    return SgdState(momentum_buf=new_buf)


# --- Adam / AdamW ----------------------------------------------------------

def adam_init(params: dict) -> AdamState:
    return AdamState(step=0, m=_zeros_like(params), v=_zeros_like(params))


@torch.no_grad()
def adam_update(grads: dict, params: dict, state: AdamState, *, lr, wd, b1=0.9, b2=0.999,
                eps=1e-8, decoupled=False) -> AdamState:
    t = state.step + 1
    # float32 bias corrections, as the reference computes them
    bc1 = 1.0 - torch.tensor(b1) ** float(t)
    bc2 = 1.0 - torch.tensor(b2) ** float(t)
    m_new, v_new = {}, {}
    for n, p in params.items():
        g = grads[n]
        if not decoupled:
            g = g + wd * p
        m_new[n] = b1 * state.m[n] + (1 - b1) * g
        v_new[n] = b2 * state.v[n] + (1 - b2) * g * g
        step = (m_new[n] / bc1) / (torch.sqrt(v_new[n] / bc2) + eps)
        if decoupled:
            step = step + wd * p
        p.sub_(lr * step)
    return AdamState(step=t, m=m_new, v=v_new)


# --- RMSprop ---------------------------------------------------------------

def rmsprop_init(params: dict) -> RmspropState:
    return RmspropState(sq=_zeros_like(params), momentum_buf=_zeros_like(params))


@torch.no_grad()
def rmsprop_update(grads: dict, params: dict, state: RmspropState, *, lr, wd, alpha=0.99,
                   eps=1e-8, momentum=0.9) -> RmspropState:
    sq_new, buf_new = {}, {}
    for n, p in params.items():
        g = grads[n] + wd * p
        sq_new[n] = alpha * state.sq[n] + (1 - alpha) * g * g
        step = g / (torch.sqrt(sq_new[n]) + eps)
        buf_new[n] = momentum * state.momentum_buf[n] + step
        p.sub_(lr * buf_new[n])
    return RmspropState(sq=sq_new, momentum_buf=buf_new)


# --- gradient clipping ------------------------------------------------------

@torch.no_grad()
def clip_grad_norm(grads: dict, max_norm: float) -> dict:
    """torch.nn.utils.clip_grad_norm_ semantics, returning new gradients."""
    total = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}


# --- weight-decay masks ------------------------------------------------------

def build_wd_mask(params: dict, without_wd_list, *, timm_filter: bool = False):
    """Per-leaf 0/1 weight-decay multipliers, ``{name: float}``.

    'ln'/'bn' rules zero decay on normalisation scale and bias, 'bias' on
    every ``*.bias`` leaf; ``timm_filter`` is timm's filter_bias_and_bn, no
    decay on any parameter of rank <= 1.  The rank is the tensor's own: the
    port keeps one tensor per layer where the reference stacks the layers
    on a leading axis.  Returns None when nothing is masked."""
    rules = set(without_wd_list or [])

    def is_ln(k: str) -> bool:
        return (
            k.startswith("ln")
            or k in ("norm", "norm1", "norm2", "patch_norm")
            or k.startswith("norm_")
            or k.startswith("adapter_norm")
        )

    def leaf_mask(name: str, leaf: torch.Tensor) -> float:
        keys = name.split(".")
        if timm_filter and leaf.ndim <= 1:
            return 0.0
        if "ln" in rules and any(is_ln(k) for k in keys):
            return 0.0
        if "bn" in rules and any(k.startswith("bn") for k in keys):
            return 0.0
        if "bias" in rules and keys[-1] in ("bias", "norm_bias"):
            return 0.0
        return 1.0

    mask = {n: leaf_mask(n, p) for n, p in params.items()}
    return None if all(m == 1.0 for m in mask.values()) else mask


# --- dispatch --------------------------------------------------------------

def make_optimizer(name: str, *, momentum=0.9, nesterov=False, lr_scales=None, wd_mask=None):
    """``(init_fn(params), update_fn(grads, params, state, lr, wd) -> state)``.

    ``lr_scales``: optional ``{name: multiplier}`` (TRAIN.TWO_LR).
    ``wd_mask``: optional ``{name: 0/1}`` (TRAIN.WITHOUT_WD_LIST, timm's
    filter): folded into the gradient for coupled decay, or subtracted after
    a wd = 0 step for AdamW, both the same as per-group wd = 0."""
    name = name.lower()
    if wd_mask is not None:
        inner_init, inner_upd = make_optimizer(
            name, momentum=momentum, nesterov=nesterov, lr_scales=lr_scales
        )
        if name == "adamw":
            # decoupled: p -= lr * (adam_step + wd * p), i.e. a wd = 0 update
            # followed by subtracting lr * wd * mask * p_old
            @torch.no_grad()
            def upd(g, p, s, lr, wd):
                decay = {n: (lr * wd * wd_mask[n]) * t for n, t in p.items()}
                new_s = inner_upd(g, p, s, lr, 0.0)
                for n, t in p.items():
                    t.sub_(decay[n])
                return new_s
        else:
            # coupled: g' = g + wd * mask * p, then a wd = 0 update
            @torch.no_grad()
            def upd(g, p, s, lr, wd):
                g2 = {n: g[n] + (wd * wd_mask[n]) * p[n] for n in p}
                return inner_upd(g2, p, s, lr, 0.0)

        return inner_init, upd
    if name == "sgd":
        return sgd_init, lambda g, p, s, lr, wd: sgd_update(
            g, p, s, lr=lr, wd=wd, momentum=momentum, nesterov=nesterov, lr_scales=lr_scales
        )
    if name == "adam":
        return adam_init, lambda g, p, s, lr, wd: adam_update(g, p, s, lr=lr, wd=wd)
    if name == "adamw":
        return adam_init, lambda g, p, s, lr, wd: adam_update(
            g, p, s, lr=lr, wd=wd, decoupled=True
        )
    if name == "rmsprop":
        return rmsprop_init, lambda g, p, s, lr, wd: rmsprop_update(
            g, p, s, lr=lr, wd=wd, momentum=momentum
        )
    raise ValueError(f"Unknown optimizer: {name}")


def step_decay_lr(base_lr: float, epoch: int, schedule) -> float:
    """Step decay by 0.1 at each milestone epoch reached."""
    lr = base_lr
    for milestone in schedule or []:
        lr *= 0.1 if epoch >= milestone else 1.0
    return lr
