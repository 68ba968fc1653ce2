"""LoRA: rank-4 low-rank q/v updates.

Counterpart of ``pevit_tpu/peft/lora.py``; see there for the reference
lines.  ``delta = (x @ A) @ B * (alpha / r)`` with r = 4, alpha = 128, so
the scale is 32; A ~ N(0, 0.02), B = 0, so the delta starts at exactly 0.
It shares KAdaptation's application quirks: the delta comes from the LN'd
block input, is added after q's scale, and under ``reference_compat`` goes
through the (N, B, C) -> (B*H, N, hd) raw-reshape scramble.  No bias, no
dropout (the reference's ``lora_r_dropout`` is None).  :func:`attn_delta_trials`
is the hook of a batch of trials, as KAdaptation's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from .kadaptation import trial_heads

LORA_RANK = 4
LORA_ALPHA = 128
SCALE = LORA_ALPHA / LORA_RANK  # = 32


class LoRALayer(nn.Module):
    """One layer's q and v factors, kernels stored (in, out)."""

    def __init__(self, width: int):
        super().__init__()
        self.q_a = nn.Parameter(torch.zeros(width, LORA_RANK))
        self.q_b = nn.Parameter(torch.zeros(LORA_RANK, width))
        self.v_a = nn.Parameter(torch.zeros(width, LORA_RANK))
        self.v_b = nn.Parameter(torch.zeros(LORA_RANK, width))


class LoRA(nn.Module):
    """One ``LoRALayer`` per visual layer; nothing is shared."""

    def __init__(self, n_layers: int, width: int):
        super().__init__()
        self.shared = None
        self.layers = nn.ModuleList(LoRALayer(width) for _ in range(n_layers))


def init_params(generator: torch.Generator, n_layers: int, width: int, *, device=None) -> LoRA:
    """A factors N(0, 0.02) from ``generator`` (a CPU generator), B zero."""
    dev = resolve_device(device)
    m = LoRA(n_layers, width)
    with torch.no_grad():
        for layer in m.layers:
            for p in (layer.q_a, layer.v_a):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return m.to(dev)


def _low_rank(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(x @ a)`` with a float32 result, cast to x's dtype, then ``@ b``
    with a float32 result, as the reference's two
    ``preferred_element_type=float32`` products (the products of two
    low-precision values are exact in float32)."""
    dt = x.dtype
    h = (x.float() @ a.to(dt).float()).to(dt)
    return h.float() @ b.to(dt).float()


def attn_delta(shared, layer: LoRALayer, generator, x: torch.Tensor, *, n_head: int,
               train: bool = False, reference_compat: bool = True):
    """(q_delta, v_delta) in (B, H, N, hd) layout, float32, for x: (B, N, C)."""
    del shared, generator, train
    B, N, C = x.shape
    hd = C // n_head
    dq = _low_rank(x, layer.q_a, layer.q_b) * SCALE
    dv = _low_rank(x, layer.v_a, layer.v_b) * SCALE
    if reference_compat:
        # quirk 4: the reference computes in (N, B, C) and raw-reshapes;
        # the copy is made explicit so that the reshape is a view whatever
        # the batch, which keeps a symbolic batch free of guards on export
        dq = dq.permute(1, 0, 2).flatten().view(B, n_head, N, hd)
        dv = dv.permute(1, 0, 2).flatten().view(B, n_head, N, hd)
    else:
        dq = dq.reshape(B, N, n_head, hd).transpose(1, 2)
        dv = dv.reshape(B, N, n_head, hd).transpose(1, 2)
    return dq, dv


def attn_delta_trials(shared, layer: LoRALayer, generators, x: torch.Tensor, *, trials: int,
                      n_head: int, train: bool = False, reference_compat: bool = True):
    """:func:`attn_delta` of ``trials`` trials at once: x (T*B, N, C), the
    factors stacked (T, ...); returns (T*B, H, N, hd) deltas, trial t's rows
    through trial t's factors, the scramble within each trial."""
    del shared, generators, train
    TB, N, C = x.shape
    B = TB // trials
    dt = x.dtype
    xt = x.reshape(trials, B * N, C)

    def low_rank(a, b):  # as _low_rank, one product per trial
        h = torch.bmm(xt.float(), a.to(dt).float()).to(dt)
        return torch.bmm(h.float(), b.to(dt).float())

    dq = low_rank(layer.q_a, layer.q_b) * SCALE
    dv = low_rank(layer.v_a, layer.v_b) * SCALE
    return (trial_heads(dq, B, n_head, reference_compat),
            trial_heads(dv, B, n_head, reference_compat))


def num_params(n_layers: int, width: int) -> int:
    return n_layers * 4 * width * LORA_RANK
