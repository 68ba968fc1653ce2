"""Compacter: PHM (parameterized hypercomplex multiplication) adapters.

Counterpart of ``pevit_tpu/peft/compacter.py``; see there for the
reference lines::

    m    = mlp(ln_2(x))
    h    = phm_down(ln_a(m))     # PHMLinear 768 -> 64
    h    = gelu_new(h)           # the tanh GELU, not QuickGELU
    out  = phm_up(h) + m         # PHMLinear 64 -> 768, the residual inside
    x    = x + out

A PHMLinear (phm_dim P = 4, rank 1) builds its weight as
``H = sum_p kron(phm_rule[p], W_left[p] @ W_right[p])`` and computes
``x @ H + b``.  ``phm_rule`` is one (4, 4, 4) tensor shared by every layer
and both projections, drawn from U(-1, 1) and never trained (the
reference's name filter leaves it frozen, ``peft.base``); the factors are
glorot-uniform with gain sqrt(2) per (a, b) slice, the biases zero.
:func:`mlp_post_trials` is the hook of a batch of trials: the parameters,
the rule too, stacked over a leading trial axis (each trial draws its own
rule, as each of the reference's trials rebuilds its model).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.layers import gelu_new, layer_norm
from ..utils.device import resolve_device
from .kron import batched_kron_sum, bmm

PHM_DIM = 4
PHM_RANK = 1
DOWN_SAMPLE = 64


class CompacterShared(nn.Module):
    """The phm rule that every layer shares."""

    def __init__(self):
        super().__init__()
        self.phm_rule = nn.Parameter(torch.zeros(PHM_DIM, PHM_DIM, PHM_DIM))


class CompacterLayer(nn.Module):
    """One layer's adapter: its LayerNorm and the two PHM projections'
    factors and biases."""

    def __init__(self, width: int):
        super().__init__()
        d_in, d_down = width // PHM_DIM, DOWN_SAMPLE // PHM_DIM
        self.norm_scale = nn.Parameter(torch.ones(width))
        self.norm_bias = nn.Parameter(torch.zeros(width))
        self.down_w_left = nn.Parameter(torch.zeros(PHM_DIM, d_in, PHM_RANK))
        self.down_w_right = nn.Parameter(torch.zeros(PHM_DIM, PHM_RANK, d_down))
        self.down_b = nn.Parameter(torch.zeros(DOWN_SAMPLE))
        self.up_w_left = nn.Parameter(torch.zeros(PHM_DIM, d_down, PHM_RANK))
        self.up_w_right = nn.Parameter(torch.zeros(PHM_DIM, PHM_RANK, d_in))
        self.up_b = nn.Parameter(torch.zeros(width))


class Compacter(nn.Module):
    """The shared rule plus one ``CompacterLayer`` per visual layer."""

    def __init__(self, n_layers: int, width: int):
        super().__init__()
        self.shared = CompacterShared()
        self.layers = nn.ModuleList(CompacterLayer(width) for _ in range(n_layers))


def glorot_bound(shape, gain: float = math.sqrt(2.0)) -> float:
    """torch ``xavier_uniform_(gain)``'s bound for each (a, b) slice of a
    stacked (..., a, b) tensor (fan_in b, fan_out a)."""
    a, b = shape[-2], shape[-1]
    return gain * math.sqrt(6.0 / (a + b))


def init_params(generator: torch.Generator, n_layers: int, width: int, *,
                device=None) -> Compacter:
    """The rule U(-1, 1) and the factors glorot-uniform, from ``generator``
    (a CPU generator); the LayerNorm the identity, biases zero."""
    dev = resolve_device(device)
    m = Compacter(n_layers, width)
    uniform = lambda p, bound: p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    with torch.no_grad():
        uniform(m.shared.phm_rule, 1.0)
        for layer in m.layers:
            for p in (layer.down_w_left, layer.down_w_right, layer.up_w_left, layer.up_w_right):
                uniform(p, glorot_bound(p.shape))
    return m.to(dev)


def phm_linear(x: torch.Tensor, w_left: torch.Tensor, w_right: torch.Tensor,
               rule: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PHMLinear: H built in float32, cast to x's dtype, then ``x @ H`` with
    a float32 result (``x.float() @ H.to(dtype).float()``, as the
    reference's ``preferred_element_type=float32`` product) plus ``b`` in
    float32.  Returns float32.  With the operands stacked over T trials, x
    is (T, rows, in) and each trial's rows go through its own H."""
    h = batched_kron_sum(rule, bmm(w_left, w_right))
    if h.dim() == 3:  # stacked trials: x (T, rows, in), b (T, out)
        return torch.bmm(x.float(), h.to(x.dtype).float()) + b.float()[:, None]
    return x.float() @ h.to(x.dtype).float() + b.float()


def mlp_post(shared: CompacterShared, layer: CompacterLayer, generator, m: torch.Tensor, *,
             train: bool = False) -> torch.Tensor:
    """``up(gelu_new(down(LN(m)))) + m`` in m's dtype; the down projection's
    output is cast to m's dtype after ``gelu_new``, the up projection's
    before the residual."""
    del generator, train
    dt = m.dtype
    rule = shared.phm_rule
    h = layer_norm(m, layer.norm_scale, layer.norm_bias)
    h = phm_linear(h, layer.down_w_left, layer.down_w_right, rule, layer.down_b)
    h = gelu_new(h).to(dt)
    h = phm_linear(h, layer.up_w_left, layer.up_w_right, rule, layer.up_b)
    return h.to(dt) + m


def mlp_post_trials(shared: CompacterShared, layer: CompacterLayer, generators,
                    m: torch.Tensor, *, trials: int, train: bool = False) -> torch.Tensor:
    """:func:`mlp_post` of ``trials`` trials at once: m (T*B, N, C), the
    parameters and the rule stacked (T, ...), trial t's rows through trial
    t's adapter."""
    del generators, train
    dt = m.dtype
    rule = shared.phm_rule
    mt = m.reshape(trials, -1, m.shape[-1])
    h = layer_norm(mt, layer.norm_scale[:, None], layer.norm_bias[:, None])
    h = phm_linear(h, layer.down_w_left, layer.down_w_right, rule, layer.down_b)
    h = gelu_new(h).to(dt)
    h = phm_linear(h, layer.up_w_left, layer.up_w_right, rule, layer.up_b)
    return (h.to(dt) + mt).reshape(m.shape)


def num_params(n_layers: int, width: int) -> int:
    d_in, d_down = width // PHM_DIM, DOWN_SAMPLE // PHM_DIM
    per_layer = 2 * width  # the adapter's LayerNorm
    per_layer += PHM_DIM * (d_in * PHM_RANK + PHM_RANK * d_down) + DOWN_SAMPLE  # down
    per_layer += PHM_DIM * (d_down * PHM_RANK + PHM_RANK * d_in) + width  # up
    return n_layers * per_layer + PHM_DIM ** 3  # + the shared rule
