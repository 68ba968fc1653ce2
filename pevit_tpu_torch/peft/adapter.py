"""The Pfeiffer-style bottleneck adapter after each block's MLP.

Counterpart of ``pevit_tpu/peft/adapter.py``; see there for the reference
lines::

    m   = mlp(ln_2(x))
    out = up(relu(down(ln_a(m)))) + m       # the residual inside the adapter
    x   = x + out

down 768 -> 64 and up 64 -> 768, kernels N(0, 0.02), biases zero, a
LayerNorm before and none after.  The reference evaluates the MLP twice
per block, once as the adapter's input and once as its residual; both are
bit-identical, so it is computed once, as the JAX package does.
:func:`mlp_post_trials` is the hook of a batch of trials: the parameters
stacked over a leading trial axis, m the trials' batches folded into one.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.layers import layer_norm
from ..utils.device import resolve_device

DOWN_SAMPLE = 64


class AdapterLayer(nn.Module):
    """One layer's adapter: its LayerNorm, down and up projections."""

    def __init__(self, width: int):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.ones(width))
        self.norm_bias = nn.Parameter(torch.zeros(width))
        self.down_kernel = nn.Parameter(torch.zeros(width, DOWN_SAMPLE))
        self.down_bias = nn.Parameter(torch.zeros(DOWN_SAMPLE))
        self.up_kernel = nn.Parameter(torch.zeros(DOWN_SAMPLE, width))
        self.up_bias = nn.Parameter(torch.zeros(width))


class Adapter(nn.Module):
    """One ``AdapterLayer`` per visual layer; nothing is shared."""

    def __init__(self, n_layers: int, width: int):
        super().__init__()
        self.shared = None
        self.layers = nn.ModuleList(AdapterLayer(width) for _ in range(n_layers))


def init_params(generator: torch.Generator, n_layers: int, width: int, *,
                device=None) -> Adapter:
    """Kernels N(0, 0.02) from ``generator`` (a CPU generator); the
    LayerNorm the identity, biases zero."""
    dev = resolve_device(device)
    m = Adapter(n_layers, width)
    with torch.no_grad():
        for layer in m.layers:
            for p in (layer.down_kernel, layer.up_kernel):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return m.to(dev)


def mlp_post(shared, layer: AdapterLayer, generator, m: torch.Tensor, *,
             train: bool = False) -> torch.Tensor:
    """``up(relu(down(LN(m)))) + m`` in m's dtype: LN as a float32 island,
    each product with a float32 result (``h.float() @ w.to(dt).float()``,
    as the reference's ``preferred_element_type=float32``), its bias added
    in float32 and the sum cast to m's dtype."""
    del shared, generator, train
    dt = m.dtype
    h = layer_norm(m, layer.norm_scale, layer.norm_bias)
    h = torch.relu(h.float() @ layer.down_kernel.to(dt).float() + layer.down_bias).to(dt)
    up = h.float() @ layer.up_kernel.to(dt).float() + layer.up_bias
    return up.to(dt) + m


def mlp_post_trials(shared, layer: AdapterLayer, generators, m: torch.Tensor, *, trials: int,
                    train: bool = False) -> torch.Tensor:
    """:func:`mlp_post` of ``trials`` trials at once: m (T*B, N, C), the
    adapter's parameters stacked (T, ...), trial t's rows through trial t's
    adapter."""
    del shared, generators, train
    dt = m.dtype
    mt = m.reshape(trials, -1, m.shape[-1])
    h = layer_norm(mt, layer.norm_scale[:, None], layer.norm_bias[:, None])
    h = torch.relu(torch.bmm(h.float(), layer.down_kernel.to(dt).float())
                   + layer.down_bias[:, None]).to(dt)
    up = torch.bmm(h.float(), layer.up_kernel.to(dt).float()) + layer.up_bias[:, None]
    return (up.to(dt) + mt).reshape(m.shape)


def num_params(n_layers: int, width: int) -> int:
    per_layer = 2 * width  # the adapter's LayerNorm
    per_layer += width * DOWN_SAMPLE + DOWN_SAMPLE
    per_layer += DOWN_SAMPLE * width + width
    return n_layers * per_layer
