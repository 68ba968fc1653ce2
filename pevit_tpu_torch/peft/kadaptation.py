"""KAdaptation: Kronecker-factored delta-W on attention q/v.

Counterpart of ``pevit_tpu/peft/kadaptation.py``; see there for the math.
The reference's quirks are kept behind ``reference_compat=True``:

1. the v delta reuses ``Wq`` (v_left/v_right exist but are unused);
2. the q/v factors are zero at init, so the delta starts at exactly 0;
3. deltas come from the LN'd block input and are added after q's scale;
4. the (N, B, C) -> (B*H, N, hd) raw reshape scrambles tokens, batch rows
   and heads (``permute(1, 0, 2).reshape(...)``, never a view);
5. Dropout(0.5) on H itself, independently for q and v (training only).

:func:`attn_delta_trials` is the hook of a batch of trials: every parameter
stacked over a leading trial axis, the block input the trials' batches
folded into one (T*B, N, C), and trial t's H applied to trial t's rows, its
dropout drawn from trial t's generator and its scramble (quirk 4) kept
within trial t's own (B, N, C).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .kron import batched_kron_sum, bmm

PHM_DIM = 32
PHM_RANK = 1
LORA_ATTN_DIM = 4
LORA_ATTN_ALPHA = 128
SCALE = LORA_ATTN_ALPHA / LORA_ATTN_DIM * 5  # = 160
KDROPOUT_P = 0.5


class KAdaptationShared(nn.Module):
    """The phm rules shared by every layer."""

    def __init__(self):
        super().__init__()
        for i in (1, 2):
            setattr(self, f"phm_rule{i}_left", nn.Parameter(torch.zeros(PHM_DIM, PHM_DIM, 1)))
            setattr(self, f"phm_rule{i}_right", nn.Parameter(torch.zeros(PHM_DIM, 1, PHM_DIM)))


class KAdaptationLayer(nn.Module):
    """One layer's factors and bias."""

    def __init__(self, width: int):
        super().__init__()
        d = width // PHM_DIM
        self.q_left = nn.Parameter(torch.zeros(PHM_DIM, d, PHM_RANK))
        self.q_right = nn.Parameter(torch.zeros(PHM_DIM, PHM_RANK, d))
        self.v_left = nn.Parameter(torch.zeros(PHM_DIM, d, PHM_RANK))
        self.v_right = nn.Parameter(torch.zeros(PHM_DIM, PHM_RANK, d))
        self.b = nn.Parameter(torch.zeros(width))


class KAdaptation(nn.Module):
    """Shared rules plus one ``KAdaptationLayer`` per visual layer."""

    def __init__(self, n_layers: int, width: int):
        super().__init__()
        self.shared = KAdaptationShared()
        self.layers = nn.ModuleList(KAdaptationLayer(width) for _ in range(n_layers))


def init_params(generator: torch.Generator, n_layers: int, width: int, *,
                device=None) -> KAdaptation:
    """Rules U(-0.01, 0.01) from ``generator`` (a CPU generator); factors and
    biases zero (quirk 2)."""
    dev = resolve_device(device)
    m = KAdaptation(n_layers, width)
    with torch.no_grad():
        for name in ("phm_rule1_left", "phm_rule1_right", "phm_rule2_left", "phm_rule2_right"):
            p = getattr(m.shared, name)
            p.copy_(torch.rand(p.shape, generator=generator) * 0.02 - 0.01)
    return m.to(dev)


def delta_weights(shared: KAdaptationShared, layer: KAdaptationLayer, *,
                  reference_compat: bool = True):
    """The (C, C) H_q and H_v delta-weight matrices of one layer, (T, C, C)
    for parameters stacked over T trials."""
    rule1 = bmm(shared.phm_rule1_left, shared.phm_rule1_right)
    rule2 = bmm(shared.phm_rule2_left, shared.phm_rule2_right)
    wq = bmm(layer.q_left, layer.q_right)
    h_q = batched_kron_sum(rule1, wq)
    wv = wq if reference_compat else bmm(layer.v_left, layer.v_right)  # quirk 1
    return h_q, batched_kron_sum(rule2, wv)


def attn_delta(
    shared: KAdaptationShared,
    layer: KAdaptationLayer,
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    *,
    n_head: int,
    train: bool = False,
    reference_compat: bool = True,
    dropout_p: float = KDROPOUT_P,
):
    """(q_delta, v_delta) in (B, H, N, hd) layout, float32, for x: (B, N, C).

    ``x @ H`` runs on x's dtype operands with float32 sums and a float32
    result (``x.float() @ H.to(dtype).float()``: the products of two
    low-precision values are exact in float32), as the reference's
    ``preferred_element_type=float32`` product does.  Dropout on H needs
    ``generator`` (on x's device) when ``train`` and ``dropout_p > 0``.
    """
    B, N, C = x.shape
    hd = C // n_head
    h_q, h_v = delta_weights(shared, layer, reference_compat=reference_compat)
    if train and dropout_p > 0:
        keep = 1.0 - dropout_p
        h_q = h_q * (torch.rand(h_q.shape, generator=generator, device=h_q.device) < keep) / keep
        h_v = h_v * (torch.rand(h_v.shape, generator=generator, device=h_v.device) < keep) / keep
    b = layer.b.float()
    x32 = x.float()
    dq = x32 @ h_q.to(x.dtype).float() * SCALE + b
    dv = x32 @ h_v.to(x.dtype).float() * SCALE + b
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


def trial_heads(d: torch.Tensor, batch: int, n_head: int, reference_compat: bool):
    """A (T, B*N, C) delta of T trials of ``batch`` images each in the
    attention's (T*B, H, N, hd) layout: under ``reference_compat`` the
    raw-reshape scramble of quirk 4, (B, N, C) -> (N, B, C) -> (B, H, N, hd)
    within each trial's own rows, never across trials; else the plain
    split into heads."""
    T, BN, C = d.shape
    N, hd = BN // batch, C // n_head
    if reference_compat:
        return d.view(T, batch, N, C).permute(0, 2, 1, 3).flatten().view(
            T * batch, n_head, N, hd)
    return d.view(T * batch, N, n_head, hd).transpose(1, 2)


def attn_delta_trials(
    shared: KAdaptationShared,
    layer: KAdaptationLayer,
    generators,
    x: torch.Tensor,
    *,
    trials: int,
    n_head: int,
    train: bool = False,
    reference_compat: bool = True,
    dropout_p: float = KDROPOUT_P,
):
    """:func:`attn_delta` of ``trials`` trials at once: x (T*B, N, C), every
    parameter stacked (T, ...), ``generators`` one per trial (on x's
    device) for the train-time dropout; returns (T*B, H, N, hd) deltas,
    trial t's rows from trial t's H.  Each generator draws H_q's mask, then
    H_v's, as :func:`attn_delta` draws them from its one generator."""
    TB, N, C = x.shape
    B = TB // trials
    h_q, h_v = delta_weights(shared, layer, reference_compat=reference_compat)
    if train and dropout_p > 0:
        keep = 1.0 - dropout_p
        draw = lambda g: torch.rand((C, C), generator=g, device=h_q.device)
        h_q = h_q * (torch.stack([draw(g) for g in generators]) < keep) / keep
        h_v = h_v * (torch.stack([draw(g) for g in generators]) < keep) / keep
    b = layer.b.float()[:, None, :]
    x32 = x.float().reshape(trials, B * N, C)
    dq = torch.bmm(x32, h_q.to(x.dtype).float()) * SCALE + b
    dv = torch.bmm(x32, h_v.to(x.dtype).float()) * SCALE + b
    return (trial_heads(dq, B, n_head, reference_compat),
            trial_heads(dv, B, n_head, reference_compat))


def num_params(n_layers: int, width: int) -> int:
    d = width // PHM_DIM
    return n_layers * (4 * PHM_DIM * d * PHM_RANK + width) + 4 * PHM_DIM * PHM_DIM
