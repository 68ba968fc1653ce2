"""Transformer layers of the CLIP towers.

Counterpart of ``pevit_tpu/core/layers.py`` (the reference-shaped path).
Parameters live in small ``nn.Module`` containers; the math is plain
functions on tensors.  Weight convention, as in the reference: every linear
kernel is stored ``(in_features, out_features)``, so a layer is ``x @ W``;
``in_proj`` packs ``[q | k | v]`` along its output columns and each of them
splits its C columns head-major into ``(H, hd)``.

Numerics kept from the reference: LayerNorm statistics in float32 with the
result cast back to the activation dtype; QuickGELU; softmax in float32; q
scaled by 1/sqrt(hd) BEFORE the PEFT delta is added.

Attention with a mask (the text tower's causal mask) is plain PyTorch, as in
the reference (``pevit_tpu/core/layers.py:229-233``, plain XLA there); only
mask-free attention goes through the attention kernel, which takes no mask.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.attention import attention_core
from ..ops.fused_mlp import fused_mlp_residual


class LayerNorm(nn.Module):
    """LayerNorm parameters (float32 scale and bias)."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))


class Dense(nn.Module):
    """Linear parameters: kernel ``(in, out)`` and bias ``(out,)``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))


class ListModule(nn.ModuleList):
    """A ModuleList that the reference's tree holds as a Python list (Swin's
    stages and their blocks), not stacked on a layer axis; the bridge
    carries it as a list."""


class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Dense(width, 4 * width)
        self.c_proj = Dense(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    """Parameters of one CLIP block; see :func:`residual_attention_block`."""

    def __init__(self, width: int):
        super().__init__()
        self.attn = Attention(width)
        self.mlp = MLP(width)
        self.ln_1 = LayerNorm(width)
        self.ln_2 = LayerNorm(width)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """float32-island LayerNorm; returns x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation, ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """The BERT/GPT tanh-approximate GELU of Compacter's adapters, written
    out as the reference writes it (``pevit_tpu/core/layers.py:117-120``) so
    that it rounds the same way."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU of timm's ViTs (the auxiliary backbones' activation;
    ``pevit_tpu/core/layers.py:130``)."""
    return torch.nn.functional.gelu(x, approximate="none")


def linear(x: torch.Tensor, p: Dense) -> torch.Tensor:
    """``x @ W + b`` with W and b cast to x's dtype."""
    return x @ p.kernel.to(x.dtype) + p.bias.to(x.dtype)


def mlp(p: MLP, x: torch.Tensor, act: Optional[Callable] = None) -> torch.Tensor:
    """c_fc (C -> 4C) -> ``act`` (QuickGELU when None) -> c_proj (4C -> C)."""
    return linear((act or quick_gelu)(linear(x, p.c_fc)), p.c_proj)


DeltaFn = Callable[[torch.Tensor], tuple]


def causal_mask(n: int, *, device=None) -> torch.Tensor:
    """Additive causal mask, -inf above the diagonal (reference
    model.py:1139-1145)."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T + mask) v on (B, N, H, hd): float32 logits, the mask
    added, softmax, the probabilities cast to v's dtype before the product."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def multi_head_attention(p: Attention, x: torch.Tensor, *, n_head: int,
                         mask: Optional[torch.Tensor] = None,
                         qv_delta_fn: Optional[DeltaFn] = None) -> torch.Tensor:
    """Self-attention over x: (B, N, C), with an additive (N, N) ``mask`` or
    none.

    ``qv_delta_fn(x)`` receives the LN'd block input and returns per-head
    (B, H, N, hd) deltas for q and v (either may be None); the q delta is
    added after q is scaled.  q, k and v stay (B, N, H, hd) views of the
    packed projection where no delta is added, and the attention core takes
    them as they are.
    """
    B, N, C = x.shape
    hd = C // n_head
    q, k, v = linear(x, p.in_proj).split(C, dim=-1)
    q = q.reshape(B, N, n_head, hd) * (1.0 / math.sqrt(hd))
    k = k.reshape(B, N, n_head, hd)
    v = v.reshape(B, N, n_head, hd)
    if qv_delta_fn is not None:
        q_delta, v_delta = qv_delta_fn(x)
        if q_delta is not None:
            q = q + q_delta.transpose(1, 2).to(q.dtype)
        if v_delta is not None:
            v = v + v_delta.transpose(1, 2).to(v.dtype)
    out = attention_core(q, k, v) if mask is None else masked_attention(q, k, v, mask)
    return linear(out.reshape(B, N, C), p.out_proj)


def residual_attention_block(p: ResidualAttentionBlock, x: torch.Tensor, *, n_head: int,
                             mask: Optional[torch.Tensor] = None,
                             qv_delta_fn: Optional[DeltaFn] = None,
                             mlp_post_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                             use_fused_mlp: bool = True,
                             act: Optional[Callable] = None,
                             ln_eps: float = 1e-5) -> torch.Tensor:
    """One CLIP block: x + attn(LN1(x)), then LN2 -> c_fc -> QuickGELU ->
    c_proj -> + residual, with ``ln_eps`` for both LayerNorms and an
    additive attention ``mask`` or none.

    ``mlp_post_fn`` (the bottleneck adapter's and Compacter's hook) takes
    the bare MLP output ``m`` and returns what is added to the residual in
    its place, ``x + mlp_post_fn(m)``.

    ``use_fused_mlp`` routes the MLP half through the fused residual MLP,
    whose backward gives dx only: valid only while the MLP and LN2 weights
    are frozen (it raises otherwise), and never taken with ``mlp_post_fn``,
    which needs ``m`` that the fused kernel never writes.  Otherwise the
    block takes the unfused ``layer_norm`` + ``mlp`` path, differentiable in
    every weight.  GEMM weights are cast to the compute dtype; the LN
    parameters stay float32.

    ``act`` replaces QuickGELU (the timm ViTs pass :func:`gelu_exact`).  The
    fused kernel computes QuickGELU only, so a block given ``act`` always
    takes the unfused MLP, whatever ``use_fused_mlp`` says, as the
    reference's block does (``pevit_tpu/core/layers.py:274``)."""
    h = layer_norm(x, p.ln_1.scale, p.ln_1.bias, eps=ln_eps)
    x = x + multi_head_attention(p.attn, h, n_head=n_head, mask=mask, qv_delta_fn=qv_delta_fn)
    if not use_fused_mlp or mlp_post_fn is not None or act is not None:
        m = mlp(p.mlp, layer_norm(x, p.ln_2.scale, p.ln_2.bias, eps=ln_eps), act=act)
        return x + (m if mlp_post_fn is None else mlp_post_fn(m))
    dt = x.dtype
    return fused_mlp_residual(
        x, p.ln_2.scale, p.ln_2.bias,
        p.mlp.c_fc.kernel.to(dt), p.mlp.c_fc.bias.to(dt),
        p.mlp.c_proj.kernel.to(dt), p.mlp.c_proj.bias.to(dt),
        eps=ln_eps,
    )
