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

A tower stacked over a batch of trials (``trial_axis``) holds every weight
(T, ...) and runs on the trials' folded (T*B, ...) rows: ``linear`` and
``layer_norm`` apply trial t's weights to trial t's rows, and the attention
core, which has no weights, runs once on them all.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.attention import attention_core
from ..ops.fused_mlp import fused_mlp_residual
from . import trial_axis


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


class ShardedAttention(nn.Module):
    """A frozen attention's share on one rank of a model axis (tensor
    parallelism, ``parallel.mesh.shard_params``): ``in_proj`` holds the q,
    k and v columns of the rank's ``heads`` (column-parallel by heads, so
    the attention kernel runs on whole heads), ``out_proj`` the matching
    rows of the output projection (row-parallel) and its whole bias,
    added once after the partial products are summed over ``axis``."""

    def __init__(self, attn: Attention, n_head: int, axis):
        super().__init__()
        C = attn.out_proj.kernel.shape[0]
        n, i = axis.size, axis.index
        if n_head % n:
            raise ValueError(f"{n_head} heads do not cut into {n} model ranks")
        hc = C // n
        cols = torch.cat([torch.arange(j * C + i * hc, j * C + (i + 1) * hc) for j in range(3)])
        w = attn.in_proj
        self.in_proj = Dense(C, 3 * hc)
        self.out_proj = Dense(hc, C)
        with torch.no_grad():
            self.in_proj.kernel = nn.Parameter(w.kernel.detach()[:, cols.to(w.kernel.device)]
                                               .clone(), requires_grad=False)
            self.in_proj.bias = nn.Parameter(w.bias.detach()[cols.to(w.bias.device)].clone(),
                                             requires_grad=False)
            self.out_proj.kernel = nn.Parameter(
                attn.out_proj.kernel.detach()[i * hc:(i + 1) * hc].clone(), requires_grad=False)
            self.out_proj.bias = attn.out_proj.bias
        self.axis = axis
        self.heads = (i * n_head // n, (i + 1) * n_head // n)


class ShardedMLP(nn.Module):
    """A frozen MLP's share on one rank of a model axis: ``c_fc``'s columns
    and bias slice, ``c_proj``'s rows (column / row-parallel, as the
    reference's specs) and ``c_proj``'s whole bias.  The fused MLP kernels
    add the residual and ``c_proj``'s bias inside, so a partial sum cannot
    run through them: :meth:`gathered` all-gathers the slices over
    ``axis`` and the block runs the kernels on the whole weights."""

    def __init__(self, mlp: MLP, axis):
        super().__init__()
        F = mlp.c_fc.kernel.shape[1]
        n, i = axis.size, axis.index
        f = F // n
        self.c_fc = Dense(mlp.c_fc.kernel.shape[0], f)
        self.c_proj = Dense(f, mlp.c_proj.kernel.shape[1])
        with torch.no_grad():
            self.c_fc.kernel = nn.Parameter(mlp.c_fc.kernel.detach()[:, i * f:(i + 1) * f].clone(),
                                            requires_grad=False)
            self.c_fc.bias = nn.Parameter(mlp.c_fc.bias.detach()[i * f:(i + 1) * f].clone(),
                                          requires_grad=False)
            self.c_proj.kernel = nn.Parameter(mlp.c_proj.kernel.detach()[i * f:(i + 1) * f].clone(),
                                              requires_grad=False)
            self.c_proj.bias = mlp.c_proj.bias
        self.axis = axis

    def gathered(self):
        """The whole MLP's weights (``c_fc`` / ``c_proj``, each a ``kernel``
        and ``bias``), the slices gathered over the model axis."""
        from types import SimpleNamespace

        from ..parallel.collectives import gather_dim

        return SimpleNamespace(
            c_fc=SimpleNamespace(kernel=gather_dim(self.c_fc.kernel, self.axis, 1),
                                 bias=gather_dim(self.c_fc.bias, self.axis, 0)),
            c_proj=SimpleNamespace(kernel=gather_dim(self.c_proj.kernel, self.axis, 0),
                                   bias=self.c_proj.bias))


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
    """float32-island LayerNorm; returns x's dtype.  A stacked (T, C) scale
    and bias apply trial by trial to x's (T*B, ..., C) rows."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = trial_axis.add(trial_axis.mul(y, scale.float(), 1), bias.float(), 1)
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
    """``x @ W + b`` with W and b cast to x's dtype; a stacked (T, in, out)
    W and (T, out) b apply trial by trial to x's (T*B, ..., in) rows."""
    return trial_axis.add(trial_axis.matmul(x, p.kernel.to(x.dtype)), p.bias.to(x.dtype), 1)


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
    if isinstance(p, ShardedAttention):
        return _sharded_attention(p, x, n_head=n_head, mask=mask, qv_delta_fn=qv_delta_fn)
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


def _sharded_attention(p: ShardedAttention, x: torch.Tensor, *, n_head: int,
                       mask: Optional[torch.Tensor], qv_delta_fn: Optional[DeltaFn]) -> torch.Tensor:
    """:func:`multi_head_attention` on one rank of a model axis: the
    attention of its heads, the out-projection's partial product summed over
    the axis, then its bias.  The input enters through Megatron's f (the
    backward sums the ranks' shares of its gradient); the PEFT delta is
    computed whole on every rank (the scramble of quirk 4 mixes heads) and
    the rank's heads kept."""
    from ..parallel.collectives import copy_to, reduce_from

    B, N, C = x.shape
    hd = C // n_head
    h0, h1 = p.heads
    x = copy_to(x, p.axis)
    q, k, v = linear(x, p.in_proj).split((h1 - h0) * hd, dim=-1)
    q = q.reshape(B, N, h1 - h0, hd) * (1.0 / math.sqrt(hd))
    k = k.reshape(B, N, h1 - h0, hd)
    v = v.reshape(B, N, h1 - h0, hd)
    if qv_delta_fn is not None:
        q_delta, v_delta = qv_delta_fn(x)
        if q_delta is not None:
            q = q + q_delta[:, h0:h1].transpose(1, 2).to(q.dtype)
        if v_delta is not None:
            v = v + v_delta[:, h0:h1].transpose(1, 2).to(v.dtype)
    out = attention_core(q, k, v) if mask is None else masked_attention(q, k, v, mask)
    y = out.reshape(B, N, (h1 - h0) * hd) @ p.out_proj.kernel.to(x.dtype)
    return reduce_from(y, p.axis) + p.out_proj.bias.to(x.dtype)


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
    reference's block does (``pevit_tpu/core/layers.py:274``).

    A block of a stacked tower (its weights (T, ...), x the trials' folded
    rows) trains its MLP weights, so it takes the unfused MLP; the fused
    route raises for it."""
    h = layer_norm(x, p.ln_1.scale, p.ln_1.bias, eps=ln_eps)
    x = x + multi_head_attention(p.attn, h, n_head=n_head, mask=mask, qv_delta_fn=qv_delta_fn)
    mlp_p = p.mlp.gathered() if isinstance(p.mlp, ShardedMLP) else p.mlp
    if not use_fused_mlp or mlp_post_fn is not None or act is not None:
        m = mlp(mlp_p, layer_norm(x, p.ln_2.scale, p.ln_2.bias, eps=ln_eps), act=act)
        return x + (m if mlp_post_fn is None else mlp_post_fn(m))
    if trial_axis.stacked(mlp_p.c_fc.kernel, 2):
        raise ValueError("the fused MLP takes one frozen tower's weights; a tower stacked "
                         "over trials trains them and takes the unfused MLP")
    dt = x.dtype
    return fused_mlp_residual(
        x, p.ln_2.scale, p.ln_2.bias,
        mlp_p.c_fc.kernel.to(dt), mlp_p.c_fc.bias.to(dt),
        mlp_p.c_proj.kernel.to(dt), mlp_p.c_proj.bias.to(dt),
        eps=ln_eps,
    )
