"""Mask-free attention core for the ViT tower: plain version and CUDA kernel.

Counterpart of ``pevit_tpu/ops/attention.py``.  Semantics contract (as
``core.layers.multi_head_attention`` relies on it): q arrives already scaled
by 1/sqrt(hd) and with any PEFT delta added; logits and softmax run in
float32; the probabilities are rounded to v's type before the product with
v, which accumulates in float32; the output has the input's type.

``attention_core`` is what the tower calls, an autograd Function.  On a CUDA
tensor its forward launches the hand-written kernel (``csrc/attention_fwd.cu``)
or raises; on a CPU tensor it runs the plain version.  There is no fallback
between the two.  Its backward is plain PyTorch on both devices
(:func:`attention_bwd_ref`), as the reference's backward is plain XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

KERNEL = Kernel(
    "attention_fwd",
    "attention_fwd.cu",
    [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _P],
    replaces="pevit_tpu/ops/attention.py:40",
)
HEAD_DIM = 64
MAX_SEQ = 257
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention on (B, H, N, hd) tensors (= the reference's
    ``_xla_attention`` without a mask).  ``q.float() @ k.float()`` gives the
    reference's float32-accumulated logits of low-precision operands."""
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", probs, v)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on (B, N, H, 64) CUDA tensors, which may be strided
    views (e.g. of a packed qkv projection) with unit stride inside a head.
    Returns a contiguous (B, N, H, 64) tensor."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, N, H, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must share a dtype in {list(_DTYPE_CODES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, N, H, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"attention kernel takes head_dim {HEAD_DIM}, got {hd}")
    if not 0 < N <= MAX_SEQ:
        raise ValueError(f"attention kernel takes 1 <= N <= {MAX_SEQ}, got {N}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs unit stride along head_dim")
    out = torch.empty((B, N, H, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPE_CODES[q.dtype], B, H, N, *strides, stream_ptr(q))
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor) -> tuple:
    """Gradients of the attention core on (B, N, H, hd) tensors, in the
    recompute form of the reference's ``_fused_bwd``: p in float32 (not
    rounded), dv = p^T g, dp = g v^T, ds = p (dp - sum(dp p)), dq = ds k and
    dk = ds^T q, each cast to its input's dtype."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.softmax(logits, dim=-1)
    g32 = g.float()
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g32).to(v.dtype)
    dp = torch.einsum("bnhd,bmhd->bhnm", g32, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float()).to(k.dtype)
    return dq, dk, dv


class _AttentionCore(torch.autograd.Function):
    """Forward: the kernel (CUDA) or :func:`attention_ref` (CPU).  Saves only
    q, k and v, as the reference's custom VJP does; the backward recomputes
    the probabilities in plain PyTorch (:func:`attention_bwd_ref`), as the
    reference runs its backward in plain XLA.  Gradients come back in the
    inputs' (B, N, H, hd) layout, and autograd routes them into whatever
    views q, k and v are (k and v are strided views of the packed qkv
    projection)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.is_cuda:
            return attention_fwd(q, k, v)
        t = lambda x: x.transpose(1, 2)
        return t(attention_ref(t(q), t(k), t(v)))

    @staticmethod
    def backward(ctx, g):
        return attention_bwd_ref(*ctx.saved_tensors, g)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mask-free attention on (B, N, H, hd) tensors -> (B, N, H, hd),
    differentiable in q, k and v.

    CUDA tensors go through the kernel (which raises on what it does not
    take); CPU tensors through :func:`attention_ref`."""
    if not q.is_cuda and q.device.type != "cpu":
        raise ValueError(f"attention_core runs on CUDA or CPU tensors, got {q.device}")
    return _AttentionCore.apply(q, k, v)
