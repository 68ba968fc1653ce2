"""Fused residual MLP: x + c_proj(QuickGELU(c_fc(LayerNorm(x)))), with its
backward.

Counterpart of ``pevit_tpu/ops/fused_mlp.py``.  Forward rounding points,
which the plain version and the kernel share with the reference kernel:
LayerNorm statistics and affine in float32, u rounded to x's type; h in
float32 plus bfc widened from the compute type; QuickGELU in float32, g
rounded to x's type; m in float32 plus bproj, rounded to x's type and added
to x in x's type.  The backward recomputes the chain from x and gives the
gradient of x only (see :func:`fused_mlp_bwd_ref` for its rounding points).
``eps`` is an argument here (the reference kernels fix it at 1e-5).

``fused_mlp_residual`` is an autograd Function: on CUDA tensors its forward
launches ``csrc/fused_mlp_fwd.cu`` and its backward ``csrc/fused_mlp_bwd.cu``
(or raises); on CPU tensors both run the plain versions.  Frozen-weight
contract: the reference's VJP returns zeros for the LayerNorm parameters and
the MLP weights and biases; here the backward raises if any of them requires
a gradient, so a weight meant to train can never get a silent None.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = Kernel(
    "fused_mlp_fwd",
    "fused_mlp_fwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    replaces="pevit_tpu/ops/fused_mlp.py:63",
)
BWD_KERNEL = Kernel(
    "fused_mlp_bwd",
    "fused_mlp_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    replaces="pevit_tpu/ops/fused_mlp.py:122",
)
WIDTHS = (256, 512, 768, 1024)
HIDDEN_MULTIPLE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHTS = ("ln_scale", "ln_bias", "wfc", "bfc", "wproj", "bproj")


def fused_mlp_residual_ref(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """Plain version with the kernel's cast order; x: (..., C)."""
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    xhat = (x32 - mean) * torch.rsqrt(var + eps)
    u = (xhat * ln_scale.float() + ln_bias.float()).to(dt)
    h = u.float() @ wfc.float() + bfc.float()
    g = (h * torch.sigmoid(1.702 * h)).to(dt)
    m = g.float() @ wproj.float() + bproj.float()
    return x + m.to(dt)


def fused_mlp_bwd_ref(dy, x, ln_scale, ln_bias, wfc, bfc, wproj, eps: float = 1e-5):
    """Plain gradient of :func:`fused_mlp_residual_ref` with respect to x,
    with the reference kernel's rounding points (T = dy's type): u rounded
    to T; h, the QuickGELU derivative and dg = dy . Wproj^T in float32;
    dh rounded to T; du = dh . Wfc^T and the LayerNorm backward in float32;
    the result rounded to T and added to dy in T."""
    dt = dy.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    scale = ln_scale.float()
    u = (xhat * scale + ln_bias.float()).to(dt)
    h = u.float() @ wfc.float() + bfc.float()
    sig = torch.sigmoid(1.702 * h)
    dgelu = sig * (1.0 + 1.702 * h * (1.0 - sig))
    dg = dy.float() @ wproj.float().T
    dh = (dg * dgelu).to(dt)
    du = dh.float() @ wfc.float().T
    dxhat = du * scale
    mdx = dxhat.mean(-1, keepdim=True)
    mdxx = (dxhat * xhat).mean(-1, keepdim=True)
    dx_ln = (dxhat - mdx - xhat * mdxx) * rstd
    return dx_ln.to(dt) + dy


def _check(name, x, weights: dict) -> tuple:
    """Device, dtype, shape and layout checks shared by both launchers;
    returns (R, C, F)."""
    tensors = (x, *weights.values())
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes {list(_DTYPE_CODES)}, got {x.dtype}")
    if any(t.dtype != x.dtype for n, t in weights.items() if not n.startswith("ln")):
        raise ValueError("wfc, bfc, wproj, bproj must have x's dtype")
    if weights["ln_scale"].dtype != torch.float32 or weights["ln_bias"].dtype != torch.float32:
        raise ValueError("ln scale and bias must be float32")
    C = x.shape[-1]
    F = weights["wfc"].shape[-1]
    if C not in WIDTHS:
        raise ValueError(f"fused MLP kernel takes C in {WIDTHS}, got {C}")
    if F % HIDDEN_MULTIPLE:
        raise ValueError(f"fused MLP kernel takes F a multiple of {HIDDEN_MULTIPLE}, got {F}")
    shapes = {"wfc": (C, F), "bfc": (F,), "wproj": (F, C), "bproj": (C,),
              "ln_scale": (C,), "ln_bias": (C,)}
    for n, t in weights.items():
        if tuple(t.shape) != shapes[n]:
            raise ValueError(f"{n} must be {shapes[n]}, got {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return x.numel() // C, C, F


def fused_mlp_fwd(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """The forward CUDA kernel.  x: contiguous (..., C) in float32 or
    bfloat16; wfc (C, F), bfc (F,), wproj (F, C), bproj (C,) in x's dtype;
    ln scale and bias float32 (C,).  C in ``WIDTHS``, F a multiple of 128."""
    weights = dict(zip(_WEIGHTS, (ln_scale, ln_bias, wfc, bfc, wproj, bproj)))
    R, C, F = _check("fused_mlp_fwd", x, weights)
    y = torch.empty_like(x)
    KERNEL.launch(x.data_ptr(), *(t.data_ptr() for t in weights.values()), y.data_ptr(),
                  _DTYPE_CODES[x.dtype], R, C, F, float(eps), stream_ptr(x))
    return y


def fused_mlp_bwd(dy, x, ln_scale, ln_bias, wfc, bfc, wproj, eps: float = 1e-5):
    """The backward CUDA kernel: dx of the fused residual MLP.  dy and x:
    contiguous (..., C) of one shape and dtype; the weights as for
    :func:`fused_mlp_fwd` (no bproj).  Two (F, C)-sized scratch buffers hold
    the kernel's transposed weight copies."""
    weights = dict(zip(_WEIGHTS[:5], (ln_scale, ln_bias, wfc, bfc, wproj)))
    R, C, F = _check("fused_mlp_bwd", x, weights)
    if not (dy.is_cuda and dy.device == x.device and dy.is_contiguous()):
        raise ValueError("fused_mlp_bwd takes contiguous CUDA tensors on one device")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    dx = torch.empty_like(x)
    wfc_t = torch.empty((F, C), dtype=x.dtype, device=x.device)
    wproj_t = torch.empty((C, F), dtype=x.dtype, device=x.device)
    BWD_KERNEL.launch(dy.data_ptr(), x.data_ptr(), *(t.data_ptr() for t in weights.values()),
                      wfc_t.data_ptr(), wproj_t.data_ptr(), dx.data_ptr(),
                      _DTYPE_CODES[x.dtype], R, C, F, float(eps), stream_ptr(x))
    return dx


class _FusedMlpResidual(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Saves x and
    the weights the backward reads (of the activations, x only).  Backward:
    dx by the kernel (CUDA) or :func:`fused_mlp_bwd_ref` (CPU)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_scale, ln_bias, wfc, bfc, wproj)
        fwd = fused_mlp_fwd if x.is_cuda else fused_mlp_residual_ref
        return fwd(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps)

    @staticmethod
    def backward(ctx, dy):
        wanted = [n for n, need in zip(_WEIGHTS, ctx.needs_input_grad[1:7]) if need]
        if wanted:
            raise RuntimeError(
                f"fused_mlp_residual gives the gradient of x only, but {wanted} require grad; "
                "freeze them (requires_grad_(False)) or take the unfused route")
        x, *weights = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = fused_mlp_bwd if dy.is_cuda else fused_mlp_bwd_ref
        return (bwd(dy, x, *weights, ctx.eps),) + (None,) * 7


def fused_mlp_residual(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """x: (B, N, C) -> x + MLP(LN(x)), differentiable in x only.  The
    kernels on CUDA tensors, the plain versions on CPU tensors."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"fused_mlp_residual runs on CUDA or CPU tensors, got {x.device}")
    return _FusedMlpResidual.apply(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps)
