"""Fused residual MLP: x + c_proj(QuickGELU(c_fc(LayerNorm(x)))).

Counterpart of ``pevit_tpu/ops/fused_mlp.py`` (forward only; the backward
comes with the training slice).  Rounding points, which the plain version
and the kernel share with the reference kernel: LayerNorm statistics and
affine in float32, u rounded to x's type; h in float32 plus bfc widened from
the compute type; QuickGELU in float32, g rounded to x's type; m in float32
plus bproj, rounded to x's type and added to x in x's type.  ``eps`` is an
argument here (the reference kernel fixes it at 1e-5).

``fused_mlp_residual`` launches the hand-written kernel
(``csrc/fused_mlp_fwd.cu``) on CUDA tensors, or raises; on CPU tensors it
runs the plain version.
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
WIDTHS = (256, 512, 768, 1024)
HIDDEN_MULTIPLE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def fused_mlp_fwd(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """The CUDA kernel.  x: contiguous (..., C) in float32 or bfloat16; wfc
    (C, F), bfc (F,), wproj (F, C), bproj (C,) in x's dtype; ln scale and
    bias float32 (C,).  C in ``WIDTHS``, F a multiple of 128."""
    tensors = (x, ln_scale, ln_bias, wfc, bfc, wproj, bproj)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_mlp_fwd takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_mlp_fwd takes {list(_DTYPE_CODES)}, got {x.dtype}")
    if any(t.dtype != x.dtype for t in (wfc, bfc, wproj, bproj)):
        raise ValueError("wfc, bfc, wproj, bproj must have x's dtype")
    if ln_scale.dtype != torch.float32 or ln_bias.dtype != torch.float32:
        raise ValueError("ln scale and bias must be float32")
    C = x.shape[-1]
    F = wfc.shape[-1]
    if C not in WIDTHS:
        raise ValueError(f"fused MLP kernel takes C in {WIDTHS}, got {C}")
    if F % HIDDEN_MULTIPLE:
        raise ValueError(f"fused MLP kernel takes F a multiple of {HIDDEN_MULTIPLE}, got {F}")
    shapes = {"wfc": (C, F), "bfc": (F,), "wproj": (F, C), "bproj": (C,),
              "ln_scale": (C,), "ln_bias": (C,)}
    for name, t in zip(("ln_scale", "ln_bias", "wfc", "bfc", "wproj", "bproj"), tensors[1:]):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp_fwd takes contiguous tensors")
    R = x.numel() // C
    y = torch.empty_like(x)
    KERNEL.launch(*(t.data_ptr() for t in tensors), y.data_ptr(), _DTYPE_CODES[x.dtype],
                  R, C, F, float(eps), stream_ptr(x))
    return y


def fused_mlp_residual(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """x: (B, N, C) -> x + MLP(LN(x)).  The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if x.is_cuda:
        return fused_mlp_fwd(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps)
    if x.device.type != "cpu":
        raise ValueError(f"fused_mlp_residual runs on CUDA or CPU tensors, got {x.device}")
    return fused_mlp_residual_ref(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps)
