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

``fused_mlp_residual`` is an autograd Function over two registered
operators: ``pevit_tpu_torch::fused_mlp_fwd`` and, for its backward,
``pevit_tpu_torch::fused_mlp_bwd``.  Each chooses by its tensors' device
when it runs: on CUDA the forward launches ``csrc/fused_mlp_fwd.cu`` and the
backward ``csrc/fused_mlp_bwd.cu`` (or raises); on the CPU both run the
plain versions; any other device raises.  So a ``torch.export`` graph holds
the operator node and runs the kernel on whichever device it is given.
Both operators have fake versions for tracing and FLOP formulas that count
the reference's plain products.  Frozen-weight contract: the reference's
VJP returns zeros for the LayerNorm parameters and the MLP weights and
biases; here the backward raises if any of them requires a gradient, so a
weight meant to train can never get a silent None.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from ._build import Kernel, KernelInputError, device_kind, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = Kernel(
    "fused_mlp_fwd",
    "fused_mlp_fwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    replaces="pevit_tpu/ops/fused_mlp.py:63",
)
BWD_KERNEL = Kernel(
    "fused_mlp_bwd",
    "fused_mlp_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    replaces="pevit_tpu/ops/fused_mlp.py:122",
)
# Both kernels take any C and F (the reference's Pallas kernels pad only
# the rows): their GEMMs zero-fill the tails of the last tiles, and they
# copy 16-byte chunks of rows, so C and F must fill whole chunks; the
# wrappers zero-pad any other width (``padded_widths``), and the kernels'
# LayerNorm counts the caller's C.  A launch takes at most 65535 tiles of
# 128 rows (a larger batch is split by its caller): the persistent GEMMs
# count their tiles in a 32-bit int; their index products (row x C, row x
# F, in elements and bytes) are 64-bit, so R x F may pass 2^31 (a chunk of
# 16 trials' 512-image eval chunks on ViT-L/14 is R = 2,105,344 rows, R x F
# = 8.6e9).
MAX_ROWS = 65535 * 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The GEMM core of both bodies (csrc/wgmma_gemm.cuh, ``gemm_persistent``), as
# the sources set it (tests/test_torch_mlp_tma.py holds these to the
# sources): output tiles of GEMM_ROWS rows, K in ring stages of one
# 128-byte row, GEMM_K bf16 or GEMM_K_F32 float32 values, as many stages as
# a block's shared memory holds but at most GEMM_MAX_STAGES; a producer
# warpgroup and GEMM_CONSUMERS consumer warpgroups at setmaxnreg's register
# counts, which take the tiles of a block in turn; one block an SM, walking
# the tiles in row-major order.  GEMM_PRODUCTS (bf16) and
# GEMM_PRODUCTS_F32 (float32): each product's tile width (the sources'
# FC_TILE_N, PROJ_TILE_N, DH_TILE_N, DU_TILE_N, and FC_F32_TILE_N, ...),
# its products a tile (the dh pair's two), whether B is read MN-major (the
# weights as they lie) or K-major, and the bytes of an output value its
# epilogue stages (bf16, or float32).  The float32 path reads B as two
# K-major planes (GEMM_F32_PLANES: the weights' TF32 hi and lo parts); both
# its consumers take every tile, a 64-row half each, and each holds,
# beside its accumulators, GEMM_F32_PARTIALS partial sums of a k-step in
# flight (GEMM_F32_PAIR_PARTIALS for the dh pair's two products), and
# takes GEMM_F32_CHUNK ring entries a turn of its loop.
GEMM_ROWS = 128
GEMM_K = 64
GEMM_K_F32 = 32
GEMM_CONSUMERS = 2
GEMM_PRODUCER_REGS = 40
GEMM_CONSUMER_REGS = 232
GEMM_MAX_STAGES = 8
GEMM_PRODUCTS = {"fc": (128, 1, True, 2), "proj": (128, 1, True, 2), "dh": (64, 2, False, 2),
                 "du": (128, 1, False, 4)}
GEMM_PRODUCTS_F32 = {"fc": (64, 1, False, 4), "proj": (64, 1, False, 4),
                     "dh": (64, 2, False, 4), "du": (64, 1, False, 4)}
GEMM_F32_PLANES = 2
GEMM_F32_PARTIALS = 3
GEMM_F32_PAIR_PARTIALS = 2
GEMM_F32_CHUNK = 8

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
        raise KernelInputError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES:
        raise KernelInputError(f"{name} takes {list(_DTYPE_CODES)}, got {x.dtype}")
    if any(t.dtype != x.dtype for n, t in weights.items() if not n.startswith("ln")):
        raise KernelInputError("wfc, bfc, wproj, bproj must have x's dtype")
    if weights["ln_scale"].dtype != torch.float32 or weights["ln_bias"].dtype != torch.float32:
        raise KernelInputError("ln scale and bias must be float32")
    C = x.shape[-1]
    F = weights["wfc"].shape[-1]
    if C < 1 or F < 1:
        raise KernelInputError(f"{name} takes C, F >= 1, got C={C}, F={F}")
    shapes = {"wfc": (C, F), "bfc": (F,), "wproj": (F, C), "bproj": (C,),
              "ln_scale": (C,), "ln_bias": (C,)}
    for n, t in weights.items():
        if tuple(t.shape) != shapes[n]:
            raise KernelInputError(f"{n} must be {shapes[n]}, got {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise KernelInputError(f"{name} takes contiguous tensors")
    R = x.numel() // C
    check_rows(name, R)
    return R, C, F


def check_rows(name: str, R: int) -> None:
    """The row count a launch can take: at most ``MAX_ROWS``, the grid's
    limit (a larger batch is split by its caller)."""
    if R > MAX_ROWS:
        raise KernelInputError(f"{name} takes at most {MAX_ROWS} rows (65535 row tiles of 128), "
                               f"got {R}")


def padded_widths(dtype, C: int, F: int) -> tuple:
    """(C, F) each rounded up to whole 16-byte rows of ``dtype``: the
    widths a launch runs at.  The wrappers zero-pad x (and dy), the weights
    and the LayerNorm's scale and bias to them where they differ."""
    chunk = 4 if dtype == torch.float32 else 8  # elements in 16 bytes
    return -(-C // chunk) * chunk, -(-F // chunk) * chunk


def _layout(regions) -> list:
    """[(name, offset, bytes)]: the regions in order, each starting at the
    next multiple of 16 bytes after the last, as the kernels' ``Scratch``
    carves them."""
    out, at = [], 0
    for name, nbytes in regions:
        out.append((name, at, nbytes))
        at += -(-nbytes // 16) * 16
    return out


def _total(layout) -> int:
    _, offset, nbytes = layout[-1]
    return offset + -(-nbytes // 16) * 16


def fwd_workspace_layout(dtype, R: int, C: int, F: int) -> list:
    """The forward launch's scratch as ``csrc/fused_mlp_fwd.cu`` carves it:
    u (R x C) and then g (R x F), in x's dtype (float32 or bf16), and in
    float32 then the weights' TF32 planes, K-major: Wfc^T's hi and lo (F x
    C) and Wproj^T's (C x F); each region 16-byte aligned."""
    size = 4 if dtype == torch.float32 else 2
    regions = [("u", R * C * size), ("g", R * F * size)]
    if dtype == torch.float32:
        regions += [(name, C * F * 4) for name in ("wfc_t_hi", "wfc_t_lo", "wproj_t_hi",
                                                    "wproj_t_lo")]
    return _layout(regions)


def fwd_workspace_bytes(dtype, R: int, C: int, F: int) -> int:
    """Bytes of :func:`fwd_workspace_layout`."""
    return _total(fwd_workspace_layout(dtype, R, C, F))


def _check_aligned(name, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise KernelInputError(f"the {name} copies 16-byte chunks: both weight matrices, and "
                               "its activations (the forward's in bfloat16 only), need 16-byte "
                               "aligned base pointers")


def _padded(rows: tuple, weights: dict, C: int, F: int, Cp: int, Fp: int) -> tuple:
    """``rows`` (each (R, C)) and ``weights`` zero-padded to the widths (Cp,
    Fp): every padded row and column is zero, so every padded unit computes
    zero, and the LayerNorm, which counts C, sees the caller's rows."""
    pad = torch.nn.functional.pad
    dc, df = Cp - C, Fp - F
    cols = {"ln_scale": (0, dc), "ln_bias": (0, dc), "bfc": (0, df), "bproj": (0, dc),
            "wfc": (0, df, 0, dc), "wproj": (0, dc, 0, df)}
    return (tuple(pad(t, (0, dc)) for t in rows),
            {n: pad(t, cols[n]) for n, t in weights.items()})


def fused_mlp_fwd(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """The forward CUDA kernel.  x: contiguous (..., C) in float32 or
    bfloat16; wfc (C, F), bfc (F,), wproj (F, C), bproj (C,) in x's dtype;
    ln scale and bias float32 (C,); any C, F >= 1 (widths that do not fill
    whole 16-byte rows run zero-padded, :func:`padded_widths`).  The dtype
    picks the kernel's body; both run their GEMMs on the tensor cores,
    float32 by a three-product TF32 split that keeps float32 accuracy, and
    both need 16-byte aligned wfc and wproj (bfloat16 x too).  The scratch
    (:func:`fwd_workspace_bytes`) is allocated here."""
    weights = dict(zip(_WEIGHTS, (ln_scale, ln_bias, wfc, bfc, wproj, bproj)))
    R, C, F = _check("fused_mlp_fwd", x, weights)
    Cp, Fp = padded_widths(x.dtype, C, F)
    xk = x
    if (Cp, Fp) != (C, F):
        (xk,), weights = _padded((x.reshape(R, C),), weights, C, F, Cp, Fp)
    _check_aligned("fused MLP forward", weights["wfc"], weights["wproj"],
                   *((xk,) if x.dtype == torch.bfloat16 else ()))
    y = torch.empty_like(xk)
    work = torch.empty(fwd_workspace_bytes(x.dtype, R, Cp, Fp), dtype=torch.uint8,
                       device=x.device)
    KERNEL.launch(xk.data_ptr(), *(t.data_ptr() for t in weights.values()), work.data_ptr(),
                  y.data_ptr(), _DTYPE_CODES[x.dtype], R, Cp, Fp, C, float(eps), stream_ptr(x))
    return y if Cp == C else y[:, :C].reshape(x.shape)


def bwd_workspace_layout(dtype, R: int, C: int, F: int) -> list:
    """The backward launch's scratch as ``csrc/fused_mlp_bwd.cu`` carves it,
    each region 16-byte aligned.  float32: the weights' TF32 planes, K-major
    (the hi and lo parts of Wfc^T, of Wproj and of Wfc), u, dh and du, all
    float32, and (mean, rstd) per row (~175 MB at R = 6400, C = 768, F =
    3072).  bfloat16: Wfc^T, u and dh (bf16), du (float32) and (mean, rstd)
    per row."""
    if dtype == torch.float32:
        planes = [(name, F * C * 4) for name in ("wfc_t_hi", "wfc_t_lo", "wproj_hi", "wproj_lo",
                                                  "wfc_hi", "wfc_lo")]
        return _layout(planes + [("u", R * C * 4), ("dh", R * F * 4), ("du", R * C * 4),
                                 ("stats", R * 8)])
    return _layout([("wfc_t", F * C * 2), ("u", R * C * 2), ("dh", R * F * 2),
                    ("du", R * C * 4), ("stats", R * 8)])


def bwd_workspace_bytes(dtype, R: int, C: int, F: int) -> int:
    """Bytes of :func:`bwd_workspace_layout`."""
    return _total(bwd_workspace_layout(dtype, R, C, F))


def fused_mlp_bwd(dy, x, ln_scale, ln_bias, wfc, bfc, wproj, eps: float = 1e-5):
    """The backward CUDA kernel: dx of the fused residual MLP.  dy and x:
    contiguous (..., C) of one shape and dtype; the weights as for
    :func:`fused_mlp_fwd` (no bproj), any C and F as there.  The dtype
    picks the kernel's body; both run their GEMMs on the tensor cores,
    float32 by a three-product TF32 split that keeps float32 accuracy, and
    both need 16-byte aligned dy, x, wfc and wproj.  The scratch
    (:func:`bwd_workspace_bytes`) is allocated here."""
    weights = dict(zip(_WEIGHTS[:5], (ln_scale, ln_bias, wfc, bfc, wproj)))
    R, C, F = _check("fused_mlp_bwd", x, weights)
    if not (dy.is_cuda and dy.device == x.device and dy.is_contiguous()):
        raise KernelInputError("fused_mlp_bwd takes contiguous CUDA tensors on one device")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise KernelInputError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                               f"{tuple(x.shape)} {x.dtype}")
    Cp, Fp = padded_widths(x.dtype, C, F)
    dyk, xk = dy, x
    if (Cp, Fp) != (C, F):
        (dyk, xk), weights = _padded((dy.reshape(R, C), x.reshape(R, C)), weights, C, F, Cp, Fp)
    _check_aligned("fused MLP backward", dyk, xk, weights["wfc"], weights["wproj"])
    dx = torch.empty_like(xk)
    work = torch.empty(bwd_workspace_bytes(x.dtype, R, Cp, Fp), dtype=torch.uint8,
                       device=x.device)
    BWD_KERNEL.launch(dyk.data_ptr(), xk.data_ptr(), *(t.data_ptr() for t in weights.values()),
                      work.data_ptr(), dx.data_ptr(), _DTYPE_CODES[x.dtype], R, Cp, Fp, C,
                      float(eps), stream_ptr(x))
    return dx if Cp == C else dx[:, :C].reshape(x.shape)


@torch.library.custom_op("pevit_tpu_torch::fused_mlp_fwd", mutates_args=())
def _fused_mlp_fwd_op(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                      wfc: torch.Tensor, bfc: torch.Tensor, wproj: torch.Tensor,
                      bproj: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward kernel on CUDA tensors, the plain version on CPU ones."""
    args = (x, ln_scale, ln_bias, wfc, bfc, wproj, bproj)
    fwd = fused_mlp_fwd if device_kind("fused_mlp_fwd", *args) == "cuda" else fused_mlp_residual_ref
    return fwd(*args, eps)


@_fused_mlp_fwd_op.register_fake
def _(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps):
    return torch.empty_like(x)


@torch.library.custom_op("pevit_tpu_torch::fused_mlp_bwd", mutates_args=())
def _fused_mlp_bwd_op(dy: torch.Tensor, x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, wfc: torch.Tensor, bfc: torch.Tensor,
                      wproj: torch.Tensor, eps: float) -> torch.Tensor:
    """dx by the backward kernel on CUDA tensors, by :func:`fused_mlp_bwd_ref`
    on CPU ones."""
    args = (dy, x, ln_scale, ln_bias, wfc, bfc, wproj)
    bwd = fused_mlp_bwd if device_kind("fused_mlp_bwd", *args) == "cuda" else fused_mlp_bwd_ref
    return bwd(*args, eps)


@_fused_mlp_bwd_op.register_fake
def _(dy, x, ln_scale, ln_bias, wfc, bfc, wproj, eps):
    return torch.empty_like(x)


class _FusedMlpResidual(torch.autograd.Function):
    """Forward: the operator ``fused_mlp_fwd``.  Saves x and the weights the
    backward reads (of the activations, x only).  Backward: dx by the
    operator ``fused_mlp_bwd``.  ``torch.export`` traces through the
    forward, so an exported graph holds the operator node."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_scale, ln_bias, wfc, bfc, wproj)
        return torch.ops.pevit_tpu_torch.fused_mlp_fwd(x, ln_scale, ln_bias, wfc, bfc, wproj,
                                                       bproj, eps)

    @staticmethod
    def backward(ctx, dy):
        wanted = [n for n, need in zip(_WEIGHTS, ctx.needs_input_grad[1:7]) if need]
        if wanted:
            raise RuntimeError(
                f"fused_mlp_residual gives the gradient of x only, but {wanted} require grad; "
                "freeze them (requires_grad_(False)) or take the unfused route")
        x, *weights = ctx.saved_tensors
        dx = torch.ops.pevit_tpu_torch.fused_mlp_bwd(dy.contiguous(), x, *weights, ctx.eps)
        return (dx,) + (None,) * 7


@register_flop_formula(torch.ops.pevit_tpu_torch.fused_mlp_fwd)
def _fused_mlp_fwd_flops(x_shape, ln_scale_shape, ln_bias_shape, wfc_shape, *args,
                         out_shape=None, **kwargs) -> int:
    """x·Wfc and g·Wproj, 2·R·C·F each, as the reference's plain MLP."""
    C, F = wfc_shape
    return 4 * math.prod(x_shape[:-1]) * C * F


@register_flop_formula(torch.ops.pevit_tpu_torch.fused_mlp_bwd)
def _fused_mlp_bwd_flops(dy_shape, x_shape, ln_scale_shape, ln_bias_shape, wfc_shape, *args,
                         out_shape=None, **kwargs) -> int:
    """The two dx products the reference's autodiff runs with the weights
    frozen (dg = dy·Wprojᵀ, du = dh·Wfcᵀ), 2·R·C·F each; the kernel's
    recompute of u is not counted."""
    C, F = wfc_shape
    return 4 * math.prod(x_shape[:-1]) * C * F


def fused_mlp_residual(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """x: (B, N, C) -> x + MLP(LN(x)), differentiable in x only.  The
    kernels on CUDA tensors, the plain versions on CPU tensors; any other
    device raises here, before the operator, whose fake version would
    otherwise answer for the meta device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_mlp_residual runs on CUDA or CPU tensors, got {x.device}")
    return _FusedMlpResidual.apply(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, float(eps))
