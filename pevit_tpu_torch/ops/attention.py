"""Mask-free attention core for the ViT tower: plain version and CUDA kernel.

Counterpart of ``pevit_tpu/ops/attention.py``.  Semantics contract (as
``core.layers.multi_head_attention`` relies on it): q arrives already scaled
by 1/sqrt(hd) and with any PEFT delta added; logits and softmax run in
float32; the probabilities are rounded to v's type before the product with
v, which accumulates in float32; the output has the input's type.

The forward is the registered operator ``pevit_tpu_torch::attention_fwd``,
which chooses by its tensors' device when it runs: on CUDA it launches the
hand-written kernel (``csrc/attention_fwd.cu``) or raises; on the CPU it
runs the plain version; any other device raises.  There is no fallback
between the two, and because the choice is made inside the operator, a
``torch.export`` graph holds the operator node and runs the kernel on
whichever device it is given.  The backward is the operator
``pevit_tpu_torch::attention_bwd``, plain PyTorch on both devices
(:func:`attention_bwd_ref`), as the reference's backward is plain XLA; an
autograd Function joins the two (``attention_core``).
Both operators have fake versions for tracing and FLOP formulas for
``torch.utils.flop_counter`` that count the reference's products.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.utils.flop_counter import register_flop_formula

from ._build import Kernel, KernelInputError, device_kind, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

KERNEL = Kernel(
    "attention_fwd",
    "attention_fwd.cu",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _P],
    replaces="pevit_tpu/ops/attention.py:40",
)
# every N >= 1 and every hd from 1 to MAX_HEAD_DIM is taken.  bf16 at hd <=
# REG_WIDTH runs its persistent body (one block an SM walking the (batch,
# head)s, S rows in wgmma's accumulators) up to TMA_MAX_SEQ tokens, there
# its body with the S tile in shared memory (a block per (batch, head,
# 64-query tile)) up to SMEM_MAX_SEQ tokens, the same body with a shorter
# ring up to SMEM2_MAX_SEQ, and its three-walk long body otherwise.  fp32 at
# hd <= F32_TMA_WIDTH runs its persistent body at every N (one block an SM
# walking jobs of two 64-query tiles of a (batch, head), at N <= 64 the
# (batch, head)s; keys in chunks split into TF32 planes in the block),
# wider fp32 heads the mma.sync body.  The long body and the wide fp32 body launch a block per
# (batch, head, 64-query tile, chunk of at most COLUMN_CHUNK output
# columns).  A body is built for a head width of
# BODY_WIDTHS (hd rounded up; the kernel stages the columns past hd as
# zeros), and the kernel takes hd in whole 16-byte chunks: the wrapper
# zero-pads any other hd, as the reference pads hd to a multiple of 8.  The
# launchers count the grid's blocks (a persistent body its work items: B * H
# in bf16, B * H * query tiles in fp32) in a 32-bit int; every pointer
# offset is 64-bit
REG_WIDTH = 64
BODY_WIDTHS = (64, 80, 96, 128, 256)
MAX_HEAD_DIM = BODY_WIDTHS[-1]
COLUMN_CHUNK = 128
QUERY_TILE = 64
MAX_BLOCKS = 2 ** 31 - 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the longest N of the persistent body, the key counts its S rows are built
# for (N rounded up to the next), and its consumer warpgroups a block, as
# csrc/attention_fwd.cu sets them
TMA_MAX_SEQ = 257
TMA_KEYS = (56, 64, 128, 200, 264)
TMA_CONSUMERS = 2
# the SMs of an H100 SXM: the persistent body's grid in launch_plan, one
# block an SM (the launcher asks the device for its count)
H100_SMS = 132
# the longest N of the bf16 body with the S tile in shared memory (hd <=
# REG_WIDTH, past TMA_MAX_SEQ) with its ring of four stages, and with its
# ring of two (past SMEM_MAX_SEQ), as csrc/attention_fwd.cu sets them
SMEM_MAX_SEQ = 640
SMEM2_MAX_SEQ = 768
# the fp32 persistent body's widest head, its keys a chunk and the stages of
# each plane ring, as csrc/attention_fwd.cu sets them
F32_TMA_WIDTH = 80
F32_CHUNK = 64
F32_PLANE_STAGES = 2


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel runs one call: ``body`` ("bf16_tma" (the bf16
    persistent body), "bf16_smem", "bf16_smem2" (the short ring),
    "bf16_long", "f32_tma" (the fp32 persistent body) or "f32" (the fp32
    mma.sync body, heads wider than F32_TMA_WIDTH)), the head width
    ``width`` its instantiation is built for, the head width ``hd`` it is
    handed (the caller's, or zero-padded to whole 16-byte chunks), its
    grid's ``blocks`` and, for the bf16 persistent body, the key count
    ``keys`` of its instantiation (else 0)."""

    body: str
    width: int
    hd: int
    blocks: int
    keys: int = 0


def launch_plan(B: int, N: int, H: int, hd: int, dtype) -> LaunchPlan:
    """The body, instantiation, padded head width and grid of a launch on
    (B, N, H, hd) tensors of ``dtype`` on an H100 SXM, as
    ``csrc/attention_fwd.cu``'s launcher chooses them; raises
    :class:`KernelInputError` on a shape it cannot take."""
    if dtype not in _DTYPE_CODES:
        raise KernelInputError(f"attention kernel takes {list(_DTYPE_CODES)}, got {dtype}")
    if B < 1 or H < 1 or N < 1:
        raise KernelInputError(f"attention kernel takes B, H, N >= 1, got {(B, N, H, hd)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise KernelInputError(f"attention kernel takes 1 <= hd <= {MAX_HEAD_DIM}, got {hd}")
    chunk = 4 if dtype == torch.float32 else 8  # elements in 16 bytes
    padded = -(-hd // chunk) * chunk
    width = next(w for w in BODY_WIDTHS if w >= padded)
    keys, units = 0, B * H
    if dtype == torch.bfloat16 and padded <= REG_WIDTH and N <= TMA_MAX_SEQ:
        body, blocks, keys = "bf16_tma", min(H100_SMS, units), next(k for k in TMA_KEYS if k >= N)
    elif dtype == torch.float32 and padded <= F32_TMA_WIDTH:
        q_tiles = -(-N // QUERY_TILE)
        units = B * H * q_tiles
        work = B * H * -(-q_tiles // 2)  # jobs of two query tiles (a (batch, head) at N <= 64)
        body, blocks = "f32_tma", min(H100_SMS, work)
    elif dtype == torch.bfloat16 and padded <= REG_WIDTH and N <= SMEM_MAX_SEQ:
        body, blocks = "bf16_smem", B * H * -(-N // QUERY_TILE)
        units = blocks
    elif dtype == torch.bfloat16 and padded <= REG_WIDTH and N <= SMEM2_MAX_SEQ:
        body, blocks = "bf16_smem2", B * H * -(-N // QUERY_TILE)
        units = blocks
    else:
        body = "bf16_long" if dtype == torch.bfloat16 else "f32"
        columns = min(width, COLUMN_CHUNK)
        blocks = units = B * H * -(-N // QUERY_TILE) * -(-padded // columns)
    if units > MAX_BLOCKS:  # a persistent body counts its work items
        raise KernelInputError(f"attention kernel takes at most {MAX_BLOCKS} blocks, got {units} "
                               f"(B={B}, H={H}, N={N}, hd={hd}, {dtype})")
    return LaunchPlan(body, width, padded, blocks, keys)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention on (B, H, N, hd) tensors (= the reference's
    ``_xla_attention`` without a mask).  ``q.float() @ k.float()`` gives the
    reference's float32-accumulated logits of low-precision operands."""
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", probs, v)


def rows_aligned(offset: int, strides, itemsize: int) -> bool:
    """Whether the kernel can copy a (B, N, H, hd) operand's rows in 16-byte
    chunks: its address ``offset`` (in bytes) and its batch, token and head
    strides ``strides`` (in elements of ``itemsize`` bytes) all multiples of
    16 bytes.  Every body requires it."""
    return offset % 16 == 0 and all(st * itemsize % 16 == 0 for st in strides)


def check_grid(B: int, H: int, N: int, dtype, hd: int = REG_WIDTH) -> None:
    """The batch a launch can take: the grid of the body that runs
    (:func:`launch_plan`) at most ``MAX_BLOCKS`` blocks."""
    launch_plan(B, N, H, hd, dtype)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on (B, N, H, hd) CUDA tensors, which may be strided
    views (e.g. of a packed qkv projection) with unit stride inside a head
    and rows that :func:`rows_aligned` accepts, at any N >= 1 and 1 <= hd
    <= 256.  An hd that does not fill whole 16-byte chunks is zero-padded
    into aligned copies first (:func:`launch_plan`).  The dtype picks the
    kernel's body; both run on the tensor cores, float32 by a three-product
    TF32 split that keeps float32 accuracy.  Returns a contiguous (B, N, H,
    hd) tensor."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise KernelInputError("attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise KernelInputError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise KernelInputError(f"q, k, v must share one (B, N, H, hd) shape, got "
                               f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise KernelInputError(f"q, k, v must share a dtype in {list(_DTYPE_CODES)}, got "
                               f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, N, H, hd = q.shape
    plan = launch_plan(B, N, H, hd, q.dtype)
    if plan.hd != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, plan.hd - hd)) for t in (q, k, v))
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise KernelInputError("attention kernel needs unit stride along head_dim")
    if not all(rows_aligned(t.data_ptr(), t.stride()[:3], t.element_size()) for t in (q, k, v)):
        raise KernelInputError("the attention kernel copies rows in 16-byte chunks: q, k, v need "
                               "16-byte aligned base pointers and batch, token and head strides "
                               "that are multiples of 16 bytes")
    out = torch.empty((B, N, H, plan.hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPE_CODES[q.dtype], B, H, N, plan.hd, *strides, stream_ptr(q))
    return out if plan.hd == hd else out[..., :hd].contiguous()


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


@torch.library.custom_op("pevit_tpu_torch::attention_fwd", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, hd) -> contiguous (B, N, H, hd): the kernel on CUDA
    tensors, :func:`attention_ref` on CPU tensors."""
    if device_kind("attention_fwd", q, k, v) == "cuda":
        return attention_fwd(q, k, v)
    t = lambda x: x.transpose(1, 2)
    return t(attention_ref(t(q), t(k), t(v))).contiguous()


@_attention_op.register_fake
def _(q, k, v):
    return q.new_empty(q.shape)


@torch.library.custom_op("pevit_tpu_torch::attention_bwd", mutates_args=())
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by :func:`attention_bwd_ref` on either device."""
    device_kind("attention_bwd", q, k, v, g)
    return attention_bwd_ref(q, k, v, g)


@_attention_bwd_op.register_fake
def _(q, k, v, g):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


class _AttentionCore(torch.autograd.Function):
    """Forward: the operator ``attention_fwd``.  Saves only q, k and v, as
    the reference's custom VJP does; the backward is the operator
    ``attention_bwd``, which recomputes the probabilities in plain PyTorch,
    as the reference runs its backward in plain XLA.  Gradients come back
    in the inputs' (B, N, H, hd) layout, and autograd routes them into
    whatever views q, k and v are (k and v are strided views of the packed
    qkv projection).  ``torch.export`` traces through the forward, so an
    exported graph holds the operator node."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return torch.ops.pevit_tpu_torch.attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return torch.ops.pevit_tpu_torch.attention_bwd(*ctx.saved_tensors, g)


@register_flop_formula(torch.ops.pevit_tpu_torch.attention_fwd)
def _attention_fwd_flops(q_shape, k_shape, v_shape, *, out_shape=None, **kwargs) -> int:
    """q·kᵀ and p·v, 2·B·H·N²·hd each, as the reference's plain path."""
    B, N, H, hd = q_shape
    return 4 * B * H * N * N * hd


@register_flop_formula(torch.ops.pevit_tpu_torch.attention_bwd)
def _attention_bwd_flops(q_shape, k_shape, v_shape, g_shape, *, out_shape=None, **kwargs) -> int:
    """The four products of the reference's autodiff (dv = pᵀg, dp = g vᵀ,
    dq = ds k, dk = dsᵀq), not :func:`attention_bwd_ref`'s recompute of the
    logits."""
    B, N, H, hd = q_shape
    return 8 * B * H * N * N * hd


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mask-free attention on (B, N, H, hd) tensors -> (B, N, H, hd),
    differentiable in q, k and v.

    CUDA tensors go through the kernel (which raises on what it does not
    take); CPU tensors through :func:`attention_ref`.  Tensors on any
    other device raise here, before the operator, whose fake version
    would otherwise answer for the meta device."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention_core runs on CUDA or CPU tensors, got {q.device}")
    return _AttentionCore.apply(q, k, v)
