"""The ModifiedResNet visual towers of CLIP (RN50, RN101, RN50x4/x16/x64).

Counterpart of ``pevit_tpu/core/resnet.py`` (reference model.py:11-152).
The reference runs these towers frozen in eval mode, so BatchNorm uses its
running statistics, folded into one scale and offset per channel.  The
parameter tree is the reference's: convolution kernels ``(kh, kw, in,
out)`` (HWIO), each BatchNorm's ``scale``, ``bias``, ``mean`` and ``var``
as parameters (under full fine-tuning the reference's optimiser updates all
four, as every leaf of its tree), the blocks of ``layer<i>`` keyed
``"0"``, ``"1"``, ...

The choices of the reference kept here: torch's explicit symmetric padding;
the anti-aliased stride (an average pool before ``conv3`` and before the
downsample convolution); the attention pool computes the mean-token query
row only (``pevit_tpu/core/resnet.py:102-119``), which is what torch's full
attention returns as ``x[0]``.  Convolutions are ``conv2d`` calls on NCHW
activations and the attention pool is plain PyTorch, as both are plain XLA
in the reference: this tower reaches no hand-written kernel.

A tower stacked over T trials (``full_finetune`` on a batch of trials,
every parameter (T, ...)) takes the trials' images folded, (T*B, H, W, 3),
and runs its convolutions with the trials side by side on the channel axis,
(B, T*C, H, W): each convolution is one grouped convolution (``groups=T``,
trial t's kernel on trial t's channels), each BatchNorm one scale and
offset per channel of the T*C, the pooling and the residuals as they are;
the attention pool takes the trials' rows folded again, (T*B, ...), and
applies trial t's projections to trial t's rows.  A stack of one trial is
the lone tower's layout and calls.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import trial_axis
from .layers import Dense

EXPANSION = 4  # Bottleneck.expansion (model.py:12)


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    input_resolution: int = 224
    width: int = 64
    layers: tuple = (3, 4, 6, 3)
    output_dim: int = 1024

    @property
    def heads(self) -> int:
        # vision_heads = vision_width * 32 // 64 (model.py:1078)
        return self.width * 32 // 64

    @property
    def embed_dim(self) -> int:
        return self.width * 32  # the ResNet feature width (model.py:125)

    @property
    def grid(self) -> int:
        return self.input_resolution // 32


# the OpenAI RN architectures, for random weights; a checkpoint carries its
# own (``ckpt.infer_spec_from_state_dict``)
RN_SPECS = {
    "RN50": ResNetSpec(224, 64, (3, 4, 6, 3), 1024),
    "RN101": ResNetSpec(224, 64, (3, 4, 23, 3), 512),
    "RN50x4": ResNetSpec(288, 80, (4, 6, 10, 6), 640),
    "RN50x16": ResNetSpec(384, 96, (6, 8, 18, 8), 768),
    "RN50x64": ResNetSpec(448, 128, (3, 15, 36, 10), 1024),
}


def _conv_param(kh: int, kw: int, cin: int, cout: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(kh, kw, cin, cout))


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm parameters: affine ``scale`` / ``bias`` and the
    running ``mean`` / ``var``."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.mean = nn.Parameter(torch.zeros(ch))
        self.var = nn.Parameter(torch.ones(ch))


class Stem(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.conv1, self.bn1 = _conv_param(3, 3, 3, w // 2), BatchNorm(w // 2)
        self.conv2, self.bn2 = _conv_param(3, 3, w // 2, w // 2), BatchNorm(w // 2)
        self.conv3, self.bn3 = _conv_param(3, 3, w // 2, w), BatchNorm(w)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv, self.bn = _conv_param(1, 1, cin, cout), BatchNorm(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv_param(1, 1, cin, planes), BatchNorm(planes)
        self.conv2, self.bn2 = _conv_param(3, 3, planes, planes), BatchNorm(planes)
        self.conv3 = _conv_param(1, 1, planes, planes * EXPANSION)
        self.bn3 = BatchNorm(planes * EXPANSION)
        if downsample:
            self.downsample = Downsample(cin, planes * EXPANSION)


class AttentionPool(nn.Module):
    def __init__(self, spec: ResNetSpec):
        super().__init__()
        emb = spec.embed_dim
        self.positional_embedding = nn.Parameter(torch.zeros(spec.grid ** 2 + 1, emb))
        self.q_proj, self.k_proj, self.v_proj = Dense(emb, emb), Dense(emb, emb), Dense(emb, emb)
        self.c_proj = Dense(emb, spec.output_dim)


def _block_layout(spec: ResNetSpec):
    """(layer index, block index, in channels, planes, stride) of every
    Bottleneck, in order."""
    inplanes = spec.width
    for li, n_blocks in enumerate(spec.layers, start=1):
        planes = spec.width * 2 ** (li - 1)
        for bi in range(n_blocks):
            cin = inplanes if bi == 0 else planes * EXPANSION
            yield li, bi, cin, planes, ((1 if li == 1 else 2) if bi == 0 else 1)
        inplanes = planes * EXPANSION


class ModifiedResNet(nn.Module):
    """Parameters of the RN visual tower (the reference's ``visual`` tree:
    ``stem``, ``layer1`` .. ``layer4``, ``attnpool``)."""

    def __init__(self, spec: ResNetSpec):
        super().__init__()
        self.stem = Stem(spec.width)
        for li in range(1, len(spec.layers) + 1):
            setattr(self, f"layer{li}", nn.ModuleDict())
        for li, bi, cin, planes, stride in _block_layout(spec):
            down = bi == 0 and (stride > 1 or cin != planes * EXPANSION)
            getattr(self, f"layer{li}")[str(bi)] = Bottleneck(cin, planes, down)
        self.attnpool = AttentionPool(spec)


def init_resnet_params(generator: torch.Generator, spec: ResNetSpec) -> ModifiedResNet:
    """A random RN tower on the CPU with the reference's distributions:
    convolutions N(0, 1/fan_in), BatchNorm the identity, the attention
    pool's projections and positional embedding N(0, 1/embed_dim), biases
    zero."""
    tower = ModifiedResNet(spec)
    std = spec.embed_dim ** -0.5
    with torch.no_grad():
        for name, p in tower.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("conv"):
                kh, kw, cin, _ = p.shape
                p.copy_(torch.randn(p.shape, generator=generator) * (kh * kw * cin) ** -0.5)
            elif name.startswith("attnpool.") and leaf in ("kernel", "positional_embedding"):
                p.copy_(torch.randn(p.shape, generator=generator) * std)
    return tower


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """NCHW activations, an HWIO kernel, torch's symmetric padding; a
    stacked (T, kh, kw, in, out) kernel convolves trial t's channels of a
    (B, T*in, H, W) input with its slice t, one grouped convolution."""
    T = trial_axis.stacked(kernel, 4)
    if T == 1:
        kernel = kernel[0]
    if T <= 1:
        return F.conv2d(x, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=pad)
    w = kernel.to(x.dtype).permute(0, 4, 3, 1, 2)  # (T, out, in, kh, kw)
    return F.conv2d(x, w.reshape(-1, *w.shape[2:]), stride=stride, padding=pad, groups=T)


def _bn(x: torch.Tensor, p: BatchNorm, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm as one scale and offset per channel, computed in
    float32 and cast to the activations' dtype; stacked (T, C) statistics
    and affine give the T*C channels of the side-by-side layout."""
    s = p.scale.float() / torch.sqrt(p.var.float() + eps)
    t = p.bias.float() - p.mean.float() * s
    s, t = s.reshape(-1), t.reshape(-1)
    return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k <= 1 else F.avg_pool2d(x, k)


def _bottleneck(p: Bottleneck, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p.conv1), p.bn1))
    out = F.relu(_bn(_conv(out, p.conv2, pad=1), p.bn2))
    out = _bn(_conv(_avg_pool(out, stride), p.conv3), p.bn3)
    if hasattr(p, "downsample"):
        identity = _bn(_conv(_avg_pool(x, stride), p.downsample.conv), p.downsample.bn)
    else:
        identity = x
    return F.relu(out + identity)


def _proj(t: torch.Tensor, p: Dense) -> torch.Tensor:
    return trial_axis.add(trial_axis.matmul(t, p.kernel.to(t.dtype)), p.bias.to(t.dtype), 1)


def _attn_pool(p: AttentionPool, x: torch.Tensor, n_head: int) -> torch.Tensor:
    """AttentionPool2d (model.py:56-90) on (B, C, H, W), the mean-token
    query row only: float32 logits, the probabilities cast to v's dtype.
    A stacked pool takes the side-by-side (B, T*C, H, W) layout and gives
    (T*B, output_dim), trial-major."""
    T = trial_axis.stacked(p.positional_embedding, 2)
    if T > 1:
        Bt, TC, H, W = x.shape
        x = x.reshape(Bt, T, TC // T, H, W).transpose(0, 1).reshape(T * Bt, TC // T, H, W)
    B, C = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)  # (B, H*W, C), row-major positions
    x = trial_axis.add(torch.cat([x.mean(dim=1, keepdim=True), x], dim=1),
                       p.positional_embedding.to(x.dtype), 2)
    hd = C // n_head
    q = _proj(x[:, :1], p.q_proj).reshape(B, 1, n_head, hd) * (1.0 / math.sqrt(hd))
    k = _proj(x, p.k_proj).reshape(B, -1, n_head, hd)
    v = _proj(x, p.v_proj).reshape(B, -1, n_head, hd)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(B, C)
    return _proj(out, p.c_proj)


def encode_image_rn(tower: ModifiedResNet, x: torch.Tensor, *, spec: ResNetSpec,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ModifiedResNet forward (model.py:127-152): (B, H, W, 3) float
    images -> (B, output_dim) in ``compute_dtype``; a stacked tower takes
    and gives the trials' rows folded, (T*B, ...)."""
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    T = trial_axis.stacked(tower.stem.conv1, 4)
    if T > 1:  # the trials side by side on the channel axis
        TB, C, H, W = x.shape
        x = x.reshape(T, TB // T, C, H, W).transpose(0, 1).reshape(TB // T, T * C, H, W)
    stem = tower.stem
    x = F.relu(_bn(_conv(x, stem.conv1, stride=2, pad=1), stem.bn1))
    x = F.relu(_bn(_conv(x, stem.conv2, pad=1), stem.bn2))
    x = F.relu(_bn(_conv(x, stem.conv3, pad=1), stem.bn3))
    x = _avg_pool(x, 2)
    for li, bi, _, _, stride in _block_layout(spec):
        x = _bottleneck(getattr(tower, f"layer{li}")[str(bi)], x, stride)
    return _attn_pool(tower.attnpool, x, spec.heads)
