"""CLIP specs and the ViT visual tower.

Counterpart of ``pevit_tpu/core/clip.py``: the spec dataclasses (copied),
random initialisation with the reference's distributions, and the image
encoder, on normalised float images or on pre-patchified uint8 patches with
the normalisation folded into the patch-embedding GEMM.  Blocks run as a
plain Python loop over a ``ModuleList``.  The text tower is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import LayerNorm, ResidualAttentionBlock, layer_norm, residual_attention_block


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    input_resolution: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class TextSpec:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    output_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPSpec:
    embed_dim: int = 512
    vision: VisionSpec = dataclasses.field(default_factory=VisionSpec)
    text: TextSpec = dataclasses.field(default_factory=TextSpec)

    @staticmethod
    def vit_b32() -> "CLIPSpec":
        return CLIPSpec()

    @staticmethod
    def vit_b16() -> "CLIPSpec":
        return CLIPSpec(vision=VisionSpec(patch_size=16))

    @staticmethod
    def vit_l14() -> "CLIPSpec":
        """OpenAI CLIP ViT-L/14: vision width 1024 x 24 layers x 16 heads,
        patch 14 -> N = 257; text width 768; embed_dim 768."""
        return CLIPSpec(
            embed_dim=768,
            vision=VisionSpec(patch_size=14, width=1024, layers=24, heads=16, output_dim=768),
            text=TextSpec(width=768, heads=12, layers=12, output_dim=768),
        )


@dataclasses.dataclass(frozen=True)
class BlockHooks:
    """Per-layer PEFT callbacks.

    ``attn_delta(shared, layer, generator, x) -> (q_delta, v_delta)`` with
    (B, H, N, hd) outputs; ``shared`` and ``layer`` are the PEFT module's
    shared part and this layer's part.
    """

    attn_delta: Optional[Callable] = None


class VisionTransformer(nn.Module):
    """Parameters of the ViT visual tower (the reference's ``visual``)."""

    def __init__(self, v: VisionSpec):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.zeros(v.patch_size * v.patch_size * 3, v.width))
        self.class_embedding = nn.Parameter(torch.zeros(v.width))
        self.positional_embedding = nn.Parameter(torch.zeros(v.seq_len, v.width))
        self.ln_pre = LayerNorm(v.width)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(v.width) for _ in range(v.layers))
        self.ln_post = LayerNorm(v.width)
        self.proj = nn.Parameter(torch.zeros(v.width, v.output_dim))


class CLIP(nn.Module):
    """The CLIP parameters this slice uses: the visual tower and logit_scale."""

    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.visual = VisionTransformer(spec.vision)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))


def init_clip_params(generator: torch.Generator, spec: CLIPSpec, *, device=None) -> CLIP:
    """Random CLIP visual tower with the reference's init distributions
    (normal draws from ``generator``, a CPU generator; biases zero, LN
    identity), moved to ``device``."""
    dev = resolve_device(device)
    v = spec.vision
    clip = CLIP(spec)
    vis = clip.visual

    def normal(p: nn.Parameter, std: float) -> None:
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    scale = v.width ** -0.5
    normal(vis.patch_embed.kernel, (3 * v.patch_size * v.patch_size) ** -0.5)
    normal(vis.class_embedding, scale)
    normal(vis.positional_embedding, scale)
    proj_std = (v.width ** -0.5) * ((2 * v.layers) ** -0.5)
    for blk in vis.blocks:
        normal(blk.attn.in_proj.kernel, v.width ** -0.5)
        normal(blk.attn.out_proj.kernel, proj_std)
        normal(blk.mlp.c_fc.kernel, (2 * v.width) ** -0.5)
        normal(blk.mlp.c_proj.kernel, proj_std)
    normal(vis.proj, scale)
    return clip.to(dev)


def patchify_images(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, 3) -> (N, (H/p)*(W/p), p*p*3), a dtype-preserving shuffle,
    applied once per dataset to the uint8 images so that each batch feeds
    the patch-embedding GEMM directly."""
    n, h, w, c = x.shape
    p = patch_size
    g, gw = h // p, w // p
    return x.reshape(n, g, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(n, g * gw, p * p * c)


def encode_image(
    clip: CLIP,
    x: torch.Tensor,
    *,
    spec: CLIPSpec,
    peft: Optional[nn.Module] = None,
    hooks: Optional[BlockHooks] = None,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
    use_fused_mlp: bool = True,
    apply_proj: bool = True,
    patch_fold: Optional[tuple] = None,
) -> torch.Tensor:
    """Visual tower forward.

    ``x`` is (B, H, W, 3) normalised float images, or (B, G*G, p*p*3)
    pre-patchified raw uint8 patches (:func:`patchify_images`) with
    ``patch_fold=(mean, std)``: the per-channel normalisation then folds into
    the patch-embedding GEMM (W' = W s, b' = t W with s = 1/(255 std),
    t = -mean/std, built in float32 and cast to the compute dtype).

    Returns (B, embed_dim), or (B, width) when ``apply_proj`` is False (the
    projection folded into the classifier head).  ``peft`` holds the PEFT
    parameters (``.shared`` and per-layer ``.layers``) that ``hooks`` use;
    ``use_fused_mlp`` picks each block's MLP route.
    """
    v = spec.vision
    vp = clip.visual
    B = x.shape[0]
    p = v.patch_size
    dt = compute_dtype

    if x.dim() == 3:
        if patch_fold is None:
            raise ValueError("pre-patchified input requires patch_fold=(mean, std)")
        mean, std = (torch.as_tensor(t, device=x.device).float() for t in patch_fold)
        kernel32 = vp.patch_embed.kernel.float()  # (p*p*3, width)
        s = (1.0 / (255.0 * std)).repeat(p * p)
        t = (-mean / std).repeat(p * p)
        x = x.to(dt) @ (kernel32 * s[:, None]).to(dt) + (t @ kernel32).to(dt)
    else:
        # patchify == non-overlapping conv == one GEMM (no bias)
        x = patchify_images(x.to(dt), p) @ vp.patch_embed.kernel.to(dt)
    cls = vp.class_embedding.to(dt).expand(B, 1, v.width)
    x = torch.cat([cls, x], dim=1) + vp.positional_embedding.to(dt)
    x = layer_norm(x, vp.ln_pre.scale, vp.ln_pre.bias)

    for i, blk in enumerate(vp.blocks):
        delta_fn = None
        if hooks is not None and hooks.attn_delta is not None:
            delta_fn = partial(hooks.attn_delta, peft.shared, peft.layers[i], generator)
        x = residual_attention_block(blk, x, n_head=v.heads, qv_delta_fn=delta_fn,
                                     use_fused_mlp=use_fused_mlp)

    x = layer_norm(x[:, 0, :], vp.ln_post.scale, vp.ln_post.bias)
    if not apply_proj:
        return x
    return x @ vp.proj.to(x.dtype)
