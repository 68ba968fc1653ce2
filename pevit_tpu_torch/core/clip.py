"""CLIP specs, the ViT visual tower and the causal text tower.

Counterpart of ``pevit_tpu/core/clip.py``: the spec dataclasses (copied),
random initialisation with the reference's distributions, the image
encoder, on normalised float images or on pre-patchified uint8 patches with
the normalisation folded into the patch-embedding GEMM, and the text
encoder.  Blocks run as a plain Python loop over a ``ModuleList``.  The text
tower carries no PEFT parameters; its attention is masked (plain PyTorch)
and its MLP unfused, as in the reference, so it reaches no kernel.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from . import trial_axis
from .layers import (
    LayerNorm,
    ResidualAttentionBlock,
    causal_mask,
    layer_norm,
    residual_attention_block,
)
from .resnet import ModifiedResNet, ResNetSpec, encode_image_rn, init_resnet_params


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
    # set for the RN towers (model.py:1213-1222): the visual tower is then
    # the ModifiedResNet and ``vision`` is unused
    vision_rn: Optional[ResNetSpec] = None

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

    @staticmethod
    def from_config(config) -> "CLIPSpec":
        """From a MODEL.SPEC config node (resources/model/*.yaml), for
        random-init models; ``input_resolution`` follows TRAIN.IMAGE_SIZE."""
        spec = config.MODEL.SPEC
        patch = 16 if "16" in str(config.MODEL.NAME) else 32
        vision = spec.get("VISION", {}) or {}
        text = spec.get("TEXT", {}) or {}
        embed = spec.get("EMBED_DIM", 512)
        vwidth = vision.get("WIDTH", 768)
        return CLIPSpec(
            embed_dim=embed,
            vision=VisionSpec(
                input_resolution=config.TRAIN.IMAGE_SIZE[0],
                patch_size=vision.get("PATCH_SIZE", patch),
                width=vwidth,
                layers=vision.get("LAYERS", 12),
                heads=max(1, vwidth // 64),
                output_dim=embed,
            ),
            text=TextSpec(
                context_length=text.get("CONTEXT_LENGTH", 77),
                vocab_size=text.get("VOCAB_SIZE", 49408),
                width=text.get("WIDTH", 512),
                heads=text.get("HEADS", 8),
                layers=text.get("LAYERS", 12),
                output_dim=embed,
            ),
        )


@dataclasses.dataclass(frozen=True)
class BlockHooks:
    """Per-layer PEFT callbacks.

    ``attn_delta(shared, layer, generator, x) -> (q_delta, v_delta)`` with
    (B, H, N, hd) outputs; ``mlp_post(shared, layer, generator, m) -> m'``
    on the bare MLP output.  ``shared`` and ``layer`` are the PEFT module's
    shared part (None where a method shares nothing) and this layer's part.

    A batch of T trials (``peft.base.make_hooks(..., trials=T)``) runs the
    tower unchanged on its T*B images: the hooks know T, take the folded
    (T*B, N, C) input, and apply trial t's parameters (stacked (T, ...) in
    ``shared`` and ``layer``) to trial t's B rows; ``generator`` is then a
    sequence of T generators, one per trial.
    """

    attn_delta: Optional[Callable] = None
    mlp_post: Optional[Callable] = None


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


class TextTransformer(nn.Module):
    """Parameters of the causal text tower (the reference's ``text``)."""

    def __init__(self, t: TextSpec):
        super().__init__()
        self.token_embedding = nn.Parameter(torch.zeros(t.vocab_size, t.width))
        self.positional_embedding = nn.Parameter(torch.zeros(t.context_length, t.width))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(t.width) for _ in range(t.layers))
        self.ln_final = LayerNorm(t.width)
        self.text_projection = nn.Parameter(torch.zeros(t.width, t.output_dim))


class CLIP(nn.Module):
    """The CLIP parameters: the visual tower (the ViT, or the ModifiedResNet
    where ``spec.vision_rn`` is set), the text tower and logit_scale."""

    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.visual = (VisionTransformer(spec.vision) if spec.vision_rn is None
                       else ModifiedResNet(spec.vision_rn))
        self.text = TextTransformer(spec.text)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))


def _init_blocks(blocks: nn.ModuleList, width: int, normal) -> None:
    proj_std = (width ** -0.5) * ((2 * len(blocks)) ** -0.5)
    for blk in blocks:
        normal(blk.attn.in_proj.kernel, width ** -0.5)
        normal(blk.attn.out_proj.kernel, proj_std)
        normal(blk.mlp.c_fc.kernel, (2 * width) ** -0.5)
        normal(blk.mlp.c_proj.kernel, proj_std)


def init_clip_params(generator: torch.Generator, spec: CLIPSpec, *, device=None) -> CLIP:
    """Random CLIP with the reference's init distributions (biases zero, LN
    identity), moved to ``device``.

    The visual tower is drawn from ``generator`` (a CPU generator), as it
    was before the text tower was ported.  The text tower is drawn from its
    own CPU generator, seeded from ``generator.initial_seed()``, so that
    adding it changes neither the visual weights of a seed nor any later
    draw from ``generator``."""
    dev = resolve_device(device)
    v, t = spec.vision, spec.text
    clip = CLIP(spec)
    vis, txt = clip.visual, clip.text
    if spec.vision_rn is not None:
        clip.visual = init_resnet_params(generator, spec.vision_rn)

    def drawer(gen: torch.Generator):
        def normal(p: nn.Parameter, std: float) -> None:
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * std)
        return normal

    normal = drawer(generator)
    if spec.vision_rn is None:
        scale = v.width ** -0.5
        normal(vis.patch_embed.kernel, (3 * v.patch_size * v.patch_size) ** -0.5)
        normal(vis.class_embedding, scale)
        normal(vis.positional_embedding, scale)
        _init_blocks(vis.blocks, v.width, normal)
        normal(vis.proj, scale)

    normal = drawer(torch.Generator().manual_seed((generator.initial_seed() + 1) % 2 ** 63))
    normal(txt.token_embedding, 0.02)
    normal(txt.positional_embedding, 0.01)
    _init_blocks(txt.blocks, t.width, normal)
    normal(txt.text_projection, t.width ** -0.5)
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
    return_all_tokens: bool = False,
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
    ``use_fused_mlp`` picks each block's MLP route where no ``mlp_post``
    hook needs the bare MLP output.  ``return_all_tokens`` returns the whole
    (B, N, width) stream after the blocks, before ln_post (the DeCLIP
    family's dense features).

    An RN tower (``spec.vision_rn``) takes (B, H, W, 3) float images and no
    PEFT hooks, and has no separate projection (it lives in the attention
    pool), as in the reference (model.py:1076-1084).

    A visual tower stacked over T trials (``full_finetune`` on a batch of
    trials: every parameter (T, ...), ``trial_axis``) takes the trials'
    images folded into x, (T*B, ...), and gives trial t's rows trial t's
    patch embedding, class and positional embeddings, LayerNorms, blocks
    and projection.
    """
    if spec.vision_rn is not None:
        if hooks is not None and (hooks.attn_delta is not None or hooks.mlp_post is not None):
            raise ValueError("PEFT hooks are ViT-only; RN towers load frozen (reference parity)")
        return encode_image_rn(clip.visual, x, spec=spec.vision_rn, compute_dtype=compute_dtype)
    v = spec.vision
    vp = clip.visual
    B = x.shape[0]
    p = v.patch_size
    dt = compute_dtype

    if x.dim() == 3:
        if patch_fold is None:
            raise ValueError("pre-patchified input requires patch_fold=(mean, std)")
        mean, std = (torch.as_tensor(t, device=x.device).float() for t in patch_fold)
        kernel32 = vp.patch_embed.kernel.float()  # (p*p*3, width), or (T, ...)
        s = (1.0 / (255.0 * std)).repeat(p * p)
        t = (-mean / std).repeat(p * p)
        x = trial_axis.add(trial_axis.matmul(x.to(dt), (kernel32 * s[:, None]).to(dt)),
                           (t @ kernel32).to(dt), 1)
    else:
        # patchify == non-overlapping conv == one GEMM (no bias)
        x = trial_axis.matmul(patchify_images(x.to(dt), p), vp.patch_embed.kernel.to(dt))
    cls = trial_axis.rows(vp.class_embedding.to(dt), B, 1).unsqueeze(1)
    x = trial_axis.add(torch.cat([cls, x], dim=1), vp.positional_embedding.to(dt), 2)
    x = layer_norm(x, vp.ln_pre.scale, vp.ln_pre.bias)

    for i, blk in enumerate(vp.blocks):
        delta_fn = post_fn = None
        if hooks is not None and hooks.attn_delta is not None:
            delta_fn = partial(hooks.attn_delta, peft.shared, peft.layers[i], generator)
        if hooks is not None and hooks.mlp_post is not None:
            post_fn = partial(hooks.mlp_post, peft.shared, peft.layers[i], generator)
        x = residual_attention_block(blk, x, n_head=v.heads, qv_delta_fn=delta_fn,
                                     mlp_post_fn=post_fn, use_fused_mlp=use_fused_mlp)

    if return_all_tokens:
        return x
    x = layer_norm(x[:, 0, :], vp.ln_post.scale, vp.ln_post.bias)
    if not apply_proj:
        return x
    return trial_axis.matmul(x, vp.proj.to(x.dtype))


def encode_text(clip: CLIP, tokens: torch.Tensor, *, spec: CLIPSpec,
                compute_dtype: torch.dtype = torch.float32, ln_eps: float = 1e-5) -> torch.Tensor:
    """Text tower forward (reference model.py:1154-1167): (B, context_length)
    token ids -> (B, embed_dim), read at each sequence's EOT token (its
    highest id, the first one on ties).  Causal attention on the plain path
    and the unfused MLP, as the reference's text tower runs them;
    ``ln_eps`` is 1e-5 for OpenAI CLIP (1e-12 for clip_swin's text tower)."""
    t = spec.text
    tp = clip.text
    dt = compute_dtype
    x = tp.token_embedding[tokens].to(dt) + tp.positional_embedding.to(dt)
    mask = causal_mask(t.context_length, device=x.device)
    for blk in tp.blocks:
        x = residual_attention_block(blk, x, n_head=t.heads, mask=mask, use_fused_mlp=False,
                                     ln_eps=ln_eps)
    x = layer_norm(x, tp.ln_final.scale, tp.ln_final.bias, eps=ln_eps)
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return x @ tp.text_projection.to(x.dtype)
