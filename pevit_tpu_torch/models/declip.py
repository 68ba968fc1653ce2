"""The DeCLIP model family as frozen feature extractors: CLIP-YFCC, DeCLIP,
SLIP, FILIP and DeFILIP.

Counterpart of ``pevit_tpu/models/declip.py`` (reference models/declip.py
and models/declip_model/).  ``declip_*``, ``slip_*`` and ``clip_yfcc_*``
give pooled features (``encode_image`` / ``encode_text``); ``filip_*`` and
``defilip_*`` give per-token features through the FILIP mapping heads
(``encode_image_dense`` / ``encode_text_dense``), which the caller
flattens to (N, -1).

* The visual tower is the OpenAI-CLIP ViT (visual_transformer.py:6-84), so
  it is ``core.clip``'s: its blocks reach the attention kernel and, on the
  fused route, the fused-MLP kernel.  Dense features are the stream after
  the blocks without the CLS token, before ln_post and unprojected.
* The text tower differs from OpenAI CLIP in one way: ``text_projection``
  is a Linear (kernel and bias).  ``positional_embedding_flag`` gates the
  positional embedding (text_transformer.py:189).
* FILIP / DeFILIP add the Linear heads ``image_mapping`` and
  ``text_mapping`` and a ``logit_scale_dense``; the dense text features are
  the whole ln_final'd sequence before ``text_projection``.

The pretraining-only subtrees of published checkpoints are ignored on load
(``_IGNORED_PREFIXES``), as the reference loads them with strict=False.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch
from torch import nn

from ..core.clip import CLIPSpec, TextSpec, TextTransformer, VisionSpec, VisionTransformer
from ..core.clip import encode_image as _clip_encode_image
from ..core.clip import init_clip_params
from ..core.layers import Dense, causal_mask, layer_norm, linear, residual_attention_block


@dataclasses.dataclass(frozen=True)
class DeclipSpec:
    """One spec for the whole family; ``variant`` picks the eval surface."""

    variant: str = "declip"  # declip | clip_yfcc | slip | filip | defilip
    embed_dim: int = 512
    vision: VisionSpec = dataclasses.field(default_factory=VisionSpec)
    text: TextSpec = dataclasses.field(default_factory=TextSpec)
    dense_embed_dim: int = 256  # the FILIP mapping heads' width (filip.py:27)
    positional_embedding_flag: bool = True

    @property
    def dense_eval(self) -> bool:
        return self.variant in ("filip", "defilip")

    @property
    def clip(self) -> CLIPSpec:
        return CLIPSpec(embed_dim=self.embed_dim, vision=self.vision, text=self.text)

    @staticmethod
    def from_config(config) -> "DeclipSpec":
        """From MODEL.SPEC (resources/model/vitb32_DeCLIP.yaml etc.).

        ``SPEC.DECLIP.image_encode.embed_dim`` is the projection width.  At
        224 px the towers are the fixed visual_transformer_B32/B16 (width
        768, 12 layers, 12 heads); at another resolution (small test
        models) MODEL.SPEC.VISION's width, patch and layers.  The YAMLs'
        VOCAB_SIZE 49408 is read as 49409, the family's vocabulary with
        ``<|mask|>`` (text_transformer.py:38-39)."""
        spec = config.MODEL.SPEC
        name = str(config.MODEL.NAME).lower()
        declip_node = spec.get("DECLIP", {}) or {}
        image_encode = declip_node.get("image_encode", {}) or {}
        embed = image_encode.get("embed_dim", spec.get("EMBED_DIM", 512))
        patch = 16 if "b16" in name else 32
        variant = name.split("_")[0]
        if name.startswith(("clip_yfcc", "declip_yfcc")):
            variant = "clip_yfcc"
        text_node = spec.get("TEXT", {}) or {}
        res = config.TRAIN.IMAGE_SIZE[0]
        vocab = text_node.get("VOCAB_SIZE", 49408)
        if vocab == 49408:
            vocab = 49409
        if res == 224:
            vision = VisionSpec(input_resolution=res, patch_size=patch, width=768, layers=12,
                                heads=12, output_dim=embed)
        else:
            vnode = spec.get("VISION", {}) or {}
            vwidth = vnode.get("WIDTH", 768)
            vision = VisionSpec(input_resolution=res, patch_size=vnode.get("PATCH_SIZE", patch),
                                width=vwidth, layers=vnode.get("LAYERS", 12),
                                heads=max(1, vwidth // 64), output_dim=embed)
        return DeclipSpec(
            variant=variant,
            embed_dim=embed,
            vision=vision,
            text=TextSpec(
                context_length=text_node.get("CONTEXT_LENGTH", 77),
                vocab_size=vocab,
                width=text_node.get("WIDTH", 512),
                heads=text_node.get("HEADS", 8),
                layers=text_node.get("LAYERS", 12),
                output_dim=embed,
            ),
        )


class DeclipText(TextTransformer):
    """The family's text tower: CLIP's, with a Linear ``text_projection``."""

    def __init__(self, t: TextSpec, embed_dim: int):
        super().__init__(t)
        del self.text_projection
        self.text_projection = Dense(t.width, embed_dim)


class Declip(nn.Module):
    """Parameters of a DeCLIP-family model (the reference's tree: ``visual``,
    ``text``, ``logit_scale``, and for the dense variants ``image_mapping``,
    ``text_mapping`` and ``logit_scale_dense``)."""

    def __init__(self, spec: DeclipSpec):
        super().__init__()
        self.visual = VisionTransformer(spec.vision)
        self.text = DeclipText(spec.text, spec.embed_dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        if spec.dense_eval:
            self.image_mapping = Dense(spec.vision.width, spec.dense_embed_dim)
            self.text_mapping = Dense(spec.text.width, spec.dense_embed_dim)
            self.logit_scale_dense = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))


def init_declip_params(generator: torch.Generator, spec: DeclipSpec, *, device=None) -> Declip:
    """Random weights with the reference's distributions: the CLIP towers of
    ``init_clip_params``, ``text_projection``'s kernel N(0, 1/width) and
    bias zero, the mapping heads U(+-1/sqrt(fan_in)) with zero biases."""
    from ..utils.device import resolve_device

    clip = init_clip_params(generator, spec.clip, device="cpu")
    model = Declip(spec)
    model.visual = clip.visual
    t = spec.text
    with torch.no_grad():
        for name in ("token_embedding", "positional_embedding"):
            getattr(model.text, name).copy_(getattr(clip.text, name))
        model.text.blocks, model.text.ln_final = clip.text.blocks, clip.text.ln_final
        model.text.text_projection.kernel.copy_(
            torch.randn(t.width, spec.embed_dim, generator=generator) * t.width ** -0.5)
        if spec.dense_eval:
            for dense, fan_in in ((model.image_mapping, spec.vision.width),
                                  (model.text_mapping, t.width)):
                lim = (1.0 / fan_in) ** 0.5
                dense.kernel.copy_((torch.rand(dense.kernel.shape, generator=generator) * 2 - 1)
                                   * lim)
    return model.to(resolve_device(device))


def encode_image(model: Declip, x: torch.Tensor, *, spec: DeclipSpec,
                 compute_dtype: torch.dtype = torch.float32,
                 use_fused_mlp: bool = True) -> torch.Tensor:
    """Pooled image features: ln_post(CLS) @ proj (visual_transformer.py:53-79).
    ``use_fused_mlp`` is the blocks' MLP route: the fused kernel for a
    frozen tower, the unfused MLP where its weights train (a tower stacked
    over trials, ``core.clip.encode_image``)."""
    return _clip_encode_image(model, x, spec=spec.clip, compute_dtype=compute_dtype,
                              use_fused_mlp=use_fused_mlp)


def encode_image_dense(model: Declip, x: torch.Tensor, *, spec: DeclipSpec,
                       compute_dtype: torch.dtype = torch.float32,
                       use_fused_mlp: bool = True) -> torch.Tensor:
    """FILIP dense image features: image_mapping of the patch tokens after
    the blocks, before ln_post and unprojected (filip.py:58-61).  A model
    stacked over trials maps trial t's rows with its own image_mapping."""
    tokens = _clip_encode_image(model, x, spec=spec.clip, compute_dtype=compute_dtype,
                                use_fused_mlp=use_fused_mlp, return_all_tokens=True)
    return linear(tokens[:, 1:, :].float(), model.image_mapping)


def _text_trunk(model: Declip, tokens: torch.Tensor, *, spec: DeclipSpec, compute_dtype):
    """The ln_final'd sequence (text_transformer.py:184-194); causal
    attention on the plain path and the unfused MLP, as CLIP's text tower."""
    t, tp, dt = spec.text, model.text, compute_dtype
    x = tp.token_embedding[tokens].to(dt)
    if spec.positional_embedding_flag:
        x = x + tp.positional_embedding.to(dt)
    mask = causal_mask(t.context_length, device=x.device)
    for blk in tp.blocks:
        x = residual_attention_block(blk, x, n_head=t.heads, mask=mask, use_fused_mlp=False)
    return layer_norm(x, tp.ln_final.scale, tp.ln_final.bias)


def encode_text(model: Declip, tokens: torch.Tensor, *, spec: DeclipSpec,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pooled text features: the Linear text_projection of the EOT position
    (the highest id, the first one on ties; text_transformer.py:203)."""
    x = _text_trunk(model, tokens, spec=spec, compute_dtype=compute_dtype)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return linear(pooled.float(), model.text.text_projection)


def encode_text_dense(model: Declip, tokens: torch.Tensor, *, spec: DeclipSpec,
                      compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """FILIP dense text features: text_mapping of the whole ln_final'd
    sequence, before text_projection (filip.py:53-56)."""
    x = _text_trunk(model, tokens, spec=spec, compute_dtype=compute_dtype)
    return linear(x.float(), model.text_mapping)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

# pretraining-only subtrees of published checkpoints, outside the eval
# surface (the reference loads with strict=False; models/declip.py:31)
_IGNORED_PREFIXES = (
    "projector",             # SimSiam projection MLP (declip.py:132)
    "predictor",             # SimSiam prediction MLP (declip.py:134), SLIP's predictor_sim
    "nn_replacer",           # NNCLR memory banks (declip.py:168-169)
    "text_label_predictor",  # the MLM head (declip.py:165)
    "caption_module",        # captioning head (filip.py:46)
    "sample_capture",
)


def normalize_declip_state_dict(obj: dict) -> dict:
    """Unwrap ``{'model': ...}`` / ``{'state_dict': ...}`` nesting and strip
    ``module.`` prefixes (reference models/declip.py:24-29)."""
    sd = obj
    for wrap in ("model", "state_dict"):
        if wrap in sd and isinstance(sd[wrap], dict):
            sd = sd[wrap]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def declip_state_dict_to_params(sd: dict, *, input_resolution: int = 224) -> tuple:
    """A DeCLIP-family state dict -> (the reference's tree as float32 numpy,
    DeclipSpec).

    Layout (declip_model/clip.py:48-57, slip.py:81-87): ``visual.*`` in the
    OpenAI-CLIP ViT layout; the text tower under ``encode_text.*`` or, for
    SLIP, ``text_encoder.*``, with ``text_projection.{weight,bias}``;
    ``logit_scale`` of shape (1,); FILIP / DeFILIP's ``image_mapping.*``,
    ``text_mapping.*`` and ``logit_scale_dense``."""
    from ..ckpt.torch_loader import _ln, _stack_blocks

    sd = {k: np.asarray(v, np.float32) for k, v in sd.items() if hasattr(v, "shape")}
    text_prefix = "encode_text" if any(k.startswith("encode_text.") for k in sd) else "text_encoder"
    tsub = {k[len(text_prefix) + 1:]: v for k, v in sd.items() if k.startswith(text_prefix + ".")}

    conv = sd["visual.conv1.weight"]  # (width, 3, p, p)
    width, _, p, _ = conv.shape
    n_vis_layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
    twidth = tsub["token_embedding.weight"].shape[1]
    n_txt_layers = len({k.split(".")[2] for k in tsub if k.startswith("transformer.resblocks.")})
    embed_dim = sd["visual.proj"].shape[1]
    dense = "image_mapping.weight" in sd
    spec = DeclipSpec(
        variant="filip" if dense else "declip",
        embed_dim=embed_dim,
        vision=VisionSpec(input_resolution=input_resolution, patch_size=p, width=width,
                          layers=n_vis_layers, heads=max(1, width // 64), output_dim=embed_dim),
        text=TextSpec(context_length=tsub["positional_embedding"].shape[0],
                      vocab_size=tsub["token_embedding.weight"].shape[0], width=twidth,
                      heads=max(1, twidth // 64), layers=n_txt_layers, output_dim=embed_dim),
        dense_embed_dim=sd["image_mapping.weight"].shape[0] if dense else 256,
    )
    params = {
        "visual": {
            "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, width)},
            "class_embedding": sd["visual.class_embedding"],
            "positional_embedding": sd["visual.positional_embedding"],
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _stack_blocks(sd, "visual.transformer.resblocks", n_vis_layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": sd["visual.proj"],
        },
        "text": {
            "token_embedding": tsub["token_embedding.weight"],
            "positional_embedding": tsub["positional_embedding"],
            "blocks": _stack_blocks(tsub, "transformer.resblocks", n_txt_layers),
            "ln_final": _ln(tsub, "ln_final"),
            "text_projection": {"kernel": tsub["text_projection.weight"].T,
                                "bias": tsub["text_projection.bias"]},
        },
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    if dense:
        for name in ("image_mapping", "text_mapping"):
            params[name] = {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}
        params["logit_scale_dense"] = sd["logit_scale_dense"].reshape(())

    handled = ("visual.", text_prefix + ".", "logit_scale", "image_mapping.", "text_mapping.")
    leftovers = [k for k in sd if not k.startswith(handled) and not k.startswith(_IGNORED_PREFIXES)]
    if leftovers:
        logging.warning("declip ckpt: %d unmapped keys (e.g. %s)", len(leftovers), leftovers[:5])
    return params, spec


def declip_from_params(params_np: dict, spec: DeclipSpec, *, device=None) -> Declip:
    """The reference's DeCLIP tree as numpy -> the port's ``Declip``."""
    from ..bridge import module_from_jax

    return module_from_jax(params_np, Declip(spec), device=device)


class _AllGather(torch.autograd.Function):
    """Every rank's rows of ``x`` over a process group, in rank order; the
    backward sums the gradient of each slice over the group and returns this
    rank's (the transpose of ``jax.lax.all_gather(tiled=True)``, and the
    reference's AllGather, declip_model/clip.py:20-44)."""

    @staticmethod
    def forward(ctx, x, axis):
        from ..parallel.collectives import gather_dim

        ctx.axis, ctx.rows = axis, x.shape[0]
        return gather_dim(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        lo = ctx.axis.index * ctx.rows
        return g[lo:lo + ctx.rows], None


def gathered_contrastive_logits(image_features: torch.Tensor, text_features: torch.Tensor,
                                logit_scale: torch.Tensor, group=None) -> torch.Tensor:
    """Cross-rank contrastive logits: this rank's images against the text
    batch of every rank of ``group`` (the world when None), each rank
    holding equally many rows; ``exp(logit_scale) * normalise(images) @
    normalise(all texts)ᵀ``.  The gather is differentiable
    (:class:`_AllGather`), as ``pevit_tpu/models/declip.py:349-360``'s
    ``all_gather`` over the data axis."""
    import torch.distributed as dist

    from ..parallel.collectives import Axis

    if dist.is_available() and dist.is_initialized():
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        axis = Axis(group or dist.group.WORLD, len(ranks), ranks.index(dist.get_rank()))
        all_text = text_features if axis.size == 1 else _AllGather.apply(text_features, axis)
    else:
        all_text = text_features
    imf = image_features / torch.linalg.vector_norm(image_features, dim=-1, keepdim=True)
    txf = all_text / torch.linalg.vector_norm(all_text, dim=-1, keepdim=True)
    return torch.exp(logit_scale) * imf @ txf.T
