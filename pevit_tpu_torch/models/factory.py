"""The backbone factory: ``get_model(config)``.

Counterpart of ``pevit_tpu/models/factory.py`` (reference
evaluation/feature.py:241-317), which dispatches MODEL.NAME over the CLIP
checkpoints (ViT and RN), the timm / DeiT / MAE / MoCo-v3 ViTs, the Swin
classifiers, CLIP-Swin and the DeCLIP family.  Returns a ``Backbone``: the
parameter module and ``forward_features(params, images_float,
use_fused_mlp=True) -> (B, feat_dim)``, plus ``encode_text(params,
tokens)`` for dual-tower models.

The reference's ``Backbone.forward_features_train`` (a stochastic train
forward) serves Swin's stochastic depth only, and comes with Swin.

``use_fused_mlp`` is the MLP route of a CLIP-layout visual tower (CLIP
ViTs, the DeCLIP family): the fused kernel while the tower is frozen, the
unfused MLP where its weights train (the trainer passes its task's route).
The generic ViTs' blocks carry the erf GELU and always take the unfused
MLP; the plugins ignore it.

Not ported: the Swin classifiers and CLIP-Swin (``cls_swin*``, ``swin*``,
``clip_swin*``) raise with their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch

from ..utils.device import resolve_device
from . import declip as _declip
from . import vit as _vit

_SWIN_UNPORTED = ("MODEL.NAME={!r}: the Swin classifiers and CLIP-Swin are not ported "
                  "(ROADMAP §1 item 3, auxiliary backbones: Swin)")


@dataclasses.dataclass
class Backbone:
    """One facade over the backbone family."""

    name: str
    params: torch.nn.Module
    feat_dim: int
    forward_features: Callable  # (params, images_float, use_fused_mlp=True) -> (B, feat_dim)
    encode_text: Optional[Callable] = None  # (params, tokens) -> (B, feat_dim)
    # the tokenizer of the text tower's vocabulary; None -> OpenAI CLIP's.
    # The DeCLIP family's vocabulary has <|mask|> inserted.
    tokenize: Optional[Callable] = None


def _vit_spec_from_name(name: str) -> _vit.ViTSpec:
    return _vit.ViTSpec(patch_size=16 if "16" in name else 32,
                        sincos_pos=name.startswith("mocov3"))


def _vit_spec_from_cfg(mspec, default_spec: _vit.ViTSpec) -> _vit.ViTSpec:
    """The ViT architecture keys the reference's MAE / MoCo-v3 constructors read
    from MODEL.SPEC (mae.py:82-86, mocov3.py:145-147)."""
    mlp_ratio = float(mspec.get("MLP_RATIO", 4.0))
    if mlp_ratio != 4.0:
        raise ValueError(
            f"MODEL.SPEC.MLP_RATIO={mlp_ratio} unsupported (the ViT tower is "
            "built with the 4x MLP every shipped checkpoint uses)")
    if not bool(mspec.get("QKV_BIAS", True)):
        raise ValueError(
            "MODEL.SPEC.QKV_BIAS=False unsupported (qkv bias is always "
            "materialised; every reference MAE/MoCo config sets True)")
    return dataclasses.replace(
        default_spec,
        patch_size=int(mspec.get("PATCH_SIZE", default_spec.patch_size)),
        width=int(mspec.get("EMBED_DIM", default_spec.width)),
        layers=int(mspec.get("DEPTH", default_spec.layers)),
        heads=int(mspec.get("NUM_HEADS", default_spec.heads)),
    )


def get_model(config, *, device=None) -> Backbone:
    """A backbone from MODEL.NAME (and TEST.MODEL_FILE's checkpoint) on
    ``device`` (None -> CUDA).  Random weights come from a CPU generator
    seeded 0."""
    dev = resolve_device(device)
    name = config.MODEL.NAME
    ckpt_file = config.TEST.MODEL_FILE or None
    gen = torch.Generator().manual_seed(0)

    # the plugin stubs (the reference dispatches eval(MODEL.NAME + '.get_cls_model'))
    if name == "cls_example":
        from .examples import get_cls_example

        return get_cls_example(config, device=dev)
    if name == "clip_example":
        from .examples import get_clip_example

        return get_clip_example(config, device=dev)

    # OpenAI CLIP, ViT and RN
    if name.startswith(("ViT-B", "ViT-L", "RN")):
        from ..ckpt import load_clip
        from ..core.clip import CLIPSpec, encode_image, encode_text

        clip, spec = load_clip(name, checkpoint_path=config.MODEL.PRETRAINED or ckpt_file,
                               spec_hint=CLIPSpec.from_config(config), device=dev)
        return Backbone(
            name=name, params=clip, feat_dim=spec.embed_dim,
            forward_features=lambda p, x, use_fused_mlp=True: encode_image(
                p, x, spec=spec, use_fused_mlp=use_fused_mlp),
            encode_text=lambda p, t: encode_text(p, t, spec=spec),
        )

    # the timm-style / MAE / MoCo-v3 ViTs (feature.py:262-305)
    if name.startswith(("vit_", "deit_", "mae_", "mocov3_")):
        global_pool = bool(config.MODEL.SPEC.get("GLOBAL_POOL", False))
        if ckpt_file:
            from ..ckpt.torch_loader import read_torch_state_dict

            sd = _vit.normalize_vit_state_dict(read_torch_state_dict(ckpt_file))
            params, spec = _vit.timm_state_dict_to_params(sd, global_pool=global_pool)
            vit = _vit.vit_from_params(params, spec, device=dev)
        else:
            spec = dataclasses.replace(_vit_spec_from_name(name), global_pool=global_pool)
            spec = _vit_spec_from_cfg(config.MODEL.SPEC, spec)
            # the input resolution follows TRAIN.IMAGE_SIZE (mocov3.py:101-102)
            spec = dataclasses.replace(spec, input_resolution=config.TRAIN.IMAGE_SIZE[0])
            vit = _vit.init_vit_params(gen, spec, device=dev)
            logging.warning("=> %s: RANDOM init (no TEST.MODEL_FILE)", name)
        return Backbone(
            name=name, params=vit, feat_dim=spec.width,
            forward_features=lambda p, x, use_fused_mlp=True: _vit.vit_forward_features(
                p, x, spec=spec),
        )

    if name.startswith(("cls_swin", "swin", "clip_swin")):
        raise NotImplementedError(_SWIN_UNPORTED.format(name))

    # the DeCLIP family (models/declip.py:8-38, feature.py:262-281)
    if name.lower().startswith(("declip", "slip", "filip", "defilip", "clip_yfcc")):
        variant = name.split("_")[0].lower()
        if name.lower().startswith(("clip_yfcc", "declip_yfcc")):
            variant = "clip_yfcc"
        if ckpt_file:
            from ..ckpt.torch_loader import read_torch_state_dict

            sd = _declip.normalize_declip_state_dict(read_torch_state_dict(ckpt_file))
            params, dspec = _declip.declip_state_dict_to_params(
                sd, input_resolution=config.TRAIN.IMAGE_SIZE[0])
            dspec = dataclasses.replace(dspec, variant=variant)
            model = _declip.declip_from_params(params, dspec, device=dev)
        else:
            dspec = dataclasses.replace(_declip.DeclipSpec.from_config(config), variant=variant)
            model = _declip.init_declip_params(gen, dspec, device=dev)
            logging.warning("=> %s: RANDOM init (no TEST.MODEL_FILE)", name)

        from ..data.tokenizer import declip_tokenize

        if dspec.dense_eval:
            # FILIP / DeFILIP evaluate through the dense mapping heads,
            # flattened to (B, N * dense_dim) (feature.py:352)
            return Backbone(
                name=name, params=model,
                feat_dim=(dspec.vision.seq_len - 1) * dspec.dense_embed_dim,
                forward_features=lambda p, x, use_fused_mlp=True: _declip.encode_image_dense(
                    p, x, spec=dspec, use_fused_mlp=use_fused_mlp).reshape(x.shape[0], -1),
                encode_text=lambda p, t: _declip.encode_text_dense(
                    p, t, spec=dspec).reshape(t.shape[0], -1),
                tokenize=declip_tokenize,
            )
        return Backbone(
            name=name, params=model, feat_dim=dspec.embed_dim,
            forward_features=lambda p, x, use_fused_mlp=True: _declip.encode_image(
                p, x, spec=dspec, use_fused_mlp=use_fused_mlp),
            encode_text=lambda p, t: _declip.encode_text(p, t, spec=dspec),
            tokenize=declip_tokenize,
        )

    raise ValueError(f"Unknown MODEL.NAME: {name!r} (feature.py get_model surface)")
