"""The backbone factory: ``get_model(config)``.

Counterpart of ``pevit_tpu/models/factory.py`` (reference
evaluation/feature.py:241-317), which dispatches MODEL.NAME over the CLIP
checkpoints (ViT and RN), the timm / DeiT / MAE / MoCo-v3 ViTs, the Swin
classifiers, CLIP-Swin and the DeCLIP family.  Returns a ``Backbone``: the
parameter module and ``forward_features(params, images_float,
use_fused_mlp=True, trials=0) -> (B, feat_dim)``, plus ``encode_text(params,
tokens)`` for dual-tower models and ``forward_features_train(params,
images_float, generator, trials=0)`` for a backbone that is stochastic in
training (Swin's stochastic depth and dropout).

``trials`` > 0 is a batch of T trials (``TrainTask.train_trials``): the
images are the trials' batches folded, (T*B, ...), trial-major, and the
features come back folded the same way.  ``params`` is then the task's own
module, shared by every trial (a frozen backbone), or a copy whose
parameters are stacked (T, ...) over the trials (``full_finetune``,
``train.partition.stack_trials``), which the forwards apply trial by trial
(``core.trial_axis``); ``generator`` is one generator per trial.

``use_fused_mlp`` is the MLP route of a CLIP-layout visual tower (CLIP
ViTs, the DeCLIP family): the fused kernel while the tower is frozen, the
unfused MLP where its weights train (the trainer passes its task's route).
The generic ViTs' blocks carry the erf GELU and always take the unfused
MLP; Swin's blocks are plain PyTorch; the plugins ignore it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import torch

from ..core import trial_axis
from ..utils.device import resolve_device
from . import declip as _declip
from . import swin as _swin
from . import vit as _vit


@dataclasses.dataclass
class Backbone:
    """One facade over the backbone family."""

    name: str
    params: torch.nn.Module
    feat_dim: int
    # (params, images_float, use_fused_mlp=True, trials=0) -> (B, feat_dim)
    forward_features: Callable
    encode_text: Optional[Callable] = None  # (params, tokens) -> (B, feat_dim)
    # the tokenizer of the text tower's vocabulary; None -> OpenAI CLIP's.
    # The DeCLIP family's vocabulary has <|mask|> inserted.
    tokenize: Optional[Callable] = None
    # the train-mode forward of a backbone that is stochastic in training
    # (Swin's stochastic depth, cls_swin.py:209,280-281): (params,
    # images_float, generator, trials=0) -> (B, feat_dim), one generator per
    # trial when ``trials``.  None -> train == eval.
    forward_features_train: Optional[Callable] = None


def _swin_spec_from_cfg(mspec, default_spec: _swin.SwinSpec) -> _swin.SwinSpec:
    """The Swin architecture keys the reference reads from the model spec
    (cls_swin.py:690-704 at its top level; clip_swin.py:175-194 under VISION)."""
    in_chans = int(mspec.get("IN_CHANS", 3))
    if in_chans != 3:
        raise ValueError(f"IN_CHANS={in_chans} unsupported (RGB only)")
    qk_scale = mspec.get("QK_SCALE", None)
    return dataclasses.replace(
        default_spec,
        patch_size=int(mspec.get("PATCH_SIZE", default_spec.patch_size)),
        embed_dim=int(mspec.get("EMBED_DIM", default_spec.embed_dim)),
        depths=tuple(mspec.get("DEPTHS", default_spec.depths)),
        num_heads=tuple(mspec.get("NUM_HEADS", default_spec.num_heads)),
        window_size=int(mspec.get("WINDOW_SIZE", default_spec.window_size)),
        mlp_ratio=float(mspec.get("MLP_RATIO", default_spec.mlp_ratio)),
        drop_rate=float(mspec.get("DROP_RATE", default_spec.drop_rate)),
        ape=bool(mspec.get("APE", default_spec.ape)),
        patch_norm=bool(mspec.get("PATCH_NORM", default_spec.patch_norm)),
        qkv_bias=bool(mspec.get("QKV_BIAS", default_spec.qkv_bias)),
        qk_scale=None if qk_scale is None else float(qk_scale),
        layer_scale=bool(mspec.get("LAYER_SCALE", default_spec.layer_scale)),
    )


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
            forward_features=lambda p, x, use_fused_mlp=True, trials=0: encode_image(
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
            forward_features=lambda p, x, use_fused_mlp=True, trials=0: (
                _vit.vit_forward_features(p, x, spec=spec)),
        )

    # the Swin classifiers (models/cls_swin.py:683-713)
    if name.startswith(("cls_swin", "swin")):
        mspec = config.MODEL.SPEC if "SPEC" in config.MODEL else {}
        drop_path = float(mspec.get("DROP_PATH_RATE", 0.0))  # cls_swin.py:699
        layer_scale = bool(mspec.get("LAYER_SCALE", False))  # cls_swin.py:704
        if not config.MODEL.INIT_WEIGHTS:
            raise ValueError(
                "MODEL.INIT_WEIGHTS=False is not supported: params are "
                "created with the trunc-normal init (cls_swin.py:706 "
                "semantics); load a checkpoint instead of disabling init")
        if ckpt_file:
            from ..ckpt.torch_loader import read_torch_state_dict

            raw = read_torch_state_dict(ckpt_file)
            if "model" in raw and isinstance(raw["model"], dict):
                raw = raw["model"]
            params, spec = _swin.swin_state_dict_to_params(raw)
            # the input resolution and QK_SCALE are the config's
            # (cls_swin.py:697), whatever the checkpoint
            qk = mspec.get("QK_SCALE", None)
            spec = dataclasses.replace(spec, img_size=config.TRAIN.IMAGE_SIZE[0],
                                       drop_path_rate=drop_path,
                                       qk_scale=None if qk is None else float(qk))
            if layer_scale and not spec.layer_scale:
                raise ValueError("MODEL.SPEC.LAYER_SCALE=True but checkpoint has no gamma params")
            model = _swin.swin_from_params(params, spec, device=dev)
        else:
            spec = _swin.swin_base() if "base" in name else _swin.swin_tiny()
            spec = dataclasses.replace(_swin_spec_from_cfg(mspec, spec),
                                       img_size=config.TRAIN.IMAGE_SIZE[0],
                                       drop_path_rate=drop_path, layer_scale=layer_scale)
            model = _swin.init_swin_params(gen, spec, device=dev)
            logging.warning("=> %s: RANDOM init (no TEST.MODEL_FILE)", name)
        stochastic = spec.drop_path_rate > 0.0 or spec.drop_rate > 0.0
        return Backbone(
            name=name, params=model, feat_dim=spec.stage_dim(spec.num_stages - 1),
            forward_features=lambda p, x, use_fused_mlp=True, trials=0: (
                _swin.swin_forward_features(p, x, spec=spec)),
            forward_features_train=(
                (lambda p, x, generator, trials=0: _swin.swin_forward_features(
                    p, x, spec=spec, train=True, generator=generator)) if stochastic else None),
        )

    # CLIP with a Swin visual tower (models/clip_swin.py:253-284): image and
    # text features leave L2-normalised (clip_swin.py:246-260, norm=True)
    if name.startswith("clip_swin"):
        from ..core.clip import CLIPSpec, encode_text

        embed = config.MODEL.SPEC.get("EMBED_DIM", 512)
        # the reference takes the CLIP tokenizer only (clip_swin.py:158)
        tok_style = (config.MODEL.SPEC.get("TEXT", {}) or {}).get("TOKENIZER", "clip")
        if tok_style != "clip":
            raise ValueError(f"clip_swin supports only TOKENIZER 'clip', got {tok_style!r} "
                             "(reference clip_swin.py:158 asserts the same)")
        cspec = CLIPSpec.from_config(config)
        if ckpt_file:
            from ..ckpt.torch_loader import read_torch_state_dict

            params, sspec, cspec = _swin.clip_swin_state_dict_to_params(
                read_torch_state_dict(ckpt_file))
            # QK_SCALE is the config's even with a checkpoint (clip_swin.py:187)
            qk = (config.MODEL.SPEC.get("VISION", {}) or {}).get("QK_SCALE", None)
            sspec = dataclasses.replace(sspec, img_size=config.TRAIN.IMAGE_SIZE[0],
                                        qk_scale=None if qk is None else float(qk))
            # the head count is not in a state dict; the YAML's is
            # authoritative (clip_swin.py:164)
            heads = (config.MODEL.SPEC.get("TEXT", {}) or {}).get("HEADS", cspec.text.heads)
            cspec = dataclasses.replace(cspec, text=dataclasses.replace(cspec.text, heads=heads))
            embed = cspec.embed_dim
            model = _swin.clip_swin_from_params(params, sspec, cspec, device=dev)
        else:
            sspec = _swin.swin_base() if "base" in name else _swin.swin_tiny()
            sspec = dataclasses.replace(
                _swin_spec_from_cfg(config.MODEL.SPEC.get("VISION", {}) or {}, sspec),
                img_size=config.TRAIN.IMAGE_SIZE[0])  # clip_swin.py:176
            model = _swin.init_clip_swin_params(gen, sspec, cspec, device=dev)
            logging.warning("=> %s: RANDOM init (no TEST.MODEL_FILE)", name)

        def fwd(p, x, use_fused_mlp=True, trials=0):
            feats = _swin.swin_forward_features(p.visual, x, spec=sspec)
            feats = trial_axis.matmul(feats.float(), p.vision_projection)
            return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)

        def txt(p, t):
            # the projection sits outside the text tower (clip_swin.py:171-173)
            # and the LayerNorms are TF-style, eps 1e-12 (clip_swin.py:24-39)
            x = encode_text(_swin.clip_swin_text_view(p), t, spec=cspec, ln_eps=1e-12)
            return x / torch.linalg.norm(x, dim=-1, keepdim=True)

        return Backbone(name=name, params=model, feat_dim=embed, forward_features=fwd,
                        encode_text=txt)

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
                forward_features=lambda p, x, use_fused_mlp=True, trials=0: (
                    _declip.encode_image_dense(p, x, spec=dspec, use_fused_mlp=use_fused_mlp)
                    .reshape(x.shape[0], -1)),
                encode_text=lambda p, t: _declip.encode_text_dense(
                    p, t, spec=dspec).reshape(t.shape[0], -1),
                tokenize=declip_tokenize,
            )
        return Backbone(
            name=name, params=model, feat_dim=dspec.embed_dim,
            forward_features=lambda p, x, use_fused_mlp=True, trials=0: _declip.encode_image(
                p, x, spec=dspec, use_fused_mlp=use_fused_mlp),
            encode_text=lambda p, t: _declip.encode_text(p, t, spec=dspec),
            tokenize=declip_tokenize,
        )

    raise ValueError(f"Unknown MODEL.NAME: {name!r} (feature.py get_model surface)")
