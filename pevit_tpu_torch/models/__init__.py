"""Auxiliary backbones through ``get_model`` (counterpart of
``pevit_tpu/models``): the generic ViT (timm / DeiT / MAE / MoCo-v3), the
Swin classifiers and CLIP-Swin, the DeCLIP family and the plugin
templates; and the DeCLIP pretraining aids, NNCLR's memory bank and the
cross-rank contrastive logits."""

from .declip import (
    Declip,
    DeclipSpec,
    declip_state_dict_to_params,
    encode_image_dense,
    encode_text_dense,
    gathered_contrastive_logits,
    init_declip_params,
    normalize_declip_state_dict,
)
from .factory import Backbone, get_model
from .nnclr import MemoryBankState, enqueue, init_memory_bank, nearest_neighbours, nn_replace
from .swin import (
    ClipSwin,
    Swin,
    SwinSpec,
    clip_swin_state_dict_to_params,
    init_clip_swin_params,
    init_swin_params,
    swin_base,
    swin_forward,
    swin_forward_features,
    swin_state_dict_to_params,
    swin_tiny,
)
from .vit import (
    ViT,
    ViTSpec,
    init_vit_params,
    normalize_vit_state_dict,
    sincos_pos_embed_2d,
    timm_state_dict_to_params,
    vit_forward,
    vit_forward_features,
)

__all__ = [
    "Backbone",
    "ClipSwin",
    "Declip",
    "DeclipSpec",
    "MemoryBankState",
    "Swin",
    "SwinSpec",
    "ViT",
    "ViTSpec",
    "clip_swin_state_dict_to_params",
    "declip_state_dict_to_params",
    "encode_image_dense",
    "encode_text_dense",
    "enqueue",
    "gathered_contrastive_logits",
    "get_model",
    "init_clip_swin_params",
    "init_declip_params",
    "init_memory_bank",
    "init_swin_params",
    "init_vit_params",
    "nearest_neighbours",
    "nn_replace",
    "normalize_declip_state_dict",
    "normalize_vit_state_dict",
    "sincos_pos_embed_2d",
    "swin_base",
    "swin_forward",
    "swin_forward_features",
    "swin_state_dict_to_params",
    "swin_tiny",
    "timm_state_dict_to_params",
    "vit_forward",
    "vit_forward_features",
]
