"""Auxiliary backbones through ``get_model`` (counterpart of
``pevit_tpu/models``): the generic ViT (timm / DeiT / MAE / MoCo-v3), the
DeCLIP family and the plugin templates.  Swin, CLIP-Swin and NNCLR are not
ported yet (ROADMAP §1 item 3)."""

from .declip import (
    Declip,
    DeclipSpec,
    declip_state_dict_to_params,
    encode_image_dense,
    encode_text_dense,
    init_declip_params,
    normalize_declip_state_dict,
)
from .factory import Backbone, get_model
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
    "Declip",
    "DeclipSpec",
    "ViT",
    "ViTSpec",
    "declip_state_dict_to_params",
    "encode_image_dense",
    "encode_text_dense",
    "get_model",
    "init_declip_params",
    "init_vit_params",
    "normalize_declip_state_dict",
    "normalize_vit_state_dict",
    "sincos_pos_embed_2d",
    "timm_state_dict_to_params",
    "vit_forward",
    "vit_forward_features",
]
