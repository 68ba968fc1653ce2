from .clip import (
    CLIP,
    BlockHooks,
    CLIPSpec,
    TextSpec,
    VisionSpec,
    VisionTransformer,
    encode_image,
    init_clip_params,
)

__all__ = [
    "CLIP",
    "BlockHooks",
    "CLIPSpec",
    "TextSpec",
    "VisionSpec",
    "VisionTransformer",
    "encode_image",
    "init_clip_params",
]
