from .clip import (
    CLIP,
    BlockHooks,
    CLIPSpec,
    TextSpec,
    TextTransformer,
    VisionSpec,
    VisionTransformer,
    encode_image,
    encode_text,
    init_clip_params,
    patchify_images,
)

__all__ = [
    "CLIP",
    "BlockHooks",
    "CLIPSpec",
    "TextSpec",
    "TextTransformer",
    "VisionSpec",
    "VisionTransformer",
    "encode_image",
    "encode_text",
    "init_clip_params",
    "patchify_images",
]
