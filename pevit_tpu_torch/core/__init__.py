from .clip import (
    CLIP,
    BlockHooks,
    CLIPSpec,
    TextSpec,
    VisionSpec,
    VisionTransformer,
    encode_image,
    init_clip_params,
    patchify_images,
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
    "patchify_images",
]
