"""Task configuration and the model forward (serving subset of
``pevit_tpu/train/trainer.py``).

The training loop, loss and optimiser come with the training slice; this
module holds what the serving path needs: the static task description and
``model_forward`` from raw uint8 images to logits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.clip import CLIPSpec, encode_image
from ..peft.base import PEFT_METHODS, PeftConfig, make_hooks
from ..utils.device import compute_dtype
from .head import head_forward


@dataclasses.dataclass(frozen=True)
class TaskStatic:
    """Static task configuration (the serving fields of the reference's)."""

    spec: CLIPSpec
    peft_cfg: PeftConfig
    num_classes: int
    use_bn: bool = True
    normalize_feature: bool = False
    apply_logit_scale: bool = False
    compute_dtype: str = "bfloat16"
    merge_encoder_head_proj: bool = False
    feat_dim: int = 0  # 0 => spec.embed_dim (classifier-head input width)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)

    @property
    def head_dim(self) -> int:
        if self.feat_dim:
            return self.feat_dim
        if self.merge_encoder_head_proj:
            return self.spec.vision.width
        return self.spec.embed_dim


def trainable_pred(static: TaskStatic):
    """Bundle-path trainability at module granularity: the head and the
    PEFT parameters train; the CLIP tower only under full_finetune."""
    method = static.peft_cfg.method

    def pred(path: tuple) -> bool:
        top = path[0]
        if top == "head":
            return True
        if top == "peft":
            return method in PEFT_METHODS
        if top == "clip":
            return method == "full_finetune"
        return False

    return pred


def model_forward(
    static: TaskStatic,
    bundle: dict,
    bn_state: dict,
    images_u8: torch.Tensor,
    preproc: dict,
    *,
    train: bool,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
):
    """(B, H, W, 3) uint8 images -> (logits float32, bn_state).

    Normalisation runs on the images' device in the compute dtype:
    ``x = u8 / 255`` then ``(x - mean) / std``."""
    if images_u8.dim() != 4:
        raise ValueError(f"want (B, H, W, 3) uint8 images, got {tuple(images_u8.shape)}")
    dt = static.dtype
    x = images_u8.to(dt) / torch.tensor(255.0, dtype=dt, device=images_u8.device)
    x = (x - preproc["mean"].to(dt)) / preproc["std"].to(dt)
    feats = encode_image(
        bundle["clip"],
        x,
        spec=static.spec,
        peft=bundle.get("peft"),
        hooks=make_hooks(static.peft_cfg, static.spec, train=train),
        generator=generator,
        compute_dtype=dt,
        apply_proj=not static.merge_encoder_head_proj,
    )
    return head_forward(
        bundle["head"],
        bn_state,
        feats.float(),
        train=train,
        mask=mask,
        use_bn=static.use_bn,
        normalize_feature=static.normalize_feature,
        apply_logit_scale=static.apply_logit_scale,
    )
