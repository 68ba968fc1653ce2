"""Zero-shot CLIP evaluation.

Counterpart of ``pevit_tpu/evaluation/zeroshot.py`` (reference
clip_zeroshot_evaluator.py:9-22): logits are ``100 * normalize(image
features) @ text_weights``, softmaxed, then scored with the dataset metric.
Image features run in float32, as the reference's do (``encode_image`` with
no compute dtype), so on the card the tower runs the float32 bodies of the
attention and fused-MLP kernels, in chunks of 256 images.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.clip import CLIP, CLIPSpec, encode_image
from .metrics import get_metric


def extract_image_features(config, clip: CLIP, spec: CLIPSpec, images_u8, *,
                           chunk: int = 256) -> np.ndarray:
    """(N, H, W, 3) uint8 images (numpy or a tensor) -> (N, embed_dim)
    float32 features, on the tower's device.  The last chunk is zero-padded
    to ``chunk`` images, as the reference pads it: the plain tower has no
    cross-row mixing, so a padded row cannot change a real row's feature."""
    dev = clip.visual.proj.device
    mean = torch.as_tensor(np.asarray(config.INPUT.MEAN, np.float32), device=dev)
    std = torch.as_tensor(np.asarray(config.INPUT.STD, np.float32), device=dev)
    feats = []
    n = len(images_u8)
    with torch.no_grad():
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            batch = torch.as_tensor(images_u8[s:e]).to(dev)
            if e - s < chunk:
                pad = torch.zeros((chunk - (e - s), *batch.shape[1:]), dtype=batch.dtype,
                                  device=dev)
                batch = torch.cat([batch, pad])
            x = batch.to(torch.float32) / 255.0
            x = (x - mean) / std
            feats.append(encode_image(clip, x, spec=spec)[: e - s].cpu().numpy())
    return np.concatenate(feats).astype(np.float32)


def clip_zeroshot_evaluator(image_features, text_features, image_labels, config):
    """(score, logits, metric name) of zero-shot classification; a metric
    that raises scores 0.0, as in the reference."""
    image_features = np.asarray(image_features, np.float32)
    image_features /= np.linalg.norm(image_features, axis=-1, keepdims=True) + 1e-12
    logits = 100.0 * image_features @ np.asarray(text_features, np.float32)
    z = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(z)
    probs /= probs.sum(axis=-1, keepdims=True)
    metric = get_metric(config.TEST.METRIC or "accuracy")
    try:
        result = 100.0 * metric(np.asarray(image_labels), probs)
    except Exception:  # noqa: BLE001 - the reference scores any metric error 0
        result = 0.0
    logging.info("=> Zero-shot %s: %.3f", getattr(metric, "__name__", "metric"), result)
    return result, logits, getattr(metric, "__name__", "accuracy")
