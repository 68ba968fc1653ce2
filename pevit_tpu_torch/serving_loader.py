"""Resolve a serving callable from an artifact or a (config, checkpoint) pair.

Counterpart of ``pevit_tpu/serving_loader.py``, shared by the serving entry
points (``serve_daemon.main``, ``tools/serve_bench.py``): one place that
turns what the operator has (an exported ``.pt2`` artifact, a trained-state
npz directory, or just YAMLs) into an ``f(images_u8) -> logits`` callable
with its weights on the device.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

__all__ = ["load_serving_callable"]


def build_task(config, method: str, seed: int, device):
    """The task the training commands build: the CLIP ViT from its
    checkpoint (or random weights from ``seed``), the text-feature head when
    ``TRAIN.INIT_HEAD_WITH_TEXT_ENCODER``, and a fresh bundle from ``seed``."""
    from .ckpt import load_clip
    from .core.clip import CLIPSpec
    from .evaluation import extract_text_features
    from .peft import PeftConfig
    from .train import TaskStatic, TrainTask

    if int(config.DATASET.NUM_CLASSES) <= 0:
        raise ValueError(
            "DATASET.NUM_CLASSES is 0: pass the dataset YAML (--ds) the head "
            "was trained for, or override DATASET.NUM_CLASSES N — a serving "
            "classifier cannot be built without a class count")
    name = config.MODEL.NAME
    if not name.startswith(("ViT-B", "ViT-L")):
        raise NotImplementedError(f"MODEL.NAME={name!r}: only CLIP ViT backbones are ported "
                                  "(ROADMAP §1, auxiliary backbones)")
    model_file = config.TEST.MODEL_FILE if config.TEST.MODEL_FILE != "." else ""
    clip, spec = load_clip(name, checkpoint_path=model_file or config.MODEL.PRETRAINED or None,
                           seed=seed, spec_hint=CLIPSpec.from_config(config), device=device)
    # the text-initialised (zero-shot) head, as the export tool and the
    # training commands build it: a program-only artifact's bundle must be
    # rebuilt with the head init it was exported with
    text_weights = None
    if config.TRAIN.INIT_HEAD_WITH_TEXT_ENCODER:
        text_weights = extract_text_features(config, clip, spec)
    static = TaskStatic.from_config(config, spec, PeftConfig(method=method))
    task = TrainTask(config, static, clip, text_init_weights=text_weights, device=device)
    trainable, frozen, bn_state = task.init_bundle(torch.Generator().manual_seed(seed))
    return task, static, trainable, frozen, bn_state


def restore_into(weights_from: str, trainable: dict) -> None:
    """Copy the trained state saved under ``weights_from`` (``step_N.npz``,
    the latest step) into the trainable side of a bundle, in place."""
    from .ckpt import restore_trainable
    from .train import named_parameters

    params = named_parameters(trainable)
    with torch.no_grad():
        for name, t in restore_trainable(weights_from, trainable).items():
            params[name].copy_(t)


def load_serving_callable(*, artifact: str = "", config=None, method: str = "kadaptation",
                          weights_from: str = "", quantize: bool = False, seed: int = 0,
                          verbose: bool = True, device=None) -> Tuple[Callable, int]:
    """``(call_fn, image_size)``; ``call_fn(images_u8) -> logits`` on
    ``device`` (``None`` -> CUDA).

    Two modes:

    * ``artifact`` given: load it.  A baked artifact is self-contained; a
      program-only one also needs ``config`` (and ``weights_from`` for the
      trained state) to rebuild its weight bundle as the export did.
    * no artifact: export a program-only artifact from ``config``, restoring
      ``weights_from`` if given, as a serving host deploying straight from a
      checkpoint does.
    """
    from .serve import (export_classifier, exported_callable, exported_image_size, is_baked,
                        load_exported, serving_weights)
    from .utils.device import resolve_device

    dev = resolve_device(device)
    if artifact:
        ep = load_exported(artifact)
        image_size = exported_image_size(ep)
        if is_baked(ep):
            return exported_callable(ep, device=dev), image_size
        if config is None:
            raise ValueError(
                "program-only artifact: pass the export-time config "
                "(--model/--ds/--method) so the weight bundle can be rebuilt")
        _, _, trainable, frozen, bn_state = build_task(config, method, seed, dev)
        if weights_from:
            restore_into(weights_from, trainable)
        weights = serving_weights(trainable, frozen, bn_state, quantize=quantize)
        return exported_callable(ep, weights, device=dev), image_size

    if config is None:
        raise ValueError("need an artifact or a config")
    task, static, trainable, frozen, bn_state = build_task(config, method, seed, dev)
    if weights_from:
        restore_into(weights_from, trainable)
    image_size = config.TRAIN.IMAGE_SIZE[0]
    t0 = time.time()
    ep = export_classifier(static, trainable, frozen, bn_state, task.preproc,
                           image_size=image_size, bake_weights=False, quantize=quantize,
                           device=dev)
    weights = serving_weights(trainable, frozen, bn_state, quantize=quantize)
    if verbose:
        print(f"# export {time.time() - t0:.1f}s", flush=True)
    return exported_callable(ep, weights, device=dev), image_size
