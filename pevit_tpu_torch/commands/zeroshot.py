"""CLI: zero-shot CLIP evaluation, on the card.

Counterpart of ``pevit_tpu/commands/zeroshot.py`` (reference
vision_benchmark/commands/zeroshot.py), with its ``.npy`` image and text
feature cache and its prediction JSON, e.g.

    python -m pevit_tpu_torch.commands.zeroshot \\
        --ds resources/datasets/cifar10.yaml --model resources/model/vitb32_CLIP.yaml \\
        MODEL.PRETRAINED random

runs on the CUDA card unless ``--device cpu`` is given (before the
``KEY VALUE`` overrides, which take the rest of the line).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..utils import create_logger, dist as comm, log_config
from ..utils.device import resolve_device
from ._common import dump_artifacts, setup_config


def add_zeroshot_args(parser):
    parser.add_argument("--ds", required=False, type=str)
    parser.add_argument("--model", required=True, type=str)
    parser.add_argument("--submit-predictions", default=False, action="store_true")
    parser.add_argument("--submit-by", type=str)
    parser.add_argument("--fix_seed", default=0, type=int)
    parser.add_argument("--save-feature", default=True, type=lambda x: str(x).lower() == "true")
    parser.add_argument("--save-predictions", default=True, action="store_true")
    parser.add_argument("--device", help="cuda (default) or cpu.", default=None, type=str)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)


def feature_paths(config) -> tuple:
    """The image and text feature cache files (zeroshot.py:31-53)."""
    folder = os.path.join(config.OUTPUT_DIR, "features")
    tag = f"{config.DATASET.DATASET}_{config.MODEL.NAME.replace('/', '_')}"
    return (os.path.join(folder, f"{tag}_image.npy"), os.path.join(folder, f"{tag}_text.npy"))


def load_or_extract_features(config, clip, spec, test_images):
    """Image and text features, read from the ``.npy`` cache where a
    file exists, else computed and written there (by the main process of
    a world, after every rank has looked)."""
    from ..evaluation import extract_image_features, extract_text_features

    img_f, txt_f = feature_paths(config)
    os.makedirs(os.path.dirname(img_f), exist_ok=True)
    have_img, have_txt = os.path.exists(img_f), os.path.exists(txt_f)
    comm.barrier()
    if have_img:
        image_features = np.load(img_f)
        logging.info("loaded cached image features %s", img_f)
    else:
        image_features = extract_image_features(config, clip, spec, test_images)
        if comm.is_main_process():
            np.save(img_f, image_features)
    if have_txt:
        text_features = np.load(txt_f)
    else:
        text_features = extract_text_features(config, clip, spec)
        if comm.is_main_process():
            np.save(txt_f, text_features)
    return image_features, text_features


def main(argv=None):
    parser = argparse.ArgumentParser(description="Zero-shot evaluation script.")
    add_zeroshot_args(parser)
    args = parser.parse_args(argv)
    args.no_tuning = False
    comm.initialize(device=args.device)
    device = resolve_device(args.device)
    config = setup_config(args)

    # reference naming (commands/zeroshot.py:89)
    exp_name = (
        "zeroshot_eval_"
        f"wiki_{config.KNOWLEDGE.WIKITIONARY.USE_DEFINITION}"
        f"_wnh_{config.KNOWLEDGE.WORDNET.USE_HIERARCHY}"
        f"_wnd_{config.KNOWLEDGE.WORDNET.USE_DEFINITION}"
        f"_gpt3_{config.KNOWLEDGE.GPT3.USE_GPT3}"
    )
    create_logger(config, exp_name)
    if comm.is_main_process():
        log_config(config, args)

    from ..ckpt import load_clip
    from ..core.clip import CLIPSpec
    from ..data.sources import build_splits
    from ..evaluation import clip_zeroshot_evaluator

    with comm.main_process_first():  # it decodes and caches the split
        _, _, test = build_splits(config, test_split_only=True)
    ckpt = config.TEST.MODEL_FILE or config.MODEL.PRETRAINED or None
    clip, spec = load_clip(config.MODEL.NAME, checkpoint_path=ckpt, seed=args.fix_seed,
                           spec_hint=CLIPSpec.from_config(config), device=device)

    image_features, text_features = load_or_extract_features(config, clip, spec, test.images)
    result, logits, metric_name = clip_zeroshot_evaluator(image_features, text_features,
                                                          test.labels, config)
    logging.info("=> TEST: %s %.3f", metric_name, result)

    if args.save_predictions and comm.is_main_process():
        z = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(z)
        probs /= probs.sum(axis=-1, keepdims=True)
        dump_artifacts(config, exp_name, result, {"best_logits": probs}, txt=False)
    return result


if __name__ == "__main__":
    main()
