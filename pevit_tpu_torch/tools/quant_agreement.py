"""int8 against floating-point serving: top-1 agreement and logit error.

Counterpart of ``tools/quant_agreement.py``.  Runs the same images through
the floating-point and the weight-only int8 serving forward
(``pevit_tpu_torch.serve.make_serving_fn``, the forward
``export_classifier`` traces) of a KAdaptation classifier and reports:

* top-1 prediction agreement (the share of images with the same argmax),
* max |logit_q - logit_fp| relative to the largest |logit_fp|,
* the top-2 margin distribution (how much room the predictions have over
  the quantization noise).

With no ``--weights`` it uses random weights and synthetic images:
agreement is a property of the quantization noise against the logit
margins.  It prints one JSON line per model and writes a file only where
``--out`` is given.

    python -m pevit_tpu_torch.tools.quant_agreement --models b32,l14 --n 512
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

SPECS = {"b32": "vit_b32", "b16": "vit_b16", "l14": "vit_l14"}
NAMES = {"b32": "ViT-B/32", "b16": "ViT-B/16", "l14": "ViT-L/14"}


def measure(model: str, n: int, batch: int, weights: str, device) -> dict:
    from ..ckpt import load_clip
    from ..config import get_default_config
    from ..core import CLIPSpec, init_clip_params
    from ..peft import PeftConfig
    from ..serve import make_serving_fn
    from ..train import TaskStatic, TrainTask

    spec = getattr(CLIPSpec, SPECS[model])()
    cfg = get_default_config()
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = 100
    cfg.TRAIN.IMAGE_SIZE = [spec.vision.input_resolution] * 2
    cfg.freeze()
    if weights:
        clip, spec = load_clip(NAMES[model], checkpoint_path=weights, spec_hint=spec,
                               device=device)
    else:
        clip = init_clip_params(torch.Generator().manual_seed(0), spec, device=device)
    static = TaskStatic.from_config(cfg, spec, PeftConfig(method="kadaptation"))
    task = TrainTask(cfg, static, clip, device=device)
    trainable, frozen, bn_state = task.init_bundle(torch.Generator().manual_seed(1))

    f_fp = make_serving_fn(static, trainable, frozen, bn_state, task.preproc, device=device)
    f_q = make_serving_fn(static, trainable, frozen, bn_state, task.preproc, quantize=True,
                          device=device)
    res = spec.vision.input_resolution
    rng = np.random.default_rng(3)
    agree, max_rel, margins = 0, 0.0, []
    t0 = time.time()
    for i in range(0, n, batch):
        x = rng.integers(0, 255, (min(batch, n - i), res, res, 3), dtype=np.uint8)
        lf = f_fp(x).float().cpu().numpy()
        lq = f_q(x).float().cpu().numpy()
        agree += int((lf.argmax(1) == lq.argmax(1)).sum())
        max_rel = max(max_rel, float(np.abs(lq - lf).max() / max(np.abs(lf).max(), 1e-6)))
        s = np.sort(lf, axis=1)
        margins.append(s[:, -1] - s[:, -2])
    margins = np.concatenate(margins)
    return {
        "n_images": n,
        "num_classes": 100,
        "weights": weights or "random-init",
        "top1_agreement": agree / n,
        "max_rel_logit_err": max_rel,
        "median_top2_margin": float(np.median(margins)),
        "p5_top2_margin": float(np.percentile(margins, 5)),
        "wall_s": time.time() - t0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", default="b32,l14")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--weights", default="", help="an OpenAI CLIP checkpoint")
    ap.add_argument("--out", default="", help="also write the report here (JSON)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for model in (m.strip() for m in args.models.split(",") if m.strip()):
        report[model] = measure(model, args.n, args.batch, args.weights, dev)
        print(json.dumps({"model": model, **report[model]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
        print("report ->", args.out)
    return report


if __name__ == "__main__":
    main()
