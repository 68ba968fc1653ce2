#!/usr/bin/env python
"""Float32 (or bfloat16) KAdaptation training images/s at batch 128 on one
CUDA card, for one or more checkouts of this repository, in turns; or
bfloat16 serving images/s at batch 256.

    python3 tools/fp32_train_throughput.py [--bf16 | --serve] [CHECKOUT ...]

Each checkout (default: this one) is measured by its own ``chip_smoke.py``,
as its phase 5 measures it: the seeded ViT-B/32 tower trains KAdaptation
in float32 with dropout 0 (with ``--bf16``: in bfloat16 with dropout 0.5)
through ``train_run`` (its launch counts checked), then
``train_throughput`` (two epochs of 3 full batches after a warm-up epoch)
three times.  With ``--serve``, as its phase 4 measures it: the seeded
bf16 classifier with its head fitted to the prototypes serves 8 batches
of 256 noisy prototypes through ``InferencePipeline`` after a warm-up
batch, three times.  Every checkout runs in a fresh process that
builds its own kernels, in the order given and then reversed (A B B A),
so that two versions are compared on one card in one call.  One JSON line
per run, then a summary line of each checkout's runs.  The card's name and
power limit are in every line.  It needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np


# the task of each --dtype: (compute dtype, dropout), as phase 5 trains it
TASKS = {"fp32": ("float32", 0.0), "bf16": ("bfloat16", 0.5)}
MODES = {"--bf16": "bf16", "--serve": "serve"}


def serve_rates(cs, classifier, prototypes, rng) -> list:
    """Phase 4's bf16 serving images/s at batch 256, three readings."""
    from pevit_tpu_torch.serve import InferencePipeline, make_serving_fn

    cs.fit_prototype_head(*classifier, prototypes)
    serve = make_serving_fn(*classifier, device="cuda")
    static, res = classifier[0], prototypes.shape[1]
    labels = np.arange(cs.SERVE_BATCH) % static.num_classes
    noise = rng.integers(-8, 9, (cs.SERVE_BATCH, res, res, 3))
    batch = np.clip(prototypes[labels] + noise, 0, 255).astype(np.uint8)
    pipe = InferencePipeline(serve, device="cuda", max_batch=cs.SERVE_BATCH)
    pipe.run([batch])
    rates = []
    for _ in range(3):
        pipe.stats.update(images=0, batches=0, seconds=0.0)
        pipe.run([batch] * 8)
        rates.append(pipe.throughput)
    return rates


def one(root: str, tag: str) -> int:
    """In a child: the measure of the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from pevit_tpu_torch.ops import KERNELS, build_all

    if not cs.__file__.startswith(root):
        raise SystemExit(f"chip_smoke imported from {cs.__file__}, not {root}")
    build_all(KERNELS)
    classifier = cs.build_classifier(seed=0)
    static, frozen = classifier[0], classifier[2]
    res = static.spec.vision.input_resolution
    rng = np.random.default_rng(0)
    prototypes = rng.integers(0, 256, (static.num_classes, res, res, 3), dtype=np.uint8)
    if tag == "serve":
        print("RUN " + json.dumps({"serve_images_per_s": serve_rates(cs, classifier, prototypes,
                                                                     rng),
                                   "card": cs.card_line()}), flush=True)
        return 0
    data = cs.train_data(prototypes, rng)
    task = cs.make_task(frozen["clip"], *TASKS[tag])
    run = cs.train_run(task, data, KERNELS)
    ips = [cs.train_throughput(task, data) for _ in range(3)]
    print("RUN " + json.dumps({f"{tag}_train_images_per_s": ips, "launches": run["launches"],
                               "card": cs.card_line()}), flush=True)
    return 0


def main(args: list) -> int:
    import torch

    tag = MODES.get(args[0], "fp32") if args else "fp32"
    roots = args[1:] if tag != "fp32" else args
    if not torch.cuda.is_available():
        print("fp32_train_throughput: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    roots = roots or [str(Path(__file__).resolve().parents[1])]
    summary = {r: [] for r in roots}
    key = "serve_images_per_s" if tag == "serve" else f"{tag}_train_images_per_s"
    for root in roots + roots[::-1]:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", root, tag],
                             capture_output=True, text=True)
        lines = [l[4:] for l in out.stdout.splitlines() if l.startswith("RUN ")]
        if out.returncode != 0 or not lines:
            print(f"{root}: failed (rc {out.returncode})\n{out.stderr[-4000:]}", flush=True)
            return 1
        row = json.loads(lines[-1])
        print(json.dumps({"checkout": root, **row}), flush=True)
        summary[root] += row[key]
    print(json.dumps({key: summary}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(sys.argv[2], sys.argv[3]))
    sys.exit(main(sys.argv[1:]))
