#!/usr/bin/env python
"""Float32 (or bfloat16) KAdaptation training images/s at batch 128 on one
CUDA card, for one or more checkouts of this repository, in turns.

    python3 tools/fp32_train_throughput.py [--bf16] [CHECKOUT ...]

Each checkout (default: this one) is measured by its own ``chip_smoke.py``,
as its phase 5 measures it: the seeded ViT-B/32 tower trains KAdaptation
in float32 with dropout 0 (with ``--bf16``: in bfloat16 with dropout 0.5)
through ``train_run`` (its launch counts checked), then
``train_throughput`` (two epochs of 3 full batches after a warm-up epoch)
three times.  Every checkout runs in a fresh process that
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


# the task of each --dtype: (compute dtype, dropout), as phase 5 trains it
TASKS = {"fp32": ("float32", 0.0), "bf16": ("bfloat16", 0.5)}


def one(root: str, tag: str) -> int:
    """In a child: the measure of the checkout at ``root``."""
    import numpy as np

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from pevit_tpu_torch.ops import KERNELS, build_all

    if not cs.__file__.startswith(root):
        raise SystemExit(f"chip_smoke imported from {cs.__file__}, not {root}")
    build_all(KERNELS)
    static, _, frozen, _, _ = cs.build_classifier(seed=0)
    res = static.spec.vision.input_resolution
    rng = np.random.default_rng(0)
    prototypes = rng.integers(0, 256, (static.num_classes, res, res, 3), dtype=np.uint8)
    data = cs.train_data(prototypes, rng)
    task = cs.make_task(frozen["clip"], *TASKS[tag])
    run = cs.train_run(task, data, KERNELS)
    ips = [cs.train_throughput(task, data) for _ in range(3)]
    print("RUN " + json.dumps({f"{tag}_train_images_per_s": ips, "launches": run["launches"],
                               "card": cs.card_line()}), flush=True)
    return 0


def main(args: list) -> int:
    import torch

    tag = "bf16" if args[:1] == ["--bf16"] else "fp32"
    roots = args[1:] if tag == "bf16" else args
    if not torch.cuda.is_available():
        print("fp32_train_throughput: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    roots = roots or [str(Path(__file__).resolve().parents[1])]
    summary = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", root, tag],
                             capture_output=True, text=True)
        lines = [l[4:] for l in out.stdout.splitlines() if l.startswith("RUN ")]
        if out.returncode != 0 or not lines:
            print(f"{root}: failed (rc {out.returncode})\n{out.stderr[-4000:]}", flush=True)
            return 1
        row = json.loads(lines[-1])
        print(json.dumps({"checkout": root, **row}), flush=True)
        summary[root] += row[f"{tag}_train_images_per_s"]
    print(json.dumps({f"{tag}_train_images_per_s": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(sys.argv[2], sys.argv[3]))
    sys.exit(main(sys.argv[1:]))
