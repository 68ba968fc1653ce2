#!/usr/bin/env python
"""Streamed against preloaded bf16 KAdaptation training on one CUDA card,
in turns in one process.

    python3 tools/stream_throughput.py

The model and split are those of ``chip_smoke.py`` phase 11b: the seeded
ViT-B/32 tower, KAdaptation in bf16 with dropout 0.5 at batch 128, and
28,000 noisy copies of phase 4's prototypes (4.21 GB of uint8) in host
memory, with a 64-image val split.  Each run below is timed on the host
clock around one synchronised call and printed as one JSON line with
images/s, ms a step, and the SM clock, power draw and temperature that
``nvidia-smi`` reads just after it:

* ``burst``: phase 5's measure, ``chip_smoke.train_throughput`` (two
  epochs of 3 full batches after a warm-up epoch, ``build_epoch_fn`` on a
  384-image split on the card);
* ``streamed``: one epoch of ``train_trials`` on the numpy split, which
  streams by the default 4.0 GB rule; also the seconds the runner's worker
  thread spends gathering (``StreamingEpochRunner._gather``, overlapped
  with the steps' launches) and the launching thread spends issuing the
  copies (``_copy``);
* ``streamed_inline``: the same, with the runner's worker replaced by one
  that gathers on the launching thread when the batch is asked for, as the
  port's first streaming loop did;
* ``preloaded``: one epoch of ``train_trials`` on the same split held on
  the card;

A burst first as a warm-up, then ``ROUNDS`` rounds (default 4) of
streamed, streamed_inline and preloaded, each round in a rotated order,
then a burst; the last line gives each run's median images/s and the
medians' ratios to the preloaded one.  The host clock moves by a quarter
between runs on a one-card machine, whose host is shared, so only the
medians are compared.  The card's name and power limit are printed first.
It needs a CUDA card and exits non-zero without one.

    python3 tools/stream_throughput.py [ROUNDS]
"""

from __future__ import annotations

import json
import subprocess
from concurrent.futures import Future
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def card_state() -> dict:
    q = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return dict(zip(q.split(","), (v.strip() for v in out.splitlines()[0].split(","))))


class InlineWorker:
    """A stand-in for the runner's one-thread executor that runs each job
    on the calling thread when its result is asked for."""

    def __init__(self, max_workers: int = 1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        class Deferred(Future):
            def result(self, timeout=None):
                return fn(*args)

        return Deferred()


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_throughput: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from pevit_tpu_torch.ops import KERNELS, build_all
    from pevit_tpu_torch.train import streaming

    card = cs.card_line()
    print(card, flush=True)
    build_all(KERNELS)
    static, _, frozen, _, _ = cs.build_classifier(seed=0)
    res = static.spec.vision.input_resolution
    rng = np.random.default_rng(0)
    prototypes = rng.integers(0, 256, (static.num_classes, res, res, 3), dtype=np.uint8)
    clip = frozen["clip"]
    block, block_labels = cs.noisy_split(prototypes, 1000, rng)
    reps = cs.STREAM_FULL // len(block)
    images, labels = np.tile(block, (reps, 1, 1, 1)), np.tile(block_labels, reps)
    val, val_labels = cs.noisy_split(prototypes, cs.STREAM_VAL, rng)
    task = cs.make_task(clip, "bfloat16", 0.5)
    hp = [(cs.TRAIN_LR, cs.TRAIN_WD)]
    steps = streaming.epoch_steps(len(labels), task.static.batch_size)

    # phase 5's split and bundle for the bursts
    burst_task = cs.make_task(clip, "bfloat16", 0.5)
    burst_data = cs.train_data(prototypes, rng)
    cs.train_run(burst_task, burst_data, KERNELS)

    dev_images = task.prepack(torch.from_numpy(images).cuda())
    dev_labels = task._labels(labels)
    threaded = streaming.ThreadPoolExecutor
    host_s = {"gather": 0.0, "copy": 0.0}
    runner = streaming.StreamingEpochRunner

    def timed(name, fn):
        def wrapped(self, *a):
            t0 = time.perf_counter()
            out = fn(self, *a)
            host_s[name] += time.perf_counter() - t0
            return out
        return wrapped

    runner._gather = timed("gather", runner._gather)
    runner._copy = timed("copy", runner._copy)

    def run(name: str):
        host_s.update(gather=0.0, copy=0.0)
        streaming.ThreadPoolExecutor = InlineWorker if name == "streamed_inline" else threaded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "burst":
            ips = cs.train_throughput(burst_task, burst_data)
            seconds, n_steps = 6 * task.static.batch_size / ips, 6
        else:
            if name == "preloaded":
                task.train_trials(hp, dev_images, dev_labels, val, val_labels, end_epoch=1)
            else:
                task.train_trials(hp, images, labels, val, val_labels, end_epoch=1)
            torch.cuda.synchronize()
            seconds, n_steps = time.perf_counter() - t0, steps
            ips = len(labels) / seconds
        line = {"run": name, "images_per_s": ips, "ms_per_step": 1e3 * seconds / n_steps,
                "gather_thread_s": host_s["gather"], "copy_host_s": host_s["copy"],
                "card": card_state(), "card_name": card}
        print(json.dumps(line), flush=True)
        return ips

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    runs = ("streamed", "streamed_inline", "preloaded")
    seen = {name: [] for name in runs}
    run("burst")
    for r in range(rounds):
        for name in runs[r % 3:] + runs[:r % 3]:
            seen[name].append(run(name))
    run("burst")
    streaming.ThreadPoolExecutor = threaded
    medians = {name: float(np.median(v)) for name, v in seen.items()}
    print(json.dumps({"medians_images_per_s": medians,
                      "over_preloaded": {n: m / medians["preloaded"] for n, m in medians.items()},
                      "rounds": rounds, "card_name": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
