#!/usr/bin/env python
"""Device profile of the PyTorch port's three hot loops on one CUDA card.

    python3 tools/profile_port_step.py

The loops and models are those of ``chip_smoke.py``: a bf16 serving forward
of the ViT-B/32 KAdaptation classifier at batch 256 (phase 4), a bf16
KAdaptation train step at batch 128 with dropout 0.5 on H (phase 5), with
random weights from seed 0, and one trial of the command's sweep (phase 6):
the task and splits that ``kronecker_adaptation_clip`` builds from
``chip_smoke.command_argv`` (5-shot synthetic cifar-10, ``vitb32_CLIP.yaml``,
the head from text features), trained by ``TrainTask.train_trials`` for
END_EPOCH epochs of one 40-image step and one 10-image eval chunk each, as
the sweep trains every trial.  For each loop it prints one JSON line:

* ``wall_ms``: host clock around ``reps`` synchronised iterations, per
  iteration, without the profiler;
* ``device_busy_ms``: the union of the device's kernel and copy intervals
  in a ``torch.profiler`` trace of the same iterations, per iteration;
  ``device_idle_share`` is 1 - busy / wall;
* ``port_kernels_ms``: the device time of the port's hand-written kernels
  (K1, K2, K3 and their row passes), per iteration;
* ``top``: the kernels with the most device time, as [name, launches per
  iteration, ms per iteration].

The card's name and power limit are printed first.  It needs a CUDA card
and exits non-zero without one; it imports the port, torch and numpy only.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the names of the port's kernels in pevit_tpu_torch/ops/csrc
PORT_KERNELS = ("attention_fwd", "gemm_fc_bf16", "gemm_proj_bf16", "ln_rows_bf16",
                "gemm_dh_bf16", "gemm_du_bf16", "ln_bwd_rows_bf16", "transpose_kernel",
                "fused_mlp_fwd_kernel", "fused_mlp_bwd_kernel")


def _union_us(spans) -> float:
    spans = sorted(spans)
    total, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total + hi - lo


def device_profile(name: str, fn, reps: int, top: int = 12) -> dict:
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError(f"{name}: the profiler recorded no device activity")
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in device) / 1e3 / reps
    by_name: dict = {}
    for e in device:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    port_ms = sum(ms for n, (_, ms) in by_name.items() if any(k in n for k in PORT_KERNELS))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"loop": name, "reps": reps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "port_kernels_ms": port_ms / reps,
            "top": [[n[:90], c / reps, ms / reps] for n, (c, ms) in ranked]}


def command_task(tmp: Path, device: str = "cuda"):
    """The command's task, splits and config, built as
    ``run_training_command`` builds them from ``chip_smoke.command_argv``."""
    import argparse

    from pevit_tpu_torch.ckpt import load_clip
    from pevit_tpu_torch.commands._common import (EXP_PREFIX, add_common_args,
                                                  apply_shared_dataset_tweaks, load_device_data,
                                                  setup_config)
    from pevit_tpu_torch.core.clip import CLIPSpec
    from pevit_tpu_torch.evaluation import extract_text_features
    from pevit_tpu_torch.peft import PeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask

    args = add_common_args(argparse.ArgumentParser()).parse_args(cs.command_argv(tmp))
    config = setup_config(args)
    apply_shared_dataset_tweaks(config, EXP_PREFIX["kadaptation"])
    data = load_device_data(config, device)
    clip, spec = load_clip(config.MODEL.NAME, checkpoint_path=config.MODEL.PRETRAINED,
                           seed=args.fix_seed, spec_hint=CLIPSpec.from_config(config),
                           device=device)
    static = TaskStatic.from_config(config, spec, PeftConfig(method="kadaptation"))
    task = TrainTask(config, static, clip, device=device,
                     text_init_weights=extract_text_features(config, clip, spec))
    return task, data, config


def sweep_trial(task, data, config):
    """One sweep trial (the first coarse point of the first learning rate),
    as ``train.sweep`` trains it."""
    from pevit_tpu_torch.train.sweep import wd_grid

    grid, init_idx = wd_grid(config)
    train_x, train_y, val_x, val_y = data[:4]
    return lambda: task.train_trials([(1e-6, grid[init_idx[0]])], train_x, train_y, val_x,
                                     val_y, end_epoch=config.TRAIN.END_EPOCH,
                                     begin_epoch=config.TRAIN.BEGIN_EPOCH)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port_step: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from pevit_tpu_torch.ops import KERNELS, build_all
    from pevit_tpu_torch.serve import make_serving_fn
    from pevit_tpu_torch.train import (TrainState, build_epoch_fn, combine, make_optimizer,
                                       trainable_params)

    card = cs.card_line()
    print(card, flush=True)
    build_all(KERNELS)
    static, trainable, frozen, bn, preproc = cs.build_classifier(seed=0)
    res = static.spec.vision.input_resolution
    rng = np.random.default_rng(0)
    prototypes = rng.integers(0, 256, (static.num_classes, res, res, 3), dtype=np.uint8)

    serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
    batch = torch.from_numpy(prototypes[np.arange(cs.SERVE_BATCH) % static.num_classes]).cuda()
    print(json.dumps({**device_profile(f"serving forward, bf16, batch {cs.SERVE_BATCH}",
                                       lambda: serve(batch), reps=5), "card": card}), flush=True)

    task = cs.make_task(frozen["clip"], "bfloat16", dropout_p=0.5)
    st = task.static
    n = 3 * st.batch_size
    images, labels = cs.train_data(prototypes, rng)[:2]
    images, labels = task.prepack(images[:n]), torch.as_tensor(labels[:n]).cuda()
    trainable_b, frozen_b, bn_b = task.init_bundle(torch.Generator().manual_seed(11))
    params = trainable_params(trainable_b)
    opt_init, _ = make_optimizer(st.optimizer, momentum=st.momentum, nesterov=st.nesterov)
    state = TrainState(params, opt_init(params), bn_b, torch.Generator().manual_seed(12))
    epoch = build_epoch_fn(st, n, task.preproc)
    bundle = combine(trainable_b, frozen_b)

    def three_steps():
        nonlocal state
        state = epoch(bundle, images, labels, state, cs.TRAIN_LR, cs.TRAIN_WD)

    prof = device_profile(f"train epoch of 3 steps, bf16, batch {st.batch_size}", three_steps,
                          reps=3)
    print(json.dumps({**prof, "card": card}), flush=True)

    with tempfile.TemporaryDirectory(prefix="profile_port_step_") as tmp:
        task, data, config = command_task(Path(tmp))
        n_train, n_val = len(data[1]), len(data[3])
        prof = device_profile(f"command sweep trial, {config.TPU.COMPUTE_DTYPE}: "
                              f"{config.TRAIN.END_EPOCH} epochs of {n_train} train images "
                              f"(batch {task.static.batch_size}) and {n_val} val images",
                              sweep_trial(task, data, config), reps=3)
    print(json.dumps({**prof, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
