"""The hyperparameter sweep and the method runner.

Counterpart of ``pevit_tpu/train/sweep.py``.  The reference's walk
(kadaptation_clip.py:188-243, 446-466) is, per learning rate: 7 coarse
weight-decay probes over a 97-point log grid, then a binary refinement with
step spans 8/4/2/1 (2 probes each), every probe a full training: up to
6 x 15 = 90 trainings per (dataset, seed).  The walks of the six learning
rates are independent and advance in lockstep, one stage of trials at a
time (1 coarse + 4 refinement stages); a stage is cut into chunks of
``task.max_parallel_trials()`` trials, which the port's ``train_trials``
trains as one batch on the card, as the reference's vmapped chunk.
Selection is the reference's exactly: strict ``>``, iteration order,
``WD_SEARCH_LEFT``, ``SEARCH_RESULT_ON_LAST_EPOCH`` and score 0.0 for a
trial that fails.

A chunk of more than one trial that runs the card out of memory
(``torch.cuda.OutOfMemoryError``) is retried as two halves, after
``torch.cuda.empty_cache()``, as the reference retries a chunk that fails
on its device (``pevit_tpu/train/sweep.py:36-74``): the batch's activations
grow with its width, and under full fine-tuning so do the stacked tower, its
gradients and its optimiser state (about 12 bytes a parameter a trial in
float32, so a chunk of 8 ViT-B/16 towers holds about 8 GB before any
activation).  A single trial out of memory aborts the sweep, and so
does every other device error (a CUDA error, or a kernel that fails to
build, refuses its inputs or fails to launch), whatever the chunk's width;
none is ever scored 0.0.  Where the port differs from the reference, on
purpose: the reference halves on any runtime error, the port on running out
of memory only, because a CUDA error other than that is sticky (it leaves
the process's context unusable, so a retry could only fail again or hide
the fault) and a kernel's refusal does not depend on the width (ROADMAP §3).

In a world of several ranks (``utils.dist``) every rank walks the same
sweep: a chunk's trials are laid over the ranks by ``train_trials``, which
gives every rank every score.  The ranks agree on a chunk's outcome before
acting on it: one rank out of memory while its peers finished would
otherwise halve alone and wait for them forever, so the worst outcome over
the world (another device error, then running out of memory, then any
other failure) decides on every rank.  The sweep cache and the artifacts
are written by the main process only.
"""

from __future__ import annotations

import gc
import logging
import time

import numpy as np
import torch

from ..ops._build import KernelBuildError, KernelInputError, KernelLaunchError
from ..utils import dist as comm
from ..utils.device import to_numpy


class RankDeviceError(RuntimeError):
    """Another rank of the world hit a device error."""


# the exceptions that mean the card or a kernel failed: they abort a sweep
# (out of memory only on a single trial; a wider chunk is halved)
DEVICE_ERRORS = (torch.cuda.OutOfMemoryError, KernelBuildError, KernelInputError,
                 KernelLaunchError, RankDeviceError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def is_device_error(e: BaseException) -> bool:
    """One of ``DEVICE_ERRORS``, or a CUDA error that a torch without
    ``AcceleratorError`` raises as a plain RuntimeError."""
    return isinstance(e, DEVICE_ERRORS) or (isinstance(e, RuntimeError)
                                            and str(e).startswith("CUDA error"))


def failure_kind(e) -> "str | None":
    """How a failure is told to the other ranks: "oom" (out of card memory),
    "device" (another device error) or "other"; None for no failure."""
    if e is None:
        return None
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return "oom"
    return "device" if is_device_error(e) else "other"


def wd_grid(config):
    """The 97-point grid and the indices of its 7 coarse points
    (kadaptation_clip.py:191-192)."""
    lo, hi = config.TRAIN.SEARCH_WD_LOG_LOWER, config.TRAIN.SEARCH_WD_LOG_UPPER
    grid = np.logspace(lo, hi, num=97).tolist()
    seed_vals = set(np.logspace(lo, hi, num=7))
    init_idx = [i for i, v in enumerate(grid) if v in seed_vals]
    return grid, init_idx


def _run_chunk(task, chunk: list, data, end_epoch: int, seed: int, begin_epoch: int = 0) -> list:
    """Scores of one chunk of trials; 0.0 for all of them if the chunk fails
    with anything but a device error (kadaptation_clip.py:200-205).  A chunk
    of more than one trial that runs out of card memory is split into two
    halves, each run in turn; any other device error is raised.  The
    outcome is the worst over the world's ranks (:data:`_OUTCOMES`)."""
    train_x, train_y, val_x, val_y = data
    failure, outcome = None, 0
    try:
        res = task.train_trials(chunk, train_x, train_y, val_x, val_y, end_epoch=end_epoch,
                                begin_epoch=begin_epoch, seed=seed)
    except Exception as e:  # noqa: BLE001 - the reference scores a failed trial 0
        failure = e
        kind = failure_kind(e)
        if kind == "oom" and len(chunk) == 1:
            kind = "device"  # a single trial out of memory cannot be halved
        outcome = _OUTCOMES.index({"other": "failed", "oom": "out of memory",
                                   "device": "device error"}[kind])
    outcome = _OUTCOMES[comm.max_over_world(outcome)]
    if outcome == "failed":
        logging.warning("sweep stage chunk failed (%s); scoring 0", failure)
        return [0.0] * len(chunk)
    if outcome == "device error":
        logging.error("DEVICE error in sweep stage (%s: %s) - aborting sweep",
                      type(failure).__name__, failure)
        if failure is not None and is_device_error(failure):
            raise failure
        raise RankDeviceError(f"another rank hit a device error in a sweep chunk"
                              f"{'' if failure is None else f' ({failure})'}")
    halve = outcome == "out of memory"
    if halve:
        mid = len(chunk) // 2
        logging.warning("sweep chunk of %d ran out of card memory (%s); splitting to %d+%d",
                        len(chunk), failure or "on another rank", mid, len(chunk) - mid)
        failure = None
        # out of the handler, so that the failed chunk's tensors, which its
        # traceback holds, are freed before the cache is emptied
        gc.collect()
        torch.cuda.empty_cache()
        return (_run_chunk(task, chunk[:mid], data, end_epoch, seed, begin_epoch)
                + _run_chunk(task, chunk[mid:], data, end_epoch, seed, begin_epoch))
    use_last = task.config.TRAIN.SEARCH_RESULT_ON_LAST_EPOCH
    out = []
    for r in res:
        v = r["last_score"] if use_last else r["best_score"]
        out.append(0.0 if not np.isfinite(v) else float(v))
    return out


# a chunk's outcomes, from the mildest; the world acts on the worst
_OUTCOMES = ("trained", "failed", "out of memory", "device error")


def _run_stage(task, jobs: list, data, end_epoch: int, seed: int, max_parallel: int, cache=None,
               begin_epoch: int = 0):
    """Scores of a stage of (lr, wd) trials, in chunks of ``max_parallel``.

    With a ``SweepCache``, finished trials replay from disk and only the
    misses train; a pair that repeats within the stage trains once.  Every
    fresh score is written before the stage returns."""
    if cache is None:
        scores = []
        for s in range(0, len(jobs), max_parallel):
            scores.extend(_run_chunk(task, jobs[s:s + max_parallel], data, end_epoch, seed,
                                     begin_epoch))
        return scores

    scores = [cache.get(lr, wd) for lr, wd in jobs]
    pending: dict = {}
    for i, v in enumerate(scores):
        if v is None:
            pending.setdefault(tuple(jobs[i]), []).append(i)
    miss_jobs = list(pending)
    if miss_jobs:
        logging.info("sweep stage: %d/%d trials from cache",
                     len(jobs) - sum(len(v) for v in pending.values()), len(jobs))
    fresh = []
    for s in range(0, len(miss_jobs), max_parallel):
        fresh.extend(_run_chunk(task, miss_jobs[s:s + max_parallel], data, end_epoch, seed,
                                begin_epoch))
    for (lr, wd), sc in zip(miss_jobs, fresh):
        cache.put(lr, wd, sc)
        for i in pending[(lr, wd)]:
            scores[i] = sc
    comm.barrier()  # the main process's writes are on disk before any rank reads on
    return scores


def hyperparameter_sweep_lr(task, data, config, *, seed: int = 0):
    """The joint (lr, wd) search (kadaptation_clip.py:446-466 and
    :188-243): every learning rate's weight-decay walk advances in
    lockstep, one stage at a time.  Returns (best_lr, best_wd)."""
    start = time.time()
    lrs = np.logspace(-6, -1, num=6).tolist()
    grid, init_idx = wd_grid(config)
    end_epoch = config.TRAIN.END_EPOCH
    # epochs run = range(BEGIN_EPOCH, END_EPOCH), as in every reference loop
    begin_epoch = config.TRAIN.BEGIN_EPOCH
    max_parallel = task.max_parallel_trials()
    wd_search_left = config.TRAIN.WD_SEARCH_LEFT

    from .sweep_cache import open_sweep_cache

    cache = open_sweep_cache(config, data, end_epoch, seed, task.static.peft_cfg.method)

    peak_idx = {lr: -1 for lr in lrs}
    peak_score = {lr: 0.0 for lr in lrs}

    # stage 0: the coarse grid, every learning rate at once
    jobs = [(lr, grid[idx]) for lr in lrs for idx in init_idx]
    scores = _run_stage(task, jobs, data, end_epoch, seed, max_parallel, cache, begin_epoch)
    k = 0
    for lr in lrs:
        for idx in init_idx:
            if scores[k] > peak_score[lr]:
                peak_idx[lr], peak_score[lr] = idx, scores[k]
            k += 1
        logging.info("=> LR %.1e coarse: peak wd %s score %.3f",
                     lr, grid[peak_idx[lr]], peak_score[lr])

    # refinement stages: step spans 8, 4, 2, 1
    step_span = 8
    while step_span > 0:
        jobs, meta = [], []
        for lr in lrs:
            p = peak_idx[lr]
            left, right = max(p - step_span, 0), min(p + step_span, len(grid) - 1)
            for idx in (i for i in (left, right) if i != p):
                # WD_SEARCH_LEFT trains grid[left] but credits grid[idx]
                # (kadaptation_clip.py:221-225), a legacy mode kept verbatim
                jobs.append((lr, grid[left] if wd_search_left else grid[idx]))
                meta.append((lr, idx))
        scores = _run_stage(task, jobs, data, end_epoch, seed, max_parallel, cache, begin_epoch)
        for (lr, idx), sc in zip(meta, scores):
            if sc > peak_score[lr]:
                peak_idx[lr], peak_score[lr] = idx, sc
        step_span //= 2

    # the best learning rate (strict >, iteration order; :453-462)
    best_lr, best_wd, best_score = 0.0, 0.0, 0.0
    for lr in lrs:
        if peak_score[lr] > best_score:
            best_score = peak_score[lr]
            best_lr = lr
            best_wd = grid[peak_idx[lr]]
    logging.info("Hyper parameter tuning result: learning rate %s, l2_lambda %s (%.1fs)",
                 best_lr, best_wd, time.time() - start)
    return best_lr, best_wd


def merge_splits(a, b):
    """Two parts of a split, one after the other (reference sweep.py:247-256):
    on the host as numpy when either part is numpy (a part on the card is
    copied back), so a host-resident split stays on the host, else
    ``torch.cat`` on the card, whatever the merged size."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.concatenate([to_numpy(a), to_numpy(b)], axis=0)
    return torch.cat([a, b])


def run_method(task, data, config, *, no_tuning: bool, lr: float, l2: float, seed: int = 0,
               rebuild_data=None):
    """The method runner (reference ``kadapt_clip`` et al.,
    kadaptation_clip.py:488-520): the sweep unless ``no_tuning``, then the
    final run on train+val (MERGE_TRAIN_VAL_FINAL_RUN) for END_EPOCH +
    EXTRA_FINAL_TRAIN_EPOCH epochs, evaluated on the test split.  Returns
    (best test score, model_info with the best test-epoch probabilities).

    ``data`` is (train_x, train_y, val_x, val_y, test_x, test_y), numpy
    arrays or tensors; ``rebuild_data()`` regenerates it under the current
    config (the patch-camelyon restore below).  With TPU.CHECKPOINT_DIR the
    final run's trained state is saved there as ``step_{epochs}.npz``."""
    train_x, train_y, val_x, val_y, test_x, test_y = data

    if no_tuning:
        best_lr, best_wd = lr, l2
    else:
        best_lr, best_wd = hyperparameter_sweep_lr(task, (train_x, train_y, val_x, val_y),
                                                   config, seed=seed)

    logging.info("=> The final classifier is on training ...")
    logging.info("Hyperparameters: learning_rate = %s, l2_lambda = %s", best_lr, best_wd)
    end_epoch = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_FINAL_TRAIN_EPOCH

    if (config.DATASET.DATASET == "patch-camelyon"
            and config.DATASET.NUM_SAMPLES_PER_CLASS == 10000 and rebuild_data is not None):
        # the sweep searched the 10000-shot subset; the final run trains on
        # the regenerated full set (kadaptation_clip.py:504-512), and the
        # artifact records n_shot -1, as the reference's in-place edit does
        logging.info("Used the subset to train the model, regenerating the full set for final run.")
        config.defrost()
        config.DATASET.NUM_SAMPLES_PER_CLASS = -1
        config.freeze()
        logging.info("Old: len(train)=%d, len(val)=%d, len(test)=%d.",
                     len(train_y), len(val_y), len(test_y))
        train_x, train_y, val_x, val_y, test_x, test_y = rebuild_data()
        logging.info("Generated: len(train)=%d, len(val)=%d, len(test)=%d.",
                     len(train_y), len(val_y), len(test_y))

    if config.DATASET.MERGE_TRAIN_VAL_FINAL_RUN:
        final_x, final_y = merge_splits(train_x, val_x), merge_splits(train_y, val_y)
        logging.info("Using the full trainval set to train final model. len=%d", len(final_y))
    else:
        final_x, final_y = train_x, train_y
        logging.info("Using the train set only to train final model. len=%d", len(final_y))

    res = task.train_trials([(best_lr, best_wd)], final_x, final_y, test_x, test_y,
                            end_epoch=end_epoch, begin_epoch=config.TRAIN.BEGIN_EPOCH, seed=seed,
                            keep_logits=True, log_every=1)[0]

    model_info = task.model_info(task.last_trainable)
    model_info["best_lr"] = float(best_lr)
    model_info["best_l2_lambda"] = float(best_wd)
    if config.TPU.CHECKPOINT_DIR:
        from ..ckpt import save_trainable

        if comm.is_main_process():
            save_trainable(config.TPU.CHECKPOINT_DIR, task.last_bundle, step=end_epoch)
        comm.barrier()
    model_info["best_logits"] = res["best_logits"]
    logging.info("=> Learning rate %s, L2 lambda %s: Best score: Acc@1 %.3f",
                 best_lr, best_wd, res["best_score"])
    return res["best_score"], model_info
