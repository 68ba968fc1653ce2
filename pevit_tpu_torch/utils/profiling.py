"""Light tracing and profiling.

Counterpart of ``pevit_tpu/utils/profiling.py``: the reference's wall-clock
``AverageMeter`` (kadaptation_clip.py:53-69), a ``timed`` block that logs
its seconds, and ``device_trace``, a ``torch.profiler`` trace of the CPU and,
where there is one, the CUDA card, written as a Chrome trace; it does
nothing when ``log_dir`` is empty.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch


class AverageMeter:
    """Computes and stores the average and current value
    (reference kadaptation_clip.py:53-69)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


@contextlib.contextmanager
def device_trace(log_dir: str = ""):
    """A ``torch.profiler`` trace of the block into
    ``log_dir/trace.json``; yields the profiler (None when ``log_dir`` is
    empty, and nothing is traced)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logging.info("=> wrote device trace to %s", path)


@contextlib.contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    yield
    logging.info("%s: %.3fs", label, time.perf_counter() - t0)
