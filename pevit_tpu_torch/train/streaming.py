"""Training on a train split that stays in host memory.

Counterpart of ``pevit_tpu/train/streaming.py``.  The preloaded path keeps
the whole uint8 train split on the card; a full-shot split can be larger
than the card should hold (full-shot patch-camelyon, 262K images, is about
39 GB of uint8), so ``TrainTask.train_trials`` streams any numpy train
split above ``TPU.MAX_DEVICE_DATA_GB`` from host memory instead, with the
step of the preloaded path (:func:`build_step_fn`).

The epoch (:class:`StreamingEpochRunner`):

* one order per epoch, ``np.random.default_rng(seed * 1000 + epoch)``'s
  permutation, shared by every trial of the call (the reference applies one
  batch to all its vmapped trials); full batches, then the tail at its
  natural size, and a tail of one image is skipped;
* each batch crosses to the card once, whatever the number of trials: its
  rows are gathered into one of two pinned uint8 host buffers, used in
  turn, copied on a side CUDA stream and pre-patchified there; the compute
  stream waits on the copy's event.  A batch of T trials (``trials``, the
  reference's vmapped step, ``pevit_tpu/train/streaming.py:79``) then takes
  one step on it, the batch repeated T times on the card (one copy);
  without one, each trial takes its step on the batch in turn.  A buffer
  is written again only once its copy's event has completed;
* the gather of batch i+1 runs on a worker thread while the trials' steps
  on batch i are launched (the reference's one-batch transfer-ahead), and
  the loop never waits on the card otherwise (no ``.item()``, no copy to
  the host, no synchronize): the training step is host-bound, so a gather
  on the launching thread would add to every step.

On a mesh with a data axis (``TrainTask._mesh_plan``) each data rank
gathers and copies only its rows of every full batch and takes its share of
the step (``build_step_fn``'s ``shard``); a tail runs whole on every rank,
as the reference's (``pevit_tpu/train/streaming.py:74-77``).

On the CPU (the tests) a batch is gathered into a fresh array and no
stream is used.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .trainer import TaskStatic, build_step_fn

__all__ = ["StreamingEpochRunner", "build_step_fn", "epoch_order"]


def epoch_order(n: int, seed: int) -> np.ndarray:
    """The streamed epoch's order of ``n`` images (reference streaming.py:89-90)."""
    return np.random.default_rng(seed).permutation(n)


def epoch_steps(n: int, batch: int) -> int:
    """Steps of an epoch over ``n`` images: full batches and a tail of more
    than one image."""
    steps = math.ceil(n / batch)
    if n - (steps - 1) * batch == 1:
        steps -= 1
    return max(steps, 0)


class StreamingEpochRunner:
    """The epoch loop over a host-resident split for the trials of one call.

    With ``trials`` = T > 0 the call's trials are one batch of T
    (``TrainTask._init_trials``), stepped together; with 0 each run is one
    trial.  ``h2d_bytes`` counts the image bytes the runner has copied to
    the card (each batch once), ``batches`` the batches it has gathered."""

    def __init__(self, task, *, lr_scales=None, wd_mask=None, trials: int = 0, mesh=None,
                 shard_steps: bool = True):
        st: TaskStatic = task.static
        self.task = task
        self.batch = st.batch_size
        self.device = task.device
        self.trials = trials
        self._step = build_step_fn(st, task.preproc, lr_scales, wd_mask, task._forward_fn,
                                   trials, mesh)
        from ..parallel.mesh import row_shard

        self._shard = row_shard(mesh, self.batch) if shard_steps else None
        self._label_dtype = torch.float32 if st.multilabel else torch.long
        self._pinned = None  # two (images, labels) pinned host buffers
        self._events = [None, None]
        self._stream = None
        self.h2d_bytes = 0
        self.batches = 0

    def _buffers(self, images: np.ndarray, labels: np.ndarray) -> None:
        shape = (self.batch,) + images.shape[1:]
        if self._pinned is None or self._pinned[0][0].shape != shape:
            lab_shape = (self.batch,) + labels.shape[1:]
            lab_dtype = torch.from_numpy(labels[:0]).dtype
            self._pinned = [(torch.empty(shape, dtype=torch.uint8, pin_memory=True),
                             torch.empty(lab_shape, dtype=lab_dtype, pin_memory=True))
                            for _ in range(2)]
            self._events = [None, None]
            self._stream = torch.cuda.Stream(self.device)

    def _load(self, images: np.ndarray, labels: np.ndarray, idx: np.ndarray):
        """Batch ``idx`` on the CPU: (pre-patchified uint8 images, labels)."""
        self.batches += 1
        self.h2d_bytes += len(idx) * images[0].nbytes
        imgs = torch.from_numpy(np.take(images, idx, axis=0))
        return self.task.prepack(imgs), torch.from_numpy(labels[idx]).to(self._label_dtype)

    def _gather(self, images: np.ndarray, labels: np.ndarray, idx: np.ndarray, slot: int) -> int:
        """Rows ``idx`` into pinned buffer ``slot``, once the buffer's last
        copy to the card has completed; runs on the runner's worker thread
        (``np.take`` and the event wait leave the interpreter lock free)."""
        host_imgs, host_labs = self._pinned[slot]
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        n = len(idx)
        np.take(images, idx, axis=0, out=host_imgs.numpy()[:n])
        np.take(labels, idx, axis=0, out=host_labs.numpy()[:n])
        return n

    def _copy(self, slot: int, n: int, image_bytes: int):
        """The first ``n`` rows of pinned buffer ``slot`` to the card on the
        side stream, pre-patchified there; the compute stream waits on the
        copy's event.  Returns (images, labels) on the card."""
        self.batches += 1
        self.h2d_bytes += n * image_bytes
        host_imgs, host_labs = self._pinned[slot]
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            imgs = self.task.prepack(host_imgs[:n].to(self.device, non_blocking=True))
            labs = host_labs[:n].to(self.device, non_blocking=True).to(self._label_dtype)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        compute.wait_event(event)
        imgs.record_stream(compute)
        labs.record_stream(compute)
        return imgs, labs

    def run_epoch(self, runs: list, images: np.ndarray, labels: np.ndarray, lrs, wds,
                  seed: int) -> list:
        """One epoch of every trial over host-resident ``images`` / ``labels``.

        ``runs`` holds each trial's ``(bundle, TrainState)``, or with
        ``trials`` the batch's one ``(stacked bundle, TrainState)``; ``lrs``
        and ``wds`` each trial's learning rate and weight decay.  Each trial
        draws its epoch's dropout seed from its own generator, as the
        preloaded epoch does when given its order.  On the card a worker
        thread gathers batch i+1 while the steps on batch i are launched.
        Returns the runs' new states."""
        n = len(labels)
        B = self.batch
        order = epoch_order(n, seed)
        states = [state for _, state in runs]
        gens = [g for s in states for g in (s.generator if self.trials else [s.generator])]
        drop_seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=g)) for g in gens]
        steps = epoch_steps(n, B)
        if self.trials:  # to the card once an epoch
            lrs = torch.tensor(lrs, dtype=torch.float32, device=self.device)
            wds = torch.tensor(wds, dtype=torch.float32, device=self.device)

        def step_all(i, imgs, labs):
            step_gens = [torch.Generator(device=self.device).manual_seed(s + i)
                         for s in drop_seeds]
            kw = {"shard": self._shard} if self._shard is not None and i < n // B else {}
            if self.trials:
                T = self.trials
                imgs = imgs.unsqueeze(0).expand(T, *imgs.shape).reshape(-1, *imgs.shape[1:])
                labs = labs.unsqueeze(0).expand(T, *labs.shape)
                states[0] = self._step(runs[0][0], states[0], imgs, labs, lrs, wds, step_gens,
                                       **kw)
                return
            for t, (bundle, _) in enumerate(runs):
                states[t] = self._step(bundle, states[t], imgs, labs, lrs[t], wds[t],
                                       step_gens[t], **kw)

        def rows(i):
            """Batch i's rows of the order this rank gathers: its share of a
            full batch under a data axis, else all of them."""
            idx = order[i * B:(i + 1) * B]
            return self._shard.take(idx) if self._shard is not None and i < n // B else idx

        if self.device.type != "cuda":
            for i in range(steps):
                step_all(i, *self._load(images, labels, rows(i)))
            return states
        self._buffers(images, labels)
        with ThreadPoolExecutor(max_workers=1) as worker:
            def fetch(i):
                return worker.submit(self._gather, images, labels, rows(i), i % 2)

            pending = fetch(0) if steps else None
            for i in range(steps):
                batch = self._copy(i % 2, pending.result(), images[0].nbytes)
                if i + 1 < steps:  # gathered while this batch's steps are launched
                    pending = fetch(i + 1)
                step_all(i, *batch)
        return states
