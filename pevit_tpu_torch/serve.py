"""Serving: the eval-mode classifier behind a batching host driver.

Counterpart of ``pevit_tpu/serve.py``: ``make_serving_fn`` (uint8 images ->
logits), ``InferencePipeline`` (bucketed batching with batches in flight)
and ``MicroBatcher`` (cross-request coalescing on one worker thread).  The
reference's StableHLO export has no counterpart yet (``torch.export`` comes
later).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from .train.partition import combine
from .train.trainer import model_forward
from .utils.device import resolve_device

__all__ = ["make_serving_fn", "InferencePipeline", "MicroBatcher"]


def make_serving_fn(static, trainable, frozen, bn_state, preproc, *, device=None):
    """(B, H, W, 3) uint8 -> (B, K) float32 logits on ``device``, eval mode.

    The bundle's modules, ``bn_state`` and ``preproc`` move to ``device``
    (``None`` -> CUDA, raising where there is none).  The returned function
    takes a uint8 tensor or array and enters ``torch.inference_mode`` inside
    each call, so it holds in whichever thread calls it.
    """
    dev = resolve_device(device)
    bundle = {k: (None if m is None else m.to(dev)) for k, m in combine(trainable, frozen).items()}
    bn = {k: t.to(dev) for k, t in bn_state.items()}
    pre = {k: torch.as_tensor(t).to(dev) for k, t in preproc.items()}

    def serve(images_u8) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(images_u8).to(dev)
            logits, _ = model_forward(static, bundle, bn, x, pre, train=False)
        return logits

    return serve


class InferencePipeline:
    """Host-side serving driver: bucketed batching with ``depth`` batches in
    flight.

    Requests are split at ``max_batch`` and ragged chunks zero-padded up to
    a power-of-two bucket (``pad_policy="bucket"``), or run at their natural
    size (``"exact"``).  With KAdaptation's raw-reshape scramble the forward
    mixes batch rows, so a padded chunk's logits can differ from a
    natural-size run of the same rows; responses are bucket-deterministic.

    On CUDA each chunk is copied into pinned host memory and sent with
    ``non_blocking=True``; its logits come back by an asynchronous copy
    whose event the drain waits on, so the host prepares chunk i+1 while
    the card computes chunk i.  The host chunk stays referenced in the
    in-flight entry until that entry is drained.
    """

    def __init__(self, call_fn, *, device=None, max_batch: int = 256, min_bucket: int = 8,
                 depth: int = 2, pad_policy: str = "bucket"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if min_bucket < 1 or max_batch < min_bucket:
            raise ValueError(f"need 1 <= min_bucket <= max_batch, got {min_bucket}, {max_batch}")
        if pad_policy not in ("bucket", "exact"):
            raise ValueError(f"pad_policy must be 'bucket' or 'exact', got {pad_policy!r}")
        self._fn = call_fn
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        self.depth = int(depth)
        self.pad_policy = pad_policy
        self.stats = {"images": 0, "batches": 0, "seconds": 0.0}

    def _bucket(self, n: int) -> int:
        if self.pad_policy == "exact":
            return n
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _submit(self, chunk: np.ndarray):
        """Enqueue one chunk; returns (host logits, ready event or None, host chunk)."""
        host = torch.from_numpy(chunk)
        if self.device.type != "cuda":
            return self._fn(host).float(), None, host
        host = host.pin_memory()
        logits = self._fn(host.to(self.device, non_blocking=True))
        out = logits.float().to("cpu", non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return out, ready, host

    def run(self, batches) -> list:
        """Drive an iterable of uint8 image arrays; returns one float32 numpy
        logits array per input element, in input order."""
        t0 = time.perf_counter()
        inflight: list = []  # (host logits, event, host chunk, n_valid, out_index, row_offset)
        outputs: dict = {}
        sizes: dict = {}

        def drain(limit: int) -> None:
            while len(inflight) > limit:
                logits, ready, _chunk, n, idx, off = inflight.pop(0)
                if ready is not None:
                    ready.synchronize()
                outputs.setdefault(idx, []).append((off, logits[:n].numpy()))

        n_elems = 0
        for idx, imgs in enumerate(batches):
            n_elems += 1
            imgs = np.asarray(imgs)
            if imgs.shape[0] == 0:
                raise ValueError("empty image batch in stream")
            sizes[idx] = imgs.shape[0]
            for off in range(0, imgs.shape[0], self.max_batch):
                chunk = imgs[off: off + self.max_batch]
                n = chunk.shape[0]
                b = self._bucket(n)
                if n < b:
                    chunk = np.concatenate([chunk, np.zeros((b - n,) + chunk.shape[1:], chunk.dtype)])
                inflight.append((*self._submit(np.ascontiguousarray(chunk)), n, idx, off))
                self.stats["batches"] += 1
                self.stats["images"] += n
                drain(self.depth - 1)
        drain(0)
        self.stats["seconds"] += time.perf_counter() - t0

        results = []
        for idx in range(n_elems):
            parts = sorted(outputs[idx], key=lambda p: p[0])
            arr = np.concatenate([p for _, p in parts]) if len(parts) > 1 else parts[0][1]
            if arr.shape[0] != sizes[idx]:
                raise RuntimeError(f"element {idx}: {arr.shape[0]} logits for {sizes[idx]} images")
            results.append(arr)
        return results

    def __call__(self, images) -> np.ndarray:
        """``(N, H, W, 3) u8 -> (N, K) f32``."""
        return self.run([images])[0]

    @property
    def throughput(self) -> float:
        """Sustained images/s across every ``run`` so far."""
        return self.stats["images"] / self.stats["seconds"] if self.stats["seconds"] else 0.0


class MicroBatcher:
    """Cross-request micro-batching in front of an :class:`InferencePipeline`.

    One worker thread owns the pipeline; request threads enqueue and wait.
    The worker takes the first pending request, absorbs more for up to
    ``window_ms`` (or until ``max_group`` images, default the pipeline's
    ``max_batch``), runs ONE pipeline call and splits the logits back.
    """

    _CLOSE = object()

    def __init__(self, pipeline: InferencePipeline, *, window_ms: float = 2.0,
                 max_group: int = 0):
        self._pipe = pipeline
        self._window = max(0.0, float(window_ms)) / 1000.0
        self._max_group = int(max_group) or pipeline.max_batch
        self._q: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "groups": 0}
        # per-request wall latency (enqueue -> logits ready), recent window
        self._lat = deque(maxlen=4096)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def infer(self, images) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, K) float32 logits; thread-safe."""
        images = np.asarray(images)
        done = threading.Event()
        slot: dict = {}
        self._q.put((images, done, slot, time.perf_counter()))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def close(self) -> None:
        self._q.put(self._CLOSE)
        self._worker.join(timeout=30)

    def latency_stats(self) -> dict:
        """Percentiles (ms) of the recent per-request wall latencies."""
        lat = np.asarray(self._lat, np.float64)
        if not lat.size:
            return {"count": 0}
        p50, p95, p99 = np.percentile(lat, [50, 95, 99]) * 1e3
        return {"count": int(lat.size), "mean_ms": float(lat.mean()) * 1e3,
                "p50_ms": float(p50), "p95_ms": float(p95), "p99_ms": float(p99)}

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is self._CLOSE:
                return
            group = [first]
            total = first[0].shape[0]
            deadline = time.perf_counter() + self._window
            closing = False
            while total < self._max_group:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is self._CLOSE:
                    closing = True
                    break
                # only identical frame geometry can share a batch
                if item[0].shape[1:] != first[0].shape[1:]:
                    self._q.put(item)
                    break
                group.append(item)
                total += item[0].shape[0]
            try:
                batch = group[0][0] if len(group) == 1 else np.concatenate([g[0] for g in group])
                logits = self._pipe(batch)
                off = 0
                now = time.perf_counter()
                for imgs, done, slot, t0 in group:
                    n = imgs.shape[0]
                    slot["out"] = logits[off: off + n]
                    off += n
                    self._lat.append(now - t0)
                    done.set()
                self.stats["requests"] += len(group)
                self.stats["groups"] += 1
            except Exception as e:  # propagate to every waiter, stay alive
                for _, done, slot, _t0 in group:
                    slot["err"] = e
                    done.set()
            if closing:
                return
