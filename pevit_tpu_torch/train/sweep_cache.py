"""On-disk sweep trial-score cache: a sweep or a campaign resumes after a
crash.

Counterpart of ``pevit_tpu/train/sweep_cache.py``: every finished trial's
score is appended to a JSONL file keyed by a fingerprint of (config, data
digest, epochs, seed, PEFT method), so that a re-run replays the finished
trials and trains only the rest; selection is recomputed from the scores,
never cached.

The fingerprint follows the reference's rules: it covers the config's dump
with the pure-output paths blanked, the split shapes and dtypes, every label
and a strided pixel sample of the images, whether they lie in numpy or in a
tensor on any device, and ``SEMANTICS_VERSION``.  It is built on the port's
own config dump, so it is not the reference's fingerprint, and a cache
written by one package is never read by the other.

The method is hashed on its own because no config key names it: every
command resolves ``TPU.SWEEP_CACHE_DIR: auto`` to the same
``<OUTPUT_DIR>/<dataset>/sweep_cache``, so two methods run with the same
flags into one output directory would otherwise share a file, and the
second would replay the first's scores without training.  The reference
keys by config only (``pevit_tpu/train/sweep_cache.py:83``), though its
docstring means a change of method to change the key (ROADMAP §3).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np

from ..utils import dist as comm
from ..utils.device import to_numpy

# config keys that name OUTPUT locations: they cannot change a trial's score
_VOLATILE_KEYS = (("OUTPUT_DIR",), ("TPU", "CHECKPOINT_DIR"), ("TPU", "SWEEP_CACHE_DIR"))

# The port's training and evaluation semantics version, part of every sweep
# and job fingerprint.  Bump it on any change that can alter trial scores,
# best-epoch selection or final accuracies under an unchanged config and
# data.  History:
#   1  the port's first sweep and command.  Later the fingerprint also
#      hashed the PEFT method, which changes every key by itself, so the
#      version stayed: a key, not a change of what a trial scores.
#   2  the attention and fused-MLP kernels' float32 bodies moved to the
#      tensor cores (a three-product TF32 split): float32 sums in another
#      order, so the auxiliary backbones' probe and finetune trials and
#      every float32 sweep score differently in the last bits.
#   3  the fused-MLP backward kernel's float32 body moved to the tensor
#      cores too (the same split): float32 KAdaptation and LoRA trials sum
#      their MLP gradients in another order and score differently in the
#      last bits.
#   4  a sweep chunk's trials train as one batch: the frozen tower's
#      kernels and the trials' delta products run at the chunk's folded
#      shapes, so on the card a batched trial can round differently from the
#      same trial trained alone.
#   5  full fine-tuning and the auxiliary backbones train a chunk as one
#      batch too: a tower stacked over the trials runs T-batched products
#      and grouped convolutions, and a shared backbone's kernels run at the
#      chunk's folded shapes, so their trials round differently from the
#      serial ones that version 4 cached.
#   6  bf16 attention at heads of up to 64 from 258 tokens up to 640 runs
#      the body with the S tile in shared memory: the row sum is added up
#      in another order (two warpgroups' halves) and P V in two halves, so
#      a bf16 output there can differ by an ulp from the three-walk body's
#      (CLIP ViT-L/14 at 336 px).
#   7  bf16 attention at heads of up to 64 from 641 tokens up to 768 runs
#      the shared-memory body with its short ring instead of the three-walk
#      body: the row sum and P V are added up in another order, so a bf16
#      output there can differ by an ulp (CLIP ViT-H/14 at 378 px).
#   8  float32 attention at heads of up to 64 runs the persistent body on
#      wgmma: keys in chunks of 64 (32 before) change the online softmax's
#      rescale, and its products are rounded on their own (never fused
#      into the adds after), so a float32 output can differ in its last
#      bits (every fp32 sweep on a CLIP, ViT or DeCLIP tower).
SEMANTICS_VERSION = 8


def _dtype_name(arr) -> str:
    return str(arr.dtype).removeprefix("torch.")


def _sample_bytes(arr, max_rows: int = 64) -> bytes:
    """A strided row sample: slicing before the copy keeps a split on the
    card to ``max_rows`` rows of transfer."""
    n = int(arr.shape[0]) if arr.ndim else 1
    stride = max(1, n // max_rows)
    return np.ascontiguousarray(to_numpy(arr[::stride])).tobytes()


def data_fingerprint(data) -> str:
    h = hashlib.sha256()
    for arr in data:
        if arr is None:
            h.update(b"none")
            continue
        h.update(str(tuple(arr.shape)).encode())
        h.update(_dtype_name(arr).encode())
        # labels are small: hash them whole; images get the strided sample
        full = arr.ndim <= 2 and int(np.prod(arr.shape)) <= 1_000_000
        h.update(np.ascontiguousarray(to_numpy(arr)).tobytes() if full else _sample_bytes(arr))
    return h.hexdigest()


def sweep_fingerprint(config, data, end_epoch: int, seed: int, method: str) -> str:
    cfg = config.clone()
    cfg.defrost()
    for path in _VOLATILE_KEYS:
        node = cfg
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = ""
    h = hashlib.sha256()
    h.update(f"semantics={SEMANTICS_VERSION};".encode())
    h.update(cfg.dump().encode())
    h.update(f"end_epoch={end_epoch};seed={seed};method={method};".encode())
    h.update(data_fingerprint(data).encode())
    return h.hexdigest()[:24]


class SweepCache:
    """Append-only JSONL score store for one sweep fingerprint, keyed by the
    exact repr of (lr, wd) (both runs derive the grid from one
    ``np.logspace``)."""

    def __init__(self, directory: str, fingerprint: str):
        self.path = os.path.join(directory, f"sweep_{fingerprint}.jsonl")
        self._scores: dict[tuple[str, str], float] = {}
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        self._scores[(rec["lr"], rec["wd"])] = float(rec["score"])
                    except (ValueError, KeyError):
                        # a run killed mid-write leaves one truncated last line
                        logging.warning("sweep cache %s: skipping corrupt line", self.path)
            if self._scores:
                logging.info("sweep cache %s: resuming with %d finished trials",
                             self.path, len(self._scores))

    @staticmethod
    def _key(lr: float, wd: float) -> tuple[str, str]:
        return (repr(float(lr)), repr(float(wd)))

    def __len__(self) -> int:
        return len(self._scores)

    def get(self, lr: float, wd: float) -> Optional[float]:
        return self._scores.get(self._key(lr, wd))

    def put(self, lr: float, wd: float, score: float) -> None:
        """Record a score; only the main process of a world writes it."""
        k = self._key(lr, wd)
        self._scores[k] = float(score)
        if not comm.is_main_process():
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"lr": k[0], "wd": k[1], "score": float(score)}) + "\n")
            f.flush()
            os.fsync(f.fileno())


def open_sweep_cache(config, data, end_epoch: int, seed: int, method: str) -> Optional[SweepCache]:
    """The cache of ``method``'s sweep when ``TPU.SWEEP_CACHE_DIR`` names a
    directory, else None (``auto`` is resolved to ``<run output
    dir>/sweep_cache`` by the command; a library caller that never resolved
    it gets no cache)."""
    directory = str(config.TPU.get("SWEEP_CACHE_DIR", "") or "")
    if not directory or directory == "auto":
        return None
    return SweepCache(directory, sweep_fingerprint(config, data, end_epoch, seed, method))
