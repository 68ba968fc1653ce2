"""Serving: the eval-mode classifier, its exported artifacts, and the
batching host pipeline.

Counterpart of ``pevit_tpu/serve.py``: ``make_serving_fn`` (uint8 images ->
logits, optionally from an int8 weight bundle), ``export_classifier`` (a
``torch.export`` program with a symbolic batch, the weights baked in or
passed as arguments), ``serving_weights`` (the bundle such a program takes),
``save_exported`` / ``load_exported`` (``.pt2``), ``exported_callable``
(an artifact as ``f(images_u8) -> logits`` on a device),
``InferencePipeline`` (bucketed batching with batches in flight) and
``MicroBatcher`` (cross-request coalescing on one worker thread).

The hand-written kernels are registered operators that choose by device
when they run (``ops``), so an exported graph holds their nodes and an
artifact exported on the CPU launches the kernels on the card.

``forward_fn`` serves an auxiliary backbone (``models.factory``; the
trainer's ``TrainTask._forward_fn``): the bundle's ``clip`` is then that
backbone, and a served or exported tower holds all of it but a text tower.
Not ported, and raising with their ROADMAP item: a device mesh (``mesh``,
ROADMAP §1 item 5), and ``platforms``, which has no meaning here (the
artifact picks its device when it runs; ROADMAP §3).
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from collections import deque

import numpy as np
import torch
from torch import nn

from . import ops as _ops  # noqa: F401  (registers the operators an artifact calls)
from .peft.base import MODULE_CLASSES
from .quant import dequantize_tree, quantize_tree
from .train.head import Head
from .train.partition import combine, named_parameters
from .train.trainer import model_forward
from .utils.device import resolve_device

__all__ = ["make_serving_fn", "export_classifier", "serving_weights", "save_exported",
           "load_exported", "exported_callable", "InferencePipeline", "MicroBatcher"]


def _refuse_unported(*, mesh=None, platforms=None) -> None:
    if mesh is not None:
        raise NotImplementedError("a data-parallel serving program over a device mesh is not "
                                  "ported (ROADMAP §1 item 5, parallel)")
    if platforms is not None:
        raise NotImplementedError("platforms has no counterpart: an exported program picks "
                                  "its device when it runs (ROADMAP §3)")


def _served_backbone(clip: nn.Module, forward_fn) -> nn.Module:
    """What the eval forward reads of the bundle's ``clip``, named as in the
    bundle: a CLIP's visual tower under ``visual``; or, with ``forward_fn``,
    every child module and parameter of an auxiliary backbone but a
    ``text`` tower."""
    served = nn.Module()
    if forward_fn is None:
        served.visual = clip.visual
        return served
    for name, child in clip.named_children():
        if name != "text":
            served.add_module(name, child)
    for name, p in clip.named_parameters(recurse=False):
        served.register_parameter(name, p)
    return served


class _Tower(nn.Module):
    """The modules the eval forward reads, named as in the bundle: the
    backbone's served part under ``clip`` (``_served_backbone``), the PEFT
    module and the head.  No text tower, so a baked artifact carries none."""

    def __init__(self, static, clip: nn.Module, peft, head: nn.Module, forward_fn=None):
        super().__init__()
        self.static = static
        self.clip = clip
        self.peft = peft
        self.head = head
        self.forward_fn = forward_fn

    def forward(self, images_u8, bn_mean, bn_var, pre_mean, pre_std):
        bundle = {"clip": self.clip, "peft": self.peft, "head": self.head}
        logits, _ = model_forward(self.static, bundle, {"mean": bn_mean, "var": bn_var},
                                  images_u8, {"mean": pre_mean, "std": pre_std}, train=False,
                                  forward_fn=self.forward_fn)
        return logits


def _skeleton(static, served: nn.Module, forward_fn=None) -> _Tower:
    """A ``_Tower`` on the meta device (structure, no weights), run with
    weights handed in by ``torch.func.functional_call``: the backbone's
    ``served`` part (``_served_backbone``) copied there."""
    v = static.spec.vision
    clip = copy.deepcopy(served).to("meta")
    with torch.device("meta"):
        peft = (MODULE_CLASSES[static.peft_cfg.method](v.layers, v.width)
                if static.peft_cfg.has_peft_params else None)
        return _Tower(static, clip, peft, Head(static.head_dim, static.num_classes), forward_fn)


def _buffer_name(name: str) -> str:
    if "__" in name:
        raise ValueError(f"parameter name {name!r} holds '__'")
    return name.replace(".", "__")


class ServingModule(nn.Module):
    """``forward(images_u8) -> logits`` with the weights inside: what
    :func:`make_serving_fn` runs and a baked artifact exports.

    In floating point it holds the bundle's own visual tower, PEFT module and
    head.  With ``quantize`` it holds the same weights as :func:`quantize_tree`
    leaves (int8 values and float32 scales, as buffers) and dequantizes them
    inside every call, as the reference's quantized ``serve`` does.  The BN
    statistics and ``preproc`` are buffers either way."""

    def __init__(self, static, bundle: dict, bn_state: dict, preproc: dict, *,
                 quantize: bool = False, forward_fn=None):
        super().__init__()
        for name, t in (("bn_mean", bn_state["mean"]), ("bn_var", bn_state["var"]),
                        ("pre_mean", preproc["mean"]), ("pre_std", preproc["std"])):
            self.register_buffer(name, torch.as_tensor(t).detach())
        served = _served_backbone(bundle["clip"], forward_fn)
        tower = _Tower(static, served, bundle["peft"], bundle["head"], forward_fn)
        if not quantize:
            self.tower, self._skeleton, self._leaves = tower, None, None
            return
        self.tower = None
        # a tuple: not a submodule, nothing lifted
        self._skeleton = (_skeleton(static, served, forward_fn),)
        self._leaves = {}
        for name, leaf in quantize_tree(dict(tower.named_parameters())).items():
            parts = leaf.items() if isinstance(leaf, dict) else ((None, leaf),)
            for part, t in parts:
                buf = _buffer_name(name) + ("" if part is None else "__" + part)
                self.register_buffer(buf, t)
                self._leaves.setdefault(name, {})[part] = buf

    def _weights(self) -> dict:
        """The quantized tower as :func:`quantize_tree` gives it."""
        return {name: getattr(self, parts[None]) if None in parts
                else {part: getattr(self, buf) for part, buf in parts.items()}
                for name, parts in self._leaves.items()}

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        stats = (self.bn_mean, self.bn_var, self.pre_mean, self.pre_std)
        if self.tower is not None:
            return self.tower(images_u8, *stats)
        return torch.func.functional_call(self._skeleton[0], dequantize_tree(self._weights()),
                                          (images_u8, *stats))


class ServingArgsModule(nn.Module):
    """``forward(weights, images_u8) -> logits`` with the weights passed in,
    as :func:`serving_weights` gives them (int8 leaves dequantized inside
    the call when ``quantize``): what a weights-as-args artifact exports.
    Holds only ``preproc``."""

    def __init__(self, static, preproc: dict, served: nn.Module, *, quantize: bool = False,
                 forward_fn=None):
        super().__init__()
        for name in ("mean", "std"):
            self.register_buffer(f"pre_{name}", torch.as_tensor(preproc[name]).detach())
        self.quantize = quantize
        self._skeleton = (_skeleton(static, served, forward_fn),)
        self._names = [n for n, _ in self._skeleton[0].named_parameters()]

    def forward(self, weights: dict, images_u8: torch.Tensor) -> torch.Tensor:
        bundle = {n: weights["bundle"][n] for n in self._names}  # the text tower is not read
        if self.quantize:
            bundle = dequantize_tree(bundle)
        bn = weights["bn_state"]
        return torch.func.functional_call(self._skeleton[0], bundle,
                                          (images_u8, bn["mean"], bn["var"], self.pre_mean,
                                           self.pre_std))


def _on_device(bundle: dict, dev) -> dict:
    return {k: (None if m is None else m.to(dev)) for k, m in bundle.items()}


def make_serving_fn(static, trainable, frozen, bn_state, preproc, forward_fn=None, *,
                    quantize: bool = False, device=None):
    """(B, H, W, 3) uint8 -> (B, K) float32 logits on ``device``, eval mode.

    The bundle's modules move to ``device`` (``None`` -> CUDA, raising where
    there is none); ``bn_state`` and ``preproc`` are copied there.  With
    ``quantize`` the tower's weights are stored as int8 on the device and
    dequantized inside every call.  The returned function takes a uint8
    tensor or array and enters ``torch.inference_mode`` inside each call,
    so it holds in whichever thread calls it.  ``forward_fn`` (an auxiliary
    backbone's forward, ``TrainTask._forward_fn``) replaces the CLIP visual
    tower, as in ``model_forward``.
    """
    dev = resolve_device(device)
    module = ServingModule(static, _on_device(combine(trainable, frozen), dev), bn_state,
                           preproc, quantize=quantize, forward_fn=forward_fn).to(dev)

    def serve(images_u8) -> torch.Tensor:
        with torch.inference_mode():
            return module(torch.as_tensor(images_u8).to(dev))

    return serve


def serving_weights(trainable, frozen, bn_state, *, quantize: bool = False) -> dict:
    """The weight bundle a weights-as-args artifact takes first:
    ``{"bundle": {dotted name: tensor}, "bn_state": {"mean", "var"}}`` over
    the whole ``combine(trainable, frozen)`` bundle (both towers, as the
    reference's), detached.  ``quantize`` must match the artifact's: it
    stores the large leaves as int8 (:func:`quantize_tree`)."""
    bundle = {n: p.detach() for n, p in named_parameters(combine(trainable, frozen)).items()}
    if quantize:
        bundle = quantize_tree(bundle)
    return {"bundle": bundle, "bn_state": {k: v.detach() for k, v in bn_state.items()}}


def _canonical(tree, dev):
    """A weight tree on ``dev`` with its dict keys sorted: a program's input
    spec records key order, so the export and every call use this one."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k], dev) for k in sorted(tree)}
    return tree.to(dev)


# the example batch of a symbolic-batch export: torch.export specialises
# sizes 0 and 1, so the example takes 2 and the dimension is declared >= 1
_EXAMPLE_BATCH = 2


def export_classifier(static, trainable, frozen, bn_state, preproc, *, image_size: int = 224,
                      dynamic_batch: bool = True, bake_weights: bool = True,
                      quantize: bool = False, device=None, platforms=None, mesh=None,
                      forward_fn=None) -> torch.export.ExportedProgram:
    """The eval forward as a ``torch.export`` program: (b, S, S, 3) uint8 ->
    (b, K) float32 logits, S = ``image_size``.

    ``dynamic_batch`` exports a symbolic ``b`` (any batch from 1 up);
    otherwise the batch is fixed at 1.  ``bake_weights`` picks the
    deployment mode:

    * True: the weights are program state, one self-contained artifact,
      called as ``f(images)``.  It holds the visual tower, the PEFT module,
      the head, the BN statistics and ``preproc``, and no text tower.
    * False: the weights stay arguments, a program-only artifact called as
      ``f(serving_weights(trainable, frozen, bn_state, quantize=...), images)``.

    ``quantize`` stores the weights as int8 (in the program, or in the
    bundle it takes) and dequantizes them inside every call.  The program is
    traced on ``device`` (``None`` -> CUDA); :func:`exported_callable` runs
    it on any device.  ``forward_fn`` exports an auxiliary backbone's
    forward, as in :func:`make_serving_fn`.
    """
    _refuse_unported(mesh=mesh, platforms=platforms)
    dev = resolve_device(device)
    batch = _EXAMPLE_BATCH if dynamic_batch else 1
    example = torch.zeros((batch, image_size, image_size, 3), dtype=torch.uint8, device=dev)
    images_dim = {0: torch.export.Dim("b", min=1)} if dynamic_batch else None
    bundle = _on_device(combine(trainable, frozen), dev)
    if bake_weights:
        module = ServingModule(static, bundle, bn_state, preproc, quantize=quantize,
                               forward_fn=forward_fn)
        args, shapes = (example,), {"images_u8": images_dim}
    else:
        module = ServingArgsModule(static, preproc, _served_backbone(bundle["clip"], forward_fn),
                                   quantize=quantize, forward_fn=forward_fn)
        weights = _canonical(serving_weights(trainable, frozen, bn_state, quantize=quantize), dev)
        static_weights = torch.utils._pytree.tree_map(lambda _: None, weights)
        args, shapes = (weights, example), {"weights": static_weights, "images_u8": images_dim}
    with torch.no_grad():
        ep = torch.export.export(module.to(dev), args,
                                 dynamic_shapes=shapes if dynamic_batch else None, strict=False)
    # the program keeps its example inputs, which would save a
    # weights-as-args artifact with a copy of the weights
    ep.example_inputs = None
    return ep


def is_baked(ep: torch.export.ExportedProgram) -> bool:
    """True for a self-contained artifact (its one input is the images)."""
    return len(ep.graph_signature.user_inputs) == 1


def exported_image_size(ep: torch.export.ExportedProgram) -> int:
    """S of the (b, S, S, 3) images an artifact takes."""
    name = ep.graph_signature.user_inputs[-1]
    node = next(n for n in ep.graph.nodes if n.op == "placeholder" and n.name == name)
    return int(node.meta["val"].shape[1])


def exported_callable(ep: torch.export.ExportedProgram, weights=None, *, device=None):
    """An artifact as ``f(images_u8) -> (b, K) float32 logits`` on
    ``device`` (``None`` -> CUDA), under ``torch.inference_mode``.

    The program is moved to the device first, in place: its state, its
    constants and the device its input checks name, so that an artifact
    traced on the CPU runs on the card, where its operators launch the
    kernels.  A weights-as-args artifact needs ``weights``
    (:func:`serving_weights`, moved to the device here)."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    if is_baked(ep) != (weights is None):
        raise ValueError("a baked artifact takes no weights; a weights-as-args one needs them")
    module = move_to_device_pass(ep, dev).module()
    if weights is not None:
        weights = _canonical(weights, dev)

    def call(images_u8) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(images_u8).to(dev)
            return module(x) if weights is None else module(weights, x)

    return call


def save_exported(ep: torch.export.ExportedProgram, path) -> None:
    torch.export.save(ep, str(path))


def load_exported(path) -> torch.export.ExportedProgram:
    """The ``.pt2`` artifact at ``path``; run it with :func:`exported_callable`.
    This module has imported ``pevit_tpu_torch.ops``, which registers the
    operators the program calls."""
    return torch.export.load(str(path))


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
