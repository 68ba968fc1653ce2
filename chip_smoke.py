#!/usr/bin/env python
"""The PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught and carried
on):

1. card: require CUDA, print the card's name and power limit, set TF32 off;
2. build: compile every kernel of the serving and training paths from
   ``pevit_tpu_torch/ops/csrc`` with nvcc (one process per source, all at
   once) and print each instantiation's ptxas registers and spills;
3. kernels: hold the attention and fused-MLP forward kernels against their
   plain PyTorch versions on the card at the serving path's shapes and
   dtypes (and at the training batch of 128), and time kernel, plain version
   and, where one exists, the PyTorch library call computing the same
   function;
3b. the fused-MLP backward kernel (K3) against its plain version and, in
   fp32, against torch autograd of the plain forward, at R = 6400 rows
   (ViT-B/32 batch 128) with C = 768 and 1024, bf16 and fp32, timed beside
   its bound; and the attention core's plain backward timed at N = 50,
   batch 128;
4. serving: a full-width ViT-B/32 KAdaptation classifier (random weights
   from a seed, non-zero adaptation factors, random BN statistics, a
   100-class head fitted to 100 seeded prototype images) behind
   ``make_server`` -> ``MicroBatcher`` -> ``InferencePipeline`` answers
   ragged requests from 4 client threads; every forward must launch each
   kernel 12 times; logits must be finite and agree with the plain path on
   the same batch of noisy prototypes (fp32: within 1e-3 of the largest
   logit; bf16: the same top-1 on at least 99% of the images); images/s at
   batch 256 and request latency are printed;
5. training: the same frozen ViT-B/32 tower trains KAdaptation (seeded
   non-zero factors) through ``TaskStatic.from_config`` -> ``TrainTask`` ->
   ``train_trials`` in bf16 at batch 128: a 100-class 5-shot split of noisy
   prototypes (500 images: 3 full steps and a natural tail of 116) for two
   epochs of SGD with momentum 0.9 and dropout 0.5 on H, a 200-image val
   split evaluated after each epoch (3 chunks of 64 and a remainder of 8).
   Checks: K3 launches 12 per train step, K1 and K2 12 per train step and
   eval chunk; the loss and the logits are finite; the first step's
   gradients on the kernel path match the plain path (every kernel replaced
   by plain PyTorch under PyTorch's own autograd) on the same bundle and
   batch with dropout 0: fp32 every trainable leaf within 1e-3 of its
   largest |g|, bf16 cosine >= 0.99 per leaf, every KAdaptation leaf that
   the forward uses non-zero and finite (the v factors, unused by quirk 1,
   exactly zero on both paths); a whole fp32 run on both paths, in the same
   order, gives per-epoch val logits within 1e-3 of the largest logit.
   Train images/s at batch 128 are printed;
6. report: one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

Needs one card; imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SERVE_BATCH = 256
TRAIN_BATCH = 128


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(name: str, log: str) -> list:
    """One line per compiled instantiation: dtype, width, registers, spills."""
    out, entry, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "Used" in line and "registers" in line:
            dtype = "bf16" if "bfloat16" in entry else "fp32"
            width = re.search(r"Li(\d+)E", entry)
            tag = f"{dtype} C={32 * int(width.group(1))}" if width else dtype
            if "transpose_kernel" in entry:
                tag = "transpose " + ("16-bit" if "transpose_kernelIt" in entry else "32-bit")
            out.append(f"ptxas {name} {tag}: {line.split(':', 1)[1].strip()}; {spills}")
        elif "spill stores" in line:
            spills = line.strip()
    return out


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, rtol, atol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max abs err {err}")
    return err


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_attention(gen, dtype, n, batch=SERVE_BATCH):
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref

    B, H, hd = batch, 12, 64
    q, k, v = (torch.randn(B, n, H, hd, device="cuda", generator=gen) * s
               for s in (0.25, 0.25, 1.0))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    t = lambda x: x.transpose(1, 2)
    plain = lambda: t(attention_ref(t(q), t(k), t(v)))
    got, want = attention_fwd(q, k, v), plain()
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    err = check_close(f"attention_fwd N={n} {dtype}", got, want, rtol, atol)
    qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
    esize = torch.finfo(dtype).bits // 8
    bms, by = bound_ms(4 * B * H * n * hd * esize, 4 * B * H * n * n * hd, dtype)
    return {"shape": f"B*H={B}*{H} N={n} hd={hd}", "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ms": time_ms(lambda: attention_fwd(q, k, v)),
            "plain_ms": time_ms(plain), "library_ms": time_ms(library),
            "bound_ms": bms, "bound_by": by}


def check_fused_mlp(gen, dtype, c, rows):
    from pevit_tpu_torch.ops.fused_mlp import fused_mlp_fwd, fused_mlp_residual_ref

    f = 4 * c
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x = r(rows, c).to(dtype)
    ln_s, ln_b = 1 + 0.1 * r(c), 0.1 * r(c)
    wfc, bfc = (r(c, f) * c ** -0.5).to(dtype), (0.1 * r(f)).to(dtype)
    wproj, bproj = (r(f, c) * f ** -0.5).to(dtype), (0.1 * r(c)).to(dtype)
    args = (x, ln_s, ln_b, wfc, bfc, wproj, bproj)
    got, want = fused_mlp_fwd(*args), fused_mlp_residual_ref(*args)
    torch.cuda.synchronize()
    # fp32: the 3072/4096-long sums run in another order than cuBLAS's
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    err = check_close(f"fused_mlp_fwd C={c} {dtype}", got, want, rtol, atol)
    esize = torch.finfo(dtype).bits // 8
    n_bytes = (2 * rows * c + 2 * c * f + f + c) * esize + 2 * c * 4
    bms, by = bound_ms(n_bytes, 4 * rows * c * f, dtype)
    return {"shape": f"R={rows} C={c} F={f}", "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ms": time_ms(lambda: fused_mlp_fwd(*args), reps=5),
            "plain_ms": time_ms(lambda: fused_mlp_residual_ref(*args), reps=5),
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def check_fused_mlp_bwd(gen, dtype, c, rows):
    """K3 against its plain backward (same rounding points) and, in fp32,
    against torch autograd of the plain forward."""
    from pevit_tpu_torch.ops.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_ref,
                                               fused_mlp_residual_ref)

    f = 4 * c
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x, dy = r(rows, c).to(dtype), r(rows, c).to(dtype)
    ln_s, ln_b = 1 + 0.1 * r(c), 0.1 * r(c)
    wfc, bfc = (r(c, f) * c ** -0.5).to(dtype), (0.1 * r(f)).to(dtype)
    wproj, bproj = (r(f, c) * f ** -0.5).to(dtype), (0.1 * r(c)).to(dtype)
    args = (dy, x, ln_s, ln_b, wfc, bfc, wproj)
    got, want = fused_mlp_bwd(*args), fused_mlp_bwd_ref(*args)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    err = check_close(f"fused_mlp_bwd C={c} {dtype}", got, want, rtol, atol)
    row = {"shape": f"R={rows} C={c} F={f}", "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err}
    if dtype == torch.float32:
        xg = x.clone().requires_grad_()
        y = fused_mlp_residual_ref(xg, ln_s, ln_b, wfc, bfc, wproj, bproj)
        (auto,) = torch.autograd.grad(y, xg, dy)
        row["max_abs_err_autograd"] = check_close(f"fused_mlp_bwd C={c} vs autograd",
                                                  got, auto, rtol, atol)
    esize = torch.finfo(dtype).bits // 8
    n_bytes = (3 * rows * c + 2 * c * f + f) * esize + 2 * c * 4
    bms, by = bound_ms(n_bytes, 6 * rows * c * f, dtype)  # the three GEMMs it runs
    return {**row, "ms": time_ms(lambda: fused_mlp_bwd(*args), reps=5),
            "plain_ms": time_ms(lambda: fused_mlp_bwd_ref(*args), reps=5),
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def time_attention_bwd(gen, dtype, n, batch):
    """The attention core's backward, plain PyTorch as in the reference."""
    from pevit_tpu_torch.ops.attention import attention_bwd_ref

    H, hd = 12, 64
    q, k, v, g = (torch.randn(batch, n, H, hd, device="cuda", generator=gen).to(dtype)
                  for _ in range(4))
    esize = torch.finfo(dtype).bits // 8
    bms, by = bound_ms(7 * batch * n * H * hd * esize, 10 * batch * H * n * n * hd, dtype)
    return {"shape": f"B*H={batch}*{H} N={n} hd={hd}", "dtype": str(dtype).split(".")[-1],
            "plain_ms": time_ms(lambda: attention_bwd_ref(q, k, v, g)), "bound_ms": bms,
            "bound_by": by}


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------

def seed_factors(peft, gen, scale: float = 0.5) -> None:
    """Non-zero KAdaptation factors, in place: they make the delta, its
    raw-reshape scramble and the factors' gradients live (at their zero
    init the q factors get exactly zero gradient on any path)."""
    with torch.no_grad():
        for layer in peft.layers:
            for name in ("q_left", "q_right", "v_left", "v_right"):
                p = getattr(layer, name)
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
            layer.b.copy_(torch.randn(layer.b.shape, generator=gen) * 0.02)


def build_classifier(seed: int):
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params
    from pevit_tpu_torch.data import CLIP_MEAN, CLIP_STD
    from pevit_tpu_torch.peft import PeftConfig, init_peft
    from pevit_tpu_torch.train import init_bn_state, init_head, partition, trainable_pred
    from pevit_tpu_torch.train.trainer import TaskStatic

    gen = torch.Generator().manual_seed(seed)
    spec = CLIPSpec.vit_b32()
    cfg = PeftConfig(method="kadaptation")
    static = TaskStatic(spec=spec, peft_cfg=cfg, num_classes=100)
    clip = init_clip_params(gen, spec, device="cuda")
    peft = init_peft(gen, cfg, spec, device="cuda")
    seed_factors(peft, gen)
    head = init_head(gen, static.head_dim, static.num_classes, device="cuda")
    bn = init_bn_state(static.head_dim, device="cuda")
    bn["mean"] = (torch.randn(static.head_dim, generator=gen) * 0.1).cuda()
    bn["var"] = (torch.rand(static.head_dim, generator=gen) * 1.5 + 0.5).cuda()
    trainable, frozen = partition({"clip": clip, "peft": peft, "head": head},
                                  trainable_pred(static))
    preproc = {"mean": torch.tensor(CLIP_MEAN), "std": torch.tensor(CLIP_STD)}
    return static, trainable, frozen, bn, preproc


def fit_prototype_head(static, trainable, frozen, bn, preproc, prototypes) -> None:
    """Give the head one class per prototype image, in place: logit_c(x) =
    (z(x) - m) . d_c, where z is the BN'd feature, m the prototypes' mean z
    and d_c prototype c's unit deviation from it (a nearest-centroid head,
    as a head initialised from class embeddings is).  Its logits separate
    classes, so a top-1 comparison tests the kernels and not bf16 rounding
    between near-tied random logits."""
    from pevit_tpu_torch.serve import make_serving_fn
    from pevit_tpu_torch.train import Head

    dim = static.head_dim
    probe = Head(dim, dim).cuda()
    with torch.no_grad():
        probe.linear.kernel.copy_(torch.eye(dim))  # logits = the BN'd features
    feats = make_serving_fn(dataclasses.replace(static, compute_dtype="float32"),
                            {**trainable, "head": probe}, frozen, bn, preproc, device="cuda")
    z = feats(prototypes)
    m = z.mean(0)
    d = (z - m) / (z - m).norm(dim=-1, keepdim=True)
    head = trainable["head"]
    with torch.no_grad():
        head.linear.kernel.copy_(d.T)
        head.linear.bias.copy_(-(m @ d.T))


@contextlib.contextmanager
def plain_path():
    """Swap the blocks' kernel wrappers for their plain versions (the same
    model on the same card, every kernel replaced by plain PyTorch)."""
    from pevit_tpu_torch.core import layers
    from pevit_tpu_torch.ops.attention import attention_ref
    from pevit_tpu_torch.ops.fused_mlp import fused_mlp_residual_ref

    t = lambda x: x.transpose(1, 2)
    saved = layers.attention_core, layers.fused_mlp_residual
    layers.attention_core = lambda q, k, v: t(attention_ref(t(q), t(k), t(v)))
    layers.fused_mlp_residual = fused_mlp_residual_ref
    try:
        yield
    finally:
        layers.attention_core, layers.fused_mlp_residual = saved


def post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/infer", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def serve_requests(serve, kernels, res: int, rng) -> dict:
    """Drive make_server -> MicroBatcher -> InferencePipeline with ragged
    requests from 4 client threads; returns launches and server stats."""
    from pevit_tpu_torch.serve_daemon import make_server

    srv = make_server(serve, res, device="cuda", port=0, max_batch=SERVE_BATCH)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sizes = (1, 7, 64, 200)
    requests = [[rng.integers(0, 256, (sizes[(i + j) % 4], res, res, 3), dtype=np.uint8)
                 for j in range(4)] for i in range(4)]
    answers, errors = {}, []

    def client(i):
        try:
            answers[i] = [post_npy(url, imgs) for imgs in requests[i]]
        except Exception as e:  # reported after join, fails the run
            errors.append(e)

    for k in kernels:
        k.launches = 0
    clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = {k.name: k.launches for k in kernels}
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.batcher.close()
        server_thread.join(timeout=30)
    if errors or any(c.is_alive() for c in clients):
        raise RuntimeError(f"client requests failed: {errors or 'timed out'}")
    for i in range(4):
        for imgs, logits in zip(requests[i], answers[i]):
            if logits.shape != (imgs.shape[0], 100) or not np.isfinite(logits).all():
                raise AssertionError(f"bad logits {logits.shape} for {imgs.shape[0]} images")
    forwards = stats["batches"]
    for name, n in launches.items():
        if n != 12 * forwards:
            raise AssertionError(f"{name}: {n} launches for {forwards} forwards, want 12 each")
    return {"launches": launches, "forwards": forwards, "stats": stats,
            "images": sum(x.shape[0] for r in requests for x in r)}


def compare_plain(serve, images, labels, dtype) -> dict:
    """Kernel path vs plain path on the same batch; ``labels`` are the
    images' prototype classes, for the printed accuracy of both paths."""
    got = serve(images)
    with plain_path():
        want = serve(images)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    acc = [(x.argmax(-1) == labels).float().mean().item() for x in (got, want)]
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the kernel path")
    if dtype == torch.float32 and err > 1e-3 * scale:
        raise AssertionError(f"fp32 logits: kernel vs plain max err {err} > 1e-3 * {scale}")
    if dtype == torch.bfloat16 and top1 < 0.99:
        raise AssertionError(f"bf16 logits: top-1 agreement {top1} < 0.99 (max err {err})")
    return {"dtype": str(dtype).split(".")[-1], "max_abs_err": err, "max_abs_logit": scale,
            "top1_agreement": top1, "accuracy_kernel": acc[0], "accuracy_plain": acc[1]}


# ---------------------------------------------------------------------------
# 5. training
# ---------------------------------------------------------------------------

TRAIN_LR, TRAIN_WD, TRAIN_EPOCHS = 1e-3, 1e-4, 2
TRAIN_FACTOR_SCALE = 0.1


def make_task(clip, dtype_name: str, dropout_p: float):
    """A ViT-B/32 KAdaptation task through the config entry points, on the
    given frozen tower, whose bundles carry seeded non-zero factors."""
    from pevit_tpu_torch.config import get_default_config
    from pevit_tpu_torch.core import CLIPSpec
    from pevit_tpu_torch.peft import PeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask

    cfg = get_default_config()
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = 100
    cfg.TRAIN.BATCH_SIZE_PER_GPU = TRAIN_BATCH
    cfg.TPU.COMPUTE_DTYPE = dtype_name
    cfg.freeze()
    static = TaskStatic.from_config(cfg, CLIPSpec.vit_b32(),
                                    PeftConfig(method="kadaptation", kadapt_dropout_p=dropout_p))
    task = TrainTask(cfg, static, clip, device="cuda")
    init = task.init_bundle

    def init_bundle(gen):
        trainable, frozen, bn = init(gen)
        # tamer than serving's 0.5: a sharper attention would let float32
        # rounding differences between the two paths grow over the run
        seed_factors(trainable["peft"], gen, scale=TRAIN_FACTOR_SCALE)
        return trainable, frozen, bn

    task.init_bundle = init_bundle
    return task


def train_data(prototypes, rng) -> tuple:
    """5 noisy copies of each of the 100 prototypes to train on, 2 more of
    each to validate on."""
    def noisy(labels):
        noise = rng.integers(-8, 9, (len(labels),) + prototypes.shape[1:], dtype=np.int16)
        return np.clip(prototypes[labels].astype(np.int16) + noise, 0, 255).astype(np.uint8)

    train_labels = np.repeat(np.arange(len(prototypes)), 5)
    val_labels = np.repeat(np.arange(len(prototypes)), 2)
    return noisy(train_labels), train_labels, noisy(val_labels), val_labels


def train_run(task, data, kernels) -> dict:
    """The main training path, with launch counts read around it."""
    images, labels, val, val_labels = data
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = task.train_trials([(TRAIN_LR, TRAIN_WD)], images, labels, val, val_labels,
                            end_epoch=TRAIN_EPOCHS, keep_logits=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    n_train, n_val, B = len(labels), len(val_labels), task.static.batch_size
    steps = TRAIN_EPOCHS * (n_train // B + (n_train % B > 1))
    chunks = TRAIN_EPOCHS * -(-n_val // task.eval_chunk)
    want = {"attention_fwd": 12 * (steps + chunks), "fused_mlp_fwd": 12 * (steps + chunks),
            "fused_mlp_bwd": 12 * steps}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} for {steps} train steps and "
                             f"{chunks} eval chunks")
    loss = task.last_state.loss
    if not (torch.isfinite(loss) and np.isfinite(res[0]["best_logits"]).all()):
        raise AssertionError(f"non-finite training run: loss {loss}")
    return {"launches": launches, "train_steps": steps, "eval_chunks": chunks,
            "seconds": seconds, "last_loss": loss.item(), "best_score": res[0]["best_score"],
            "last_score": res[0]["last_score"]}


def train_throughput(task, data) -> float:
    """Train images/s over two epochs of 3 full batches, after a warm-up
    epoch, on the bundle the main run trained."""
    from pevit_tpu_torch.train import build_epoch_fn

    n = 3 * task.static.batch_size
    images = task.prepack(data[0][:n])
    labels = torch.as_tensor(data[1][:n]).cuda()
    epoch = build_epoch_fn(task.static, n, task.preproc)
    bundle, state = task.last_bundle, task.last_state
    state = epoch(bundle, images, labels, state, TRAIN_LR, TRAIN_WD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        state = epoch(bundle, images, labels, state, TRAIN_LR, TRAIN_WD)
    torch.cuda.synchronize()
    return 2 * n / (time.perf_counter() - t0)


def first_step_grads(task, images, labels) -> dict:
    """Gradients of the first step's loss for every trainable leaf, on a
    fresh bundle from a fixed seed (float32 copies)."""
    from pevit_tpu_torch.train import combine, model_forward, trainable_params
    from pevit_tpu_torch.train.trainer import _loss

    trainable, frozen, bn = task.init_bundle(torch.Generator().manual_seed(7))
    params = trainable_params(trainable)
    valid = torch.ones(len(labels), device="cuda")
    logits, _ = model_forward(task.static, combine(trainable, frozen), bn, task.prepack(images),
                              task.preproc, train=True, mask=valid)
    loss = _loss(task.static, logits, torch.as_tensor(labels).cuda(), valid)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).float()
            for (n, p), g in zip(params.items(), grads)}


def compare_grads(task, images, labels, dtype) -> dict:
    """First-step gradients, kernel path against plain path."""
    got = first_step_grads(task, images, labels)
    with plain_path():
        want = first_step_grads(task, images, labels)
    torch.cuda.synchronize()
    worst, unused = {}, []
    for n, g in got.items():
        w = want[n]
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"non-finite gradient of {n}")
        if n.rsplit(".", 1)[-1] in ("v_left", "v_right"):  # quirk 1: the forward never reads them
            if g.any() or w.any():
                raise AssertionError(f"{n}: unused factor with a non-zero gradient")
            unused.append(n)
            continue
        if n.startswith("peft") and not g.any():
            raise AssertionError(f"{n}: zero gradient on the kernel path")
        if dtype == torch.float32:
            gap = ((g - w).abs().max() / w.abs().max()).item()
            if gap > 1e-3:
                raise AssertionError(f"fp32 grad of {n}: kernel vs plain gap {gap} > 1e-3")
        else:
            gap = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
            if gap < 0.99:
                raise AssertionError(f"bf16 grad of {n}: cosine {gap} < 0.99")
        worst[n] = gap
    key = max if dtype == torch.float32 else min
    name = key(worst, key=worst.get)
    return {"dtype": str(dtype).split(".")[-1], "leaves": len(worst),
            "zero_by_quirk_1": len(unused),
            ("max_rel_gap" if dtype == torch.float32 else "min_cosine"): worst[name],
            "at": name}


def compare_whole_run(task, data) -> dict:
    """Two fp32 epochs from one seeded bundle, in one order, kernel path
    against plain path; per-epoch val logits."""
    from pevit_tpu_torch.train import (TrainState, build_fit_eval_fn, combine, make_optimizer,
                                       trainable_params)

    images, labels, val, val_labels = data
    st = task.static
    fit_eval = build_fit_eval_fn(st, len(labels), TRAIN_EPOCHS, task.preproc,
                                 eval_chunk=task.eval_chunk, n_val=len(val_labels))
    orders = [np.random.default_rng(e).permutation(len(labels)) for e in range(TRAIN_EPOCHS)]
    opt_init, _ = make_optimizer(st.optimizer, momentum=st.momentum, nesterov=st.nesterov)
    x, y, xv = task.prepack(images), torch.as_tensor(labels).cuda(), task.prepack(val)

    def run():
        trainable, frozen, bn = task.init_bundle(torch.Generator().manual_seed(11))
        params = trainable_params(trainable)
        state = TrainState(params, opt_init(params), bn, torch.Generator().manual_seed(12))
        return fit_eval(combine(trainable, frozen), x, y, xv, state,
                        [TRAIN_LR] * TRAIN_EPOCHS, TRAIN_WD, orders)[1]

    got = run()
    with plain_path():
        want = run()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite val logits on the kernel path")
    gaps = [(got[e] - want[e]).abs().max().item() for e in range(TRAIN_EPOCHS)]
    scale = want.abs().max().item()
    if max(gaps) > 1e-3 * scale:
        raise AssertionError(f"fp32 whole run: val logit gaps {gaps} > 1e-3 * {scale}")
    moved = (want[-1] - want[0]).abs().max().item()  # what training changed meanwhile
    return {"dtype": "float32", "epoch_max_abs_gaps": gaps, "max_abs_logit": scale,
            "max_abs_change_first_to_last_epoch": moved}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from pevit_tpu_torch.ops import KERNELS, build_all
    from pevit_tpu_torch.serve import InferencePipeline, make_serving_fn
    from pevit_tpu_torch.utils.device import resolve_device

    # 1. card
    card = card_line()
    print(card, flush=True)
    resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print("\n".join(ptxas_summary(name, log)), flush=True)

    # 3. kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = SERVE_BATCH * 50
    table = {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (50, 197, 257):
            table["attention_fwd"].append(check_attention(gen, dtype, n))
        for c in (768, 1024):
            table["fused_mlp_fwd"].append(check_fused_mlp(gen, dtype, c, rows))
    table["attention_fwd"].append(check_attention(gen, torch.bfloat16, 50, TRAIN_BATCH))
    table["fused_mlp_fwd"].append(check_fused_mlp(gen, torch.bfloat16, 768, TRAIN_BATCH * 50))

    # 3b. the fused-MLP backward, and the attention core's plain backward
    for dtype in (torch.bfloat16, torch.float32):
        for c in (768, 1024):
            table["fused_mlp_bwd"].append(check_fused_mlp_bwd(gen, dtype, c, TRAIN_BATCH * 50))
    for name, rows_ in table.items():
        for r in rows_:
            print(f"kernel {name} {json.dumps(r)} [{card}]", flush=True)
    attn_bwd = time_attention_bwd(gen, torch.bfloat16, 50, TRAIN_BATCH)
    print(f"plain attention_bwd_ref {json.dumps(attn_bwd)} [{card}]", flush=True)

    # 4. serving
    static, trainable, frozen, bn, preproc = build_classifier(seed=0)
    res = static.spec.vision.input_resolution
    rng = np.random.default_rng(0)
    prototypes = rng.integers(0, 256, (static.num_classes, res, res, 3), dtype=np.uint8)
    fit_prototype_head(static, trainable, frozen, bn, preproc, prototypes)
    serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
    serve(prototypes[:8])  # warm-up
    torch.cuda.synchronize()
    run = serve_requests(serve, [k for k in KERNELS if k.name != "fused_mlp_bwd"], res, rng)
    lat = run["stats"]["latency"]
    print(f"served {run['images']} images in 16 requests, {run['forwards']} forwards, "
          f"launches {run['launches']}; latency {json.dumps(lat)} [{card}]", flush=True)

    # noisy copies of the prototypes, each labelled with its prototype's class
    labels = np.arange(SERVE_BATCH) % static.num_classes
    noise = rng.integers(-8, 9, (SERVE_BATCH, res, res, 3))
    batch = torch.from_numpy(np.clip(prototypes[labels] + noise, 0, 255).astype(np.uint8))
    labels = torch.from_numpy(labels).cuda()
    checks = [compare_plain(serve, batch.cuda(), labels, torch.bfloat16)]
    static32 = dataclasses.replace(static, compute_dtype="float32")
    serve32 = make_serving_fn(static32, trainable, frozen, bn, preproc, device="cuda")
    checks.append(compare_plain(serve32, batch[:64].cuda(), labels[:64], torch.float32))
    for c in checks:
        print(f"serving logits kernel vs plain path: {json.dumps(c)}", flush=True)

    pipe = InferencePipeline(serve, device="cuda", max_batch=SERVE_BATCH)
    stream = [batch.numpy()] * 8
    pipe.run(stream[:1])
    pipe.stats.update(images=0, batches=0, seconds=0.0)
    pipe.run(stream)
    print(f"throughput bf16 batch {SERVE_BATCH}: {pipe.throughput} images/s [{card}]",
          flush=True)

    # 5. training
    clip = frozen["clip"]
    data = train_data(prototypes, rng)
    task = make_task(clip, "bfloat16", dropout_p=0.5)
    train = train_run(task, data, KERNELS)
    print(f"trained bf16 batch {TRAIN_BATCH}, dropout 0.5: {json.dumps(train)} [{card}]",
          flush=True)
    ips = train_throughput(task, data)
    print(f"train throughput bf16 batch {TRAIN_BATCH}: {ips} images/s [{card}]", flush=True)
    batch_x, batch_y = data[0][:TRAIN_BATCH], data[1][:TRAIN_BATCH]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        gaps = compare_grads(make_task(clip, dtype_name, 0.0), batch_x, batch_y, dtype)
        print(f"first-step gradients kernel vs plain path: {json.dumps(gaps)} [{card}]",
              flush=True)
    run32 = compare_whole_run(make_task(clip, "float32", 0.0), data)
    print(f"whole-run val logits kernel vs plain path: {json.dumps(run32)} [{card}]", flush=True)

    # 6. report
    repo = Path(__file__).resolve().parent
    report = []
    for k in KERNELS:
        # bf16: K1 and K2 at the batch-256 serving shape, K3 at the batch-128
        # training shape; launches from the training run
        main_row = table[k.name][0]
        report.append({"name": k.name, "route": "cuda",
                       "source": str(k.source.relative_to(repo)),
                       "replaces": k.replaces, "launches": train["launches"][k.name],
                       **{key: main_row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                         "bound_ms", "bound_by", "library_ms")}})
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
