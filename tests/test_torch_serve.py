"""The whole serving slice: the port's make_serving_fn, InferencePipeline,
MicroBatcher and make_server against the JAX reference's, on the same
bundle with non-zero KAdaptation factors, fp32, rtol = atol = 1e-5 on the
logits.  The JAX side runs with its fused MLP off and on (Pallas interpret
mode); the port's blocks always take the fused-MLP route."""

import dataclasses
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu.peft import PeftConfig
from pevit_tpu.serve import InferencePipeline as JaxPipeline
from pevit_tpu.serve import make_serving_fn as jax_make_serving_fn
from pevit_tpu.train.trainer import TaskStatic as JaxStatic
from pevit_tpu_torch.data import CLIP_MEAN, CLIP_STD
from pevit_tpu_torch.serve import InferencePipeline, MicroBatcher, make_serving_fn
from pevit_tpu_torch.serve_daemon import make_server
from pevit_tpu_torch.train import partition, trainable_pred
from pevit_tpu_torch.train.trainer import TaskStatic

from .test_torch_bridge import (  # noqa: F401  (bnhd_layout: autouse fixture)
    NUM_CLASSES, PORT_TINY, RES, TINY, bnhd_layout, jax_bundle, port_bundle)

TOL = dict(rtol=1e-5, atol=1e-5)
PREPROC = {"mean": np.array(CLIP_MEAN, np.float32), "std": np.array(CLIP_STD, np.float32)}


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, RES, RES, 3), dtype=np.uint8)


def jax_serve(bundle, bn, *, fused=False, reference_compat=True):
    static = JaxStatic(spec=TINY, peft_cfg=PeftConfig(method="kadaptation",
                                                      reference_compat=reference_compat),
                       num_classes=NUM_CLASSES, compute_dtype="float32", use_fused_mlp=fused)
    jb = jax.tree.map(jnp.asarray, bundle)
    frozen = jax.tree.map(lambda _: None, jb)
    return jax_make_serving_fn(static, jb, frozen, jax.tree.map(jnp.asarray, bn),
                               {k: jnp.asarray(v) for k, v in PREPROC.items()})


def port_serve(bundle, bn, *, reference_compat=True, device="cpu"):
    from pevit_tpu_torch.peft.base import PeftConfig as PortPeftConfig

    static = TaskStatic(spec=PORT_TINY, peft_cfg=PortPeftConfig(
        method="kadaptation", reference_compat=reference_compat),
        num_classes=NUM_CLASSES, compute_dtype="float32")
    ported, bn_t = port_bundle(bundle, bn, reference_compat=reference_compat)
    trainable, frozen = partition(ported, trainable_pred(static))
    return make_serving_fn(static, trainable, frozen, bn_t, PREPROC, device=device)


@pytest.fixture(scope="module")
def bundle():
    return jax_bundle(seed=0)


@pytest.fixture(scope="module")
def served(bundle):
    return port_serve(*bundle)


@pytest.fixture(scope="module")
def served_rowwise(bundle):
    """reference_compat=False: no scramble, so each row's logits do not
    depend on the batch it rides in (used where grouping is not fixed)."""
    return (port_serve(*bundle, reference_compat=False),
            jax_serve(*bundle, reference_compat=False))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_serving_fn_matches_jax(bundle, served, fused, batch):
    x = _images(batch, seed=batch)
    want = np.asarray(jax_serve(*bundle, fused=fused)(jnp.asarray(x)))
    got = served(x)
    assert got.dtype == torch.float32 and got.shape == (batch, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_scramble_is_live(bundle, served, served_rowwise):
    """The tests exercise quirk 4: batch composition changes the logits."""
    x = _images(8, seed=11)
    full = served(x).numpy()
    assert np.abs(full[:3] - served(x[:3]).numpy()).max() > 1e-3
    assert np.abs(full - served_rowwise[0](x).numpy()).max() > 1e-3


@pytest.mark.parametrize("pad_policy", ["exact", "bucket"])
def test_pipeline_matches_jax_pipeline(bundle, served, pad_policy):
    """Same stream, same settings; padding changes logits once the scramble
    is live, so the reference is the JAX pipeline, not the plain fn."""
    stream = [_images(n, seed=n) for n in (3, 17, 5, 1, 8)]
    kw = dict(max_batch=8, min_bucket=2, depth=3, pad_policy=pad_policy)
    got = InferencePipeline(served, device="cpu", **kw).run(stream)
    want = JaxPipeline(jax_serve(*bundle), **kw).run(stream)
    assert [g.shape for g in got] == [(n.shape[0], NUM_CLASSES) for n in stream]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def test_pipeline_buckets_and_stats(served):
    seen = []
    pipe = InferencePipeline(lambda x: (seen.append(x.shape[0]), served(x))[1], device="cpu",
                             max_batch=8, min_bucket=4)
    pipe.run([_images(n) for n in range(1, 10)])
    assert set(seen) == {4, 8}  # sizes 1..9 land on the 4 and 8 buckets (9 = 8 + 1)
    assert pipe.stats["images"] == sum(range(1, 10)) and pipe.throughput > 0


def test_micro_batcher_four_clients(served_rowwise):
    port, jax_fn = served_rowwise
    batcher = MicroBatcher(InferencePipeline(port, device="cpu", max_batch=16, min_bucket=2),
                           window_ms=20.0)
    requests = {i: [_images(n, seed=10 * i + n) for n in (1, 3, 2)] for i in range(4)}
    answers, errors = {}, []

    def client(i):
        try:
            answers[i] = [batcher.infer(x) for x in requests[i]]
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.close()
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(4):
        for x, got in zip(requests[i], answers[i]):
            np.testing.assert_allclose(got, np.asarray(jax_fn(jnp.asarray(x))), **TOL)
    assert batcher.stats["requests"] == 12 and batcher.latency_stats()["count"] == 12


def test_micro_batcher_reports_errors():
    def boom(x):
        raise RuntimeError("device fault")

    batcher = MicroBatcher(InferencePipeline(boom, device="cpu"), window_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="device fault"):
            batcher.infer(_images(2))
    finally:
        batcher.close()


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    with urllib.request.urlopen(urllib.request.Request(url + "/infer", data=buf.getvalue()),
                                timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def test_server_answers_on_localhost(served_rowwise):
    port, jax_fn = served_rowwise
    srv = make_server(port, RES, device="cpu", port=0, max_batch=8, min_bucket=2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "image_size": RES}
        x = _images(5, seed=3)
        np.testing.assert_allclose(_post(url, x), np.asarray(jax_fn(jnp.asarray(x))), **TOL)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, _images(2)[:, :8])
        assert err.value.code == 400
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["images"] == 5 and stats["requests"] == 1 and stats["latency"]["count"] == 1
    finally:
        srv.shutdown()
        srv.batcher.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_entry_points_need_cuda_unless_asked(bundle, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve(*bundle, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferencePipeline(lambda x: x)


def test_task_static_dtype():
    static = TaskStatic(spec=PORT_TINY, peft_cfg=None, num_classes=NUM_CLASSES)
    assert static.dtype == torch.bfloat16 and static.head_dim == PORT_TINY.embed_dim
    assert dataclasses.replace(static, compute_dtype="float32").dtype == torch.float32
    with pytest.raises(ValueError):
        dataclasses.replace(static, compute_dtype="float16").dtype
