"""The port's deployment tools on the CPU: ``tools.export_model``,
``serving_loader``, ``serve_daemon.main`` and ``tools.serve_bench``.

Mirrors tests/test_export_tool_cli.py (train -> checkpoint -> export ->
replay; the text-initialised zero-shot artifact; the zero-class guard;
serve_bench's default head), tests/test_serve_bench.py (the arms, the
request-size mix, the daemon arm) and tests/test_serve_daemon.py (health,
parity, bad requests, concurrent clients), and carries one trained state
written by the JAX package through both export tools to equal logits.
"""

import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pevit_tpu_torch.ckpt import save_trainable
from pevit_tpu_torch.commands import kronecker_adaptation_clip
from pevit_tpu_torch.serve import (exported_callable, is_baked, load_exported, make_serving_fn,
                                   serving_weights)
from pevit_tpu_torch.serve_daemon import config_from
from pevit_tpu_torch.serving_loader import build_task, load_serving_callable, restore_into
from pevit_tpu_torch.tools import export_model, serve_bench
from pevit_tpu_torch.train import combine

from .test_torch_zeroshot import write_tiny_checkpoint

REPO = Path(__file__).resolve().parents[1]
CIFAR = str(REPO / "resources/datasets/cifar10.yaml")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = ("--device", "cpu")


def _tiny_model(tmp_path) -> str:
    text = (REPO / "resources/model/vitb32_CLIP.yaml").read_text()
    for a, b in (("WIDTH: 768", "WIDTH: 64"), ("WIDTH: 512", "WIDTH: 64"),
                 ("LAYERS: 12", "LAYERS: 2"), ("END_EPOCH: 10", "END_EPOCH: 1"),
                 ("EXTRA_FINAL_TRAIN_EPOCH: 40", "EXTRA_FINAL_TRAIN_EPOCH: 1")):
        assert a in text
        text = text.replace(a, b)
    path = tmp_path / "tiny_vitb32_CLIP.yaml"
    path.write_text(text)
    return str(path)


def _opts(tmp_path, *extra):
    return ["MODEL.PRETRAINED", "random", "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(tmp_path / "data"), "OUTPUT_DIR", str(tmp_path / "out"),
            "TRAIN.IMAGE_SIZE", "[32,32]", "TPU.COMPUTE_DTYPE", "float32", *extra]


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    with urllib.request.urlopen(urllib.request.Request(url + "/infer", data=buf.getvalue()),
                                timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def test_train_checkpoint_export_replay(tmp_path, monkeypatch):
    """The command trains and writes TPU.CHECKPOINT_DIR, the export tool
    restores it into a program-only artifact, and the artifact, given a
    bundle rebuilt from a fresh init of another seed with the trained state
    restored on top, reproduces the in-process forward."""
    monkeypatch.chdir(REPO)
    model, ck = _tiny_model(tmp_path), str(tmp_path / "ck")
    best, _ = kronecker_adaptation_clip.main(
        ["--ds", CIFAR, "--model", model, "--no-tuning", "True", "--lr", "0.01", "--l2", "0.0001",
         *CPU, "DATASET.NUM_SAMPLES_PER_CLASS", "5", *_opts(tmp_path, "TPU.CHECKPOINT_DIR", ck)])
    assert best >= 0 and any(Path(ck).glob("step_*.npz"))
    out = tmp_path / "clf.pt2"
    ep = export_model.main(["--model", model, "--ds", CIFAR, "--ckpt-dir", ck,
                            "--weights-as-args", "--out", str(out), *CPU, *_opts(tmp_path)])
    assert out.stat().st_size > 0 and not is_baked(ep)
    image = [n for n in ep.graph.nodes if n.op == "placeholder"][-1].meta["val"]
    assert isinstance(image.shape[0], torch.SymInt)  # symbolic batch

    config = config_from(CIFAR, model, _opts(tmp_path))
    task, static, trainable, frozen, bn = build_task(config, "kadaptation", 1, "cpu")
    fresh = {n: p.detach().clone() for n, p in trainable["peft"].named_parameters()}
    restore_into(ck, trainable)
    assert any(not torch.equal(p, fresh[n]) for n, p in trainable["peft"].named_parameters())
    serve = make_serving_fn(static, trainable, frozen, bn, task.preproc, device="cpu")
    call = exported_callable(load_exported(out), serving_weights(trainable, frozen, bn),
                             device="cpu")
    x = _images(3)
    np.testing.assert_allclose(call(x).numpy(), serve(x).numpy(), **TOL)


def _jax_export_tool():
    spec = importlib.util.spec_from_file_location("export_model", REPO / "tools" / "export_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_jax_written_npz_through_both_export_tools(tmp_path, monkeypatch):
    """One OpenAI-layout checkpoint and a trained state written by the JAX
    package (its npz, Orbax absent): JAX's tools/export_model.py and the
    port's, both baked, replay to the same logits."""
    from pevit_tpu.ckpt import load_clip as jax_load_clip
    from pevit_tpu.ckpt import save_trainable as jax_save_trainable
    from pevit_tpu.config import get_default_config as jax_defaults
    from pevit_tpu.config import update_config as jax_update_config
    from pevit_tpu.core.clip import CLIPSpec as JaxCLIPSpec
    from pevit_tpu.peft import PeftConfig
    from pevit_tpu.serve import load_exported as jax_load_exported
    from pevit_tpu.train import TaskStatic as JaxStatic
    from pevit_tpu.train import TrainTask as JaxTask

    monkeypatch.chdir(REPO)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    model = _tiny_model(tmp_path)
    clip_file = write_tiny_checkpoint(tmp_path / "clip.pt")
    opts = ["MODEL.PRETRAINED", clip_file, "TRAIN.IMAGE_SIZE", "[32,32]",
            "TPU.COMPUTE_DTYPE", "float32"]

    class _Args:
        pass

    config = jax_defaults()
    for f in (CIFAR, model):
        _Args.cfg, _Args.opts = f, opts
        jax_update_config(config, _Args)
    params, spec = jax_load_clip("ViT-B/32", checkpoint_path=clip_file,
                                 spec_hint=JaxCLIPSpec.from_config(config))
    static = JaxStatic.from_config(config, spec, PeftConfig(method="kadaptation"))
    trainable, _, _ = JaxTask(config, static, params).init_bundle(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    trained = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32)), trainable)
    ck = str(tmp_path / "ck")
    jax_save_trainable(ck, trained, step=4)
    assert (tmp_path / "ck" / "step_4.npz").exists()

    with jax.default_matmul_precision("highest"):
        _jax_export_tool().main(["--model", model, "--ds", CIFAR, "--ckpt-dir", ck,
                                 "--out", str(tmp_path / "jax.stablehlo"), *opts])
    export_model.main(["--model", model, "--ds", CIFAR, "--ckpt-dir", ck,
                       "--out", str(tmp_path / "port.pt2"), *CPU, *opts])
    x = _images(5, seed=4)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_load_exported(tmp_path / "jax.stablehlo").call(jnp.asarray(x)))
    got = exported_callable(load_exported(tmp_path / "port.pt2"), device="cpu")(x).numpy()
    assert got.shape == want.shape == (5, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_zeroshot_export_text_head(tmp_path, monkeypatch):
    """TRAIN.INIT_HEAD_WITH_TEXT_ENCODER at export time: a zero-shot
    classifier artifact in one command, which the serving loader rebuilds
    from the artifact and the config alone."""
    monkeypatch.chdir(REPO)
    model = _tiny_model(tmp_path)
    opts = _opts(tmp_path, "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", "True")
    out = tmp_path / "zs.pt2"
    export_model.main(["--model", model, "--ds", CIFAR, "--method", "linear_probe",
                       "--weights-as-args", "--out", str(out), *CPU, *opts])
    config = config_from(CIFAR, model, opts)
    task, static, trainable, frozen, bn = build_task(config, "linear_probe", 0, "cpu")
    assert task.text_init_weights.shape[1] == 10
    serve = make_serving_fn(static, trainable, frozen, bn, task.preproc, device="cpu")
    x = _images(4, seed=1)
    ep = load_exported(out)
    np.testing.assert_allclose(
        exported_callable(ep, serving_weights(trainable, frozen, bn), device="cpu")(x).numpy(),
        serve(x).numpy(), **TOL)
    # the text init bites: a bundle built without it disagrees
    _, _, tr2, fr2, bn2 = build_task(config_from(CIFAR, model, _opts(tmp_path)), "linear_probe",
                                     0, "cpu")
    other = exported_callable(ep, serving_weights(tr2, fr2, bn2), device="cpu")(x).numpy()
    assert not np.allclose(other, serve(x).numpy(), atol=1e-3)
    call, size = load_serving_callable(artifact=str(out), config=config, method="linear_probe",
                                       verbose=False, device="cpu")
    assert size == 32
    np.testing.assert_allclose(call(x).numpy(), serve(x).numpy(), **TOL)


def test_serving_loader_zero_classes_fails_loudly():
    from pevit_tpu_torch.config import get_default_config

    cfg = get_default_config()
    assert cfg.DATASET.NUM_CLASSES == 0
    with pytest.raises(ValueError, match="NUM_CLASSES"):
        load_serving_callable(config=cfg, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="artifact or a config"):
        load_serving_callable(device="cpu")


def test_the_export_tool_exports_clip_swin_and_the_loader_still_refuses_it(tmp_path):
    """CLIP-Swin (a factory backbone) exports through tools.export_model; the
    artifact equals the in-process serving forward of the task the tool
    builds.  The serving loader builds CLIP towers only, as the reference's
    does, and refuses the name."""
    from .test_torch_swin import toy_clip_swin_yaml

    config = config_from(CIFAR, _tiny_model(tmp_path), ["MODEL.NAME", "clip_swin"])
    with pytest.raises(NotImplementedError, match="auxiliary backbones"):
        load_serving_callable(config=config, verbose=False, device="cpu")
    model = toy_clip_swin_yaml(tmp_path)
    opts = ["TRAIN.IMAGE_SIZE", "[32,32]", "TPU.COMPUTE_DTYPE", "float32"]
    out = tmp_path / "clip_swin.pt2"
    export_model.main(["--model", model, "--ds", CIFAR, "--method", "linear_probe",
                       "--out", str(out), *CPU, *opts])
    ep = load_exported(out)
    assert not any(".text." in n for n in ep.state_dict)
    task, static, trainable, frozen, bn = build_task(config_from(CIFAR, model, opts),
                                                     "linear_probe", 0, torch.device("cpu"),
                                                     backbones=True)
    serve = make_serving_fn(static, trainable, frozen, bn, task.preproc,
                            forward_fn=task._forward_fn, device="cpu")
    x = _images(3, seed=1)
    got, want = exported_callable(ep, device="cpu")(x), serve(x)
    assert got.shape == (3, 10)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# --mesh N is ported and refuses a world of fewer than N ranks, as the
# reference's tool refuses fewer than N devices; --platforms has no counterpart
@pytest.mark.parametrize("flag", [("--mesh", "4"), ("--platforms", "cpu,cuda")])
def test_export_tool_refuses_what_has_no_counterpart(tmp_path, flag):
    want = ((SystemExit, "needs 4 ranks") if flag[0] == "--mesh"
            else (NotImplementedError, "ROADMAP"))
    with pytest.raises(want[0], match=want[1]):
        export_model.main(["--model", _tiny_model(tmp_path), "--ds", CIFAR, *flag, *CPU,
                           *_opts(tmp_path)])


def test_serve_bench_defaults_num_classes(monkeypatch):
    captured = {}

    def fake_load(**kw):
        captured["config"] = kw["config"]
        raise SystemExit(0)  # stop before any device work

    monkeypatch.setattr("pevit_tpu_torch.serving_loader.load_serving_callable", fake_load)
    with pytest.raises(SystemExit):
        serve_bench.main(["--model", str(REPO / "resources/model/vitb32_CLIP.yaml"), *CPU,
                          "MODEL.PRETRAINED", "random"])
    assert captured["config"].DATASET.NUM_CLASSES == 100


@pytest.mark.parametrize("case", ["arms", "mix", "daemon"])
def test_serve_bench_arms_agree_and_report(tmp_path, capsys, case):
    """Every arm gives a positive throughput each rep and passes the tool's
    own cross-arm logits gate (a mismatch raises SystemExit in ``main``);
    the mix's two pad policies agree bit for bit on a tower whose factors
    are at their zero init."""
    extra, arms = {"arms": ((), {"naive", "pipe2"}),
                   "mix": (("--request-sizes", "5,3,8"), {"naive", "pipe2", "mix-bucket",
                                                          "mix-exact"}),
                   "daemon": (("--clients", "4", "--client-batch", "4"),
                              {"naive", "pipe2", "daemon4"})}[case]
    results = serve_bench.main(["--model", _tiny_model(tmp_path), "--ds", CIFAR, "--batch", "8",
                                "--images", "32", "--reps", "2", "--depths", "2", *extra, *CPU,
                                *_opts(tmp_path)])
    assert set(results) == arms
    assert all(len(r) == 2 and min(r) > 0 for r in results.values())
    out = capsys.readouterr().out
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert {x["arm"] for x in lines} == arms
    if case == "mix":
        assert "pad-policy numerics: max|bucket - exact| = 0.000000" in out


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """``python -m pevit_tpu_torch.serve_daemon`` deployed from a trained
    state on the CPU; yields (url, the in-process callable of the same
    config and state)."""
    tmp = tmp_path_factory.mktemp("daemon")
    model = _tiny_model(tmp)
    config = config_from(CIFAR, model, _opts(tmp))
    _, _, trainable, frozen, _ = build_task(config, "kadaptation", 0, "cpu")
    with torch.no_grad():
        for p in trainable["peft"].parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(2)) * 0.1)
    save_trainable(str(tmp / "ck"), combine(trainable, frozen), step=2)
    argv = [sys.executable, "-m", "pevit_tpu_torch.serve_daemon", "--model", model, "--ds", CIFAR,
            "--weights-from", str(tmp / "ck"), "--port", "0", "--pad-policy", "exact",
            "--max-batch", "8", "--min-bucket", "2", *CPU, *_opts(tmp)]
    proc = subprocess.Popen(argv, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving on "):
                url = line.split()[2]
                break
        assert url, f"the daemon exited {proc.wait()}"
        call, _ = load_serving_callable(config=config, weights_from=str(tmp / "ck"),
                                        verbose=False, device="cpu")
        yield url, call
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0  # a clean stop
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_daemon_health_and_logits_equal_the_in_process_callable(daemon):
    url, call = daemon
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "image_size": 32}
    x = _images(5, seed=9)
    np.testing.assert_array_equal(_post(url, x), call(x).numpy())
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["images"] >= 5 and stats["throughput"] > 0


def test_daemon_bad_requests_stay_up(daemon):
    url, call = daemon
    for bad in (np.zeros((2, 32, 32, 3), np.float32), np.zeros((2, 33, 33, 3), np.uint8)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, bad)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(url + "/infer", data=b"not-an-npy"),
                               timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404
    x = _images(3, seed=5)
    np.testing.assert_array_equal(_post(url, x), call(x).numpy())


def test_daemon_concurrent_clients_coalesce(daemon):
    """Concurrent requests share device groups and each client gets its
    own rows; with exact padding a coalesced group is one natural-size
    batch, so each answer is the callable's on the group's rows."""
    url, call = daemon
    payloads = [_images(2, seed=20 + i) for i in range(8)]
    results, errors = [None] * 8, []

    def client(i):
        try:
            results[i] = _post(url, payloads[i])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(r.shape == (2, 10) and np.isfinite(r).all() for r in results)
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["groups"] < stats["requests"]
