"""The PEFT commands (KAdaptation, LoRA, the adapter, Compacter) against
pevit_tpu.commands, on the CPU, at a tiny spec (vision width 64 x 2
layers, text width 64 x 2 layers x 8 heads, 32-px images, synthetic
cifar-10, 5 shots):

* both packages' command runs on one argument list with ``load_clip`` and
  ``run_method`` replaced, by attribute, in both packages; the config, the
  splits and the text-feature head init that reach ``run_method`` agree
  (the weights at 1e-5), as do the artifacts written from one result;
* ``TrainTask.model_info`` equals the JAX task's, the text tower counted;
* one whole port run of each with the sweep on (END_EPOCH 1) writes the
  reference's JSON and TXT artifacts, which ``read_txt.py``'s pattern reads,
  and a second run replays from the completion sidecar without loading a
  model;
* the parts not ported yet raise.

The linear-probe, finetune, zero-shot and submission commands are held to
the reference in tests/test_torch_commands.py.
"""

import importlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pevit_tpu.ckpt
import pevit_tpu.train
import pevit_tpu_torch.ckpt
import pevit_tpu_torch.train
from pevit_tpu.commands import kronecker_adaptation_clip as jax_cli
from pevit_tpu.config.cfg_node import _to_plain as jax_plain
from pevit_tpu.core import init_clip_params
from pevit_tpu_torch import bridge
from pevit_tpu_torch.commands import kronecker_adaptation_clip as port_cli
from pevit_tpu_torch.config.cfg_node import _to_plain
from read_txt import LINE_RE

REPO = Path(__file__).resolve().parents[1]
SCHEMA = ["model_name", "dataset_name", "num_trainable_params", "num_params", "num_visual_params",
          "num_backbone_params", "n_shot", "rnd_seeds", "predictions"]


def _tiny_model(tmp_path) -> str:
    text = (REPO / "resources/model/vitb32_CLIP.yaml").read_text()
    for a, b in (("WIDTH: 768", "WIDTH: 64"), ("WIDTH: 512", "WIDTH: 64"), ("LAYERS: 12", "LAYERS: 2"),
                 ("END_EPOCH: 10", "END_EPOCH: 1"), ("EXTRA_FINAL_TRAIN_EPOCH: 40",
                                                     "EXTRA_FINAL_TRAIN_EPOCH: 1")):
        assert a in text
        text = text.replace(a, b)
    path = tmp_path / "tiny_vitb32_CLIP.yaml"
    path.write_text(text)
    return str(path)


def _argv(tmp_path, *extra, device=()):
    """The launch script's arguments; ``device`` goes before the KEY VALUE
    overrides, which take the rest of the line."""
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"), "--model", _tiny_model(tmp_path),
            "--no-tuning", "False", *device, "DATASET.NUM_SAMPLES_PER_CLASS", "5",
            "DATASET.RANDOM_SEED_SAMPLING", "0", "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", "True",
            "MODEL.PRETRAINED", "random", "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(tmp_path / "data"), "OUTPUT_DIR", str(tmp_path / "out"),
            "TRAIN.IMAGE_SIZE", "[32,32]", *extra]


def _artifacts(tmp_path):
    folder = tmp_path / "out" / "predictions" / "finetuning_5"
    return (json.loads((folder / "seed0_cifar-10.json").read_text()),
            (folder / "seed0_cifar-10.txt").read_text())


CPU = ("--device", "cpu")
BASELINES = ("lora_clip", "adapter_clip", "compacter_clip")


def _clis(name):
    """(JAX command module, port command module) of one baseline."""
    return (importlib.import_module(f"pevit_tpu.commands.{name}"),
            importlib.import_module(f"pevit_tpu_torch.commands.{name}"))
RESULT_INFO = {"n_trainable_params": 1234, "n_params": 5678, "n_visual_params": 910,
               "n_backbone_params": 1112}


def _same_inputs(tmp_path, monkeypatch, jax_cli, port_cli):
    """Both packages' command on one argument list, up to ``run_method``;
    returns (JAX task, port task)."""
    monkeypatch.chdir(REPO)  # knowledge and metadata paths are relative
    seen = {}

    def fake_run_method(name):
        def run_method(task, data, config, **kw):
            seen[name] = (task, data, config, kw)
            return 61.25, {**RESULT_INFO, "best_logits": np.full((160, 10), 0.1, np.float32)}
        return run_method

    def jax_load_clip(name, *, spec_hint, seed, **kw):
        params = init_clip_params(jax.random.PRNGKey(seed), spec_hint)
        seen["params"] = jax.tree.map(np.asarray, params)
        return params, spec_hint

    def port_load_clip(name, *, spec_hint, seed, device, **kw):
        return bridge.clip_from_jax(seen["params"], spec_hint, device=device), spec_hint

    monkeypatch.setattr(pevit_tpu.ckpt, "load_clip", jax_load_clip)
    monkeypatch.setattr(pevit_tpu.train, "run_method", fake_run_method("jax"))
    monkeypatch.setattr(pevit_tpu_torch.ckpt, "load_clip", port_load_clip)
    monkeypatch.setattr(pevit_tpu_torch.train, "run_method", fake_run_method("port"))

    with jax.default_matmul_precision("highest"):
        assert jax_cli.main(_argv(tmp_path))[0] == 61.25
    jax_artifacts = _artifacts(tmp_path)
    assert port_cli.main(_argv(tmp_path, device=CPU))[0] == 61.25
    assert _artifacts(tmp_path) == jax_artifacts

    jtask, jdata, jcfg, jkw = seen["jax"]
    ptask, pdata, pcfg, pkw = seen["port"]
    assert _to_plain(pcfg) == jax_plain(jcfg)
    assert len(pdata) == len(jdata) == 6
    for g, w in zip(pdata, jdata):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    drop = lambda kw: {k: v for k, v in kw.items() if k != "rebuild_data"}
    assert drop(pkw) == drop(jkw) == {"no_tuning": False, "lr": 0.001, "l2": 0.316, "seed": 0}

    want, got = np.asarray(jtask.text_init_weights), ptask.text_init_weights
    assert got.shape == want.shape == (512, 10)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert ptask.static.peft_cfg.method == jtask.static.peft_cfg.method
    assert ptask.eval_chunk == jtask.eval_chunk
    return jtask, ptask


def _model_info(jtask, ptask):
    """Both tasks' ``model_info`` on a freshly drawn trainable partition."""
    jtrainable = jtask.init_bundle(jax.random.PRNGKey(0))[0]
    ptrainable = ptask.init_bundle(torch.Generator().manual_seed(0))[0]
    return ptask.model_info(ptrainable), jtask.model_info(jtrainable)


def test_both_commands_hand_run_method_the_same_inputs(tmp_path, monkeypatch):
    jtask, ptask = _same_inputs(tmp_path, monkeypatch, jax_cli, port_cli)
    # repair: the port's counts include the text tower, as the reference's do
    info, want = _model_info(jtask, ptask)
    assert info == want
    text_n = sum(p.numel() for p in ptask.clip.text.parameters())
    assert text_n > 3_000_000 and info["n_backbone_params"] > text_n


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_commands_hand_run_method_the_same_inputs(tmp_path, monkeypatch, name):
    """LoRA, the adapter and Compacter: the same inputs reach ``run_method``
    in both packages, and ``model_info`` is JAX's (Compacter's frozen rule
    counted in the backbone only)."""
    jtask, ptask = _same_inputs(tmp_path, monkeypatch, *_clis(name))
    assert ptask.static.use_fused_mlp is (name == "lora_clip")
    info, want = _model_info(jtask, ptask)
    assert info == want
    assert info["n_backbone_params"] - info["n_visual_params"] == sum(
        p.numel() for p in ptask.clip.text.parameters()) + 1


def _whole_run(tmp_path, monkeypatch, cli):
    monkeypatch.chdir(REPO)
    argv = _argv(tmp_path, device=CPU)
    best, info = cli.main(argv)
    data, txt = _artifacts(tmp_path)
    assert list(data) == SCHEMA
    assert data["model_name"] == "ViT-B/32" and data["dataset_name"] == "cifar-10"
    assert data["n_shot"] == 5 and data["rnd_seeds"] == [0]
    preds = np.asarray(data["predictions"][0])
    assert preds.shape == (160, 10)
    np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-4)
    m = LINE_RE.search(txt)
    assert m and float(m.group(1)) == best and int(m.group(2)) == info["n_params"]
    assert float(m.group(3)) == info["n_trainable_params"] / 1e6
    assert 0 < info["best_lr"] <= 0.1 and info["best_l2_lambda"] > 0

    (cache,) = (tmp_path / "out" / "cifar-10" / "sweep_cache").iterdir()
    trials = {(r["lr"], r["wd"]) for r in map(json.loads, cache.read_text().splitlines())}
    assert 42 <= len(trials) <= 90

    def no_model(*a, **k):
        raise AssertionError("a finished job must replay, not load a model")

    monkeypatch.setattr(pevit_tpu_torch.ckpt, "load_clip", no_model)
    best2, info2 = cli.main(argv)
    assert best2 == best and {k: info2[k] for k in RESULT_INFO} == {k: info[k] for k in RESULT_INFO}
    np.testing.assert_allclose(info2["best_logits"], preds)
    return info


def test_whole_run_writes_the_reference_artifacts_and_replays(tmp_path, monkeypatch):
    _whole_run(tmp_path, monkeypatch, port_cli)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_commands_write_the_reference_artifacts_and_replay(tmp_path, monkeypatch, name):
    info = _whole_run(tmp_path, monkeypatch, _clis(name)[1])
    # Compacter's 64-element rule stays frozen: one layer of 64-wide tower
    # has 2 x 64 LN + 4 x (16 + 16) + 64 down + 4 x (16 + 16) + 64 up
    n_peft = {"lora": 2 * 4 * 64 * 4, "adapter": 2 * (2 * 64 + 64 * 64 + 64 + 64 * 64 + 64),
              "compacter": 2 * (2 * 64 + 128 + 64 + 128 + 64)}[name.removesuffix("_clip")]
    assert info["n_trainable_params"] == n_peft + 512 * 10 + 10  # + the head


@pytest.mark.parametrize("case", ["submit", "backbone", "checkpoint"])
def test_unported_parts_raise(tmp_path, monkeypatch, case):
    """What the KAdaptation command refuses raises before any training, as
    the reference refuses it: an auxiliary backbone (``get_model``'s names
    take the linear probe and finetune only) and a ResNet CLIP checkpoint
    (PEFT hooks are ViT-only; the reference raises at the first forward);
    ``--submit-predictions`` without ``--submit-by`` fails the reference's
    assertion."""
    from pevit_tpu_torch.ckpt import clip_to_state_dict
    from pevit_tpu_torch.core import CLIPSpec as PortSpec, init_clip_params as port_init
    from pevit_tpu_torch.core.clip import TextSpec as PortText
    from pevit_tpu_torch.core.resnet import ResNetSpec

    monkeypatch.chdir(REPO)
    ckpt = tmp_path / "RN50.pt"
    rn = PortSpec(embed_dim=32, vision_rn=ResNetSpec(32, 8, (1, 1, 1, 1), 32),
                  text=PortText(context_length=8, vocab_size=64, width=32, heads=1, layers=1,
                                output_dim=32))
    torch.save(clip_to_state_dict(port_init(torch.Generator().manual_seed(0), rn, device="cpu")),
               ckpt)
    options, overrides, error = {
        "submit": (("--submit-predictions",), (), AssertionError),
        "backbone": ((), ("MODEL.NAME", "mae_vitb16"), ValueError),
        "checkpoint": ((), ("MODEL.PRETRAINED", str(ckpt)), ValueError),
    }[case]

    def no_training(*a, **k):
        raise RuntimeError("nothing may train")

    monkeypatch.setattr(pevit_tpu_torch.train, "run_method", no_training)
    with pytest.raises(error) as info:
        port_cli.main(_argv(tmp_path, *overrides, device=CPU + options))
    if error is ValueError:
        assert ("requires a CLIP backbone" if case == "backbone" else "ViT-only") in str(info.value)
