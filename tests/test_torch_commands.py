"""The linear-probe, finetune and submission commands against
pevit_tpu.commands, on the CPU, float32 (TPU.PARITY_FP32), on the tiny CLIP
of tests/test_torch_zeroshot.py written as an OpenAI-layout checkpoint that
both packages load (vision 128 x 2 layers, patch 16, 32 px; text 64 x 2
layers), with synthetic cifar-10, 5 shots and the head initialised from
text features:

* ``linear_probe`` and ``finetune`` with ``--no-tuning True`` and with the
  LR x WD sweep: the same best accuracy and chosen (lr, wd), the same
  predictions JSON (probabilities within 1e-5, everything else equal) and
  the same TXT line;
* ``--emulate-zeroshot``: the same result in both packages, and the port
  takes no train step (the head keeps the text features);
* ``--submit-predictions`` validates what it would submit in both packages
  and raises on predictions off the probability simplex;
* ``prepare_submit`` writes the same zip as the reference's.
"""

import json
import shutil
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest

import pevit_tpu.train
import pevit_tpu_torch.train
from pevit_tpu.commands import finetune as jfinetune
from pevit_tpu.commands import linear_probe as jlinear_probe
from pevit_tpu.commands import prediction_submission as jsubmission
from pevit_tpu.commands import prepare_submit as jprepare_submit
from pevit_tpu_torch.commands import finetune as pfinetune
from pevit_tpu_torch.commands import linear_probe as plinear_probe
from pevit_tpu_torch.commands import prediction_submission as psubmission
from pevit_tpu_torch.commands import prepare_submit as pprepare_submit
from pevit_tpu_torch.commands._common import json_prec_dump

from .test_torch_zeroshot import write_tiny_checkpoint

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
# the sweep's weight decays up to 1, not 1e6: at lr * wd >= 1 one SGD step
# wipes the head, and the test accuracy would rest on near-tied logits
SWEEP_GRID = ("TRAIN.SEARCH_WD_LOG_UPPER", "0")
COMMANDS = {"linear_probe": (jlinear_probe, plinear_probe, "linear_probe"),
            "full_finetune": (jfinetune, pfinetune, "finetuning")}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt")


def _argv(out, checkpoint, *options, device=()):
    """``device`` goes before the KEY VALUE overrides, which take the rest of
    the line."""
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model/vitb32_CLIP.yaml"), *options, *device,
            "DATASET.NUM_SAMPLES_PER_CLASS", "5", "DATASET.RANDOM_SEED_SAMPLING", "0",
            "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", "True", "MODEL.PRETRAINED", checkpoint,
            "DATASET.ALLOW_SYNTHETIC", "True", "DATASET.ROOT", str(out / "data"),
            "OUTPUT_DIR", str(out / "out"), "TRAIN.IMAGE_SIZE", "[32,32]",
            "TPU.PARITY_FP32", "True", "TRAIN.END_EPOCH", "1",
            "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", "1"]


def _artifacts(out, folder):
    base = out / "out" / "predictions" / folder / "seed0_cifar-10"
    return (json.loads(base.with_suffix(".json").read_text()),
            base.with_suffix(".txt").read_text())


def _run_both(tmp_path, checkpoint, method, *options, overrides=(), shots="5"):
    jmod, pmod, prefix = COMMANDS[method]
    folder = f"{prefix}_{shots}"
    jout, pout = tmp_path / "jax", tmp_path / "port"
    with jax.default_matmul_precision("highest"):
        jres = jmod.main(_argv(jout, checkpoint, *options) + list(overrides))
    pres = pmod.main(_argv(pout, checkpoint, *options, device=("--device", "cpu"))
                     + list(overrides))
    return jres, pres, _artifacts(jout, folder), _artifacts(pout, folder)


def _same_artifacts(got, want):
    (gj, gtxt), (wj, wtxt) = got, want
    assert list(gj) == list(wj)
    gp, wp = np.asarray(gj.pop("predictions")), np.asarray(wj.pop("predictions"))
    assert gp.shape == wp.shape and gp.shape[0] == 1
    np.testing.assert_allclose(gp.sum(-1), 1.0, atol=1e-4)
    err = np.abs(gp - wp).max()
    assert err <= TOL, f"predictions: max err {err} > {TOL}"
    assert gj == wj
    assert gtxt == wtxt


@pytest.mark.parametrize("tuning", ["no_tuning", "sweep"])
@pytest.mark.parametrize("method", ["linear_probe", "full_finetune"])
def test_command_matches_the_reference(checkpoint, tmp_path, monkeypatch, method, tuning):
    monkeypatch.chdir(REPO)  # knowledge and metadata paths are relative
    options = (("--no-tuning", "True", "--lr", "0.01", "--l2", "0.001") if tuning == "no_tuning"
               else ("--no-tuning", "False"))
    (jacc, jinfo), (pacc, pinfo), want, got = _run_both(tmp_path, checkpoint, method, *options,
                                                        overrides=SWEEP_GRID)
    assert pacc == jacc
    assert (pinfo["best_lr"], pinfo["best_l2_lambda"]) == (jinfo["best_lr"], jinfo["best_l2_lambda"])
    for key in ("n_trainable_params", "n_params", "n_visual_params", "n_backbone_params"):
        assert pinfo[key] == jinfo[key], key
    if method == "full_finetune":  # the visual tower and the head train; the text tower does not
        assert pinfo["n_trainable_params"] == pinfo["n_visual_params"] + 33 * 10
    else:
        assert pinfo["n_trainable_params"] == 33 * 10
    _same_artifacts(got, want)
    if tuning == "sweep":
        cache = tmp_path / "port" / "out" / "cifar-10" / "sweep_cache"
        (records,) = cache.iterdir()
        assert 42 <= len(records.read_text().splitlines()) <= 90


def test_emulated_zero_shot_matches_the_reference_and_takes_no_step(checkpoint, tmp_path,
                                                                    monkeypatch):
    monkeypatch.chdir(REPO)
    seen = {}
    run_method = pevit_tpu_torch.train.run_method

    def spy(task, *a, **k):
        seen["task"] = task
        return run_method(task, *a, **k)

    monkeypatch.setattr(pevit_tpu_torch.train, "run_method", spy)
    (jacc, jinfo), (pacc, pinfo), want, got = _run_both(
        tmp_path, checkpoint, "linear_probe", "--emulate-zeroshot", "True", shots="full")
    assert pacc == jacc and pinfo["best_lr"] == jinfo["best_lr"]
    # the emulation drops the shots (the artifacts go to linear_probe_full)
    # and the epochs asked for
    assert want[0]["n_shot"] == got[0]["n_shot"] == 0
    _same_artifacts(got, want)
    task = seen["task"]
    assert task.static.emulate_zero_shot and task.last_state.loss is None
    np.testing.assert_array_equal(task.last_bundle["head"].linear.kernel.detach().numpy(),
                                  task.text_init_weights)


def test_submit_predictions_validates_in_both_packages(checkpoint, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    seen = []
    for mod in (jsubmission, psubmission):
        def spy(submission, submit_by, config, real=mod.submit_predictions):
            real(submission, submit_by, config)  # raises on an invalid submission
            seen.append((submission, submit_by))
        monkeypatch.setattr(mod, "submit_predictions", spy)
    submit = ("--no-tuning", "True", "--submit-predictions", "--submit-by", "tester")
    (jacc, _), (pacc, _), want, got = _run_both(tmp_path, checkpoint, "linear_probe", *submit)
    assert pacc == jacc
    (jsub, jby), (psub, pby) = seen
    assert jby == pby == "tester"
    assert np.abs(np.asarray(psub.pop("predictions")) - np.asarray(jsub.pop("predictions"))).max() <= TOL
    assert psub == jsub
    _same_artifacts(got, want)

    # predictions off the simplex raise in both packages
    def bad_run_method(task, data, config, **kw):
        return 50.0, {"n_trainable_params": 1, "best_logits": np.full((160, 10), 0.5, np.float32)}

    monkeypatch.setattr(pevit_tpu.train, "run_method", bad_run_method)
    monkeypatch.setattr(pevit_tpu_torch.train, "run_method", bad_run_method)
    for mod, device in ((jlinear_probe, ()), (plinear_probe, ("--device", "cpu"))):
        out = tmp_path / f"bad_{mod.__name__.split('.')[0]}"
        with pytest.raises(ValueError, match="probability simplex"):
            mod.main(_argv(out, checkpoint, *submit, device=device))


def test_prepare_submit_writes_the_reference_zip(tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    src.mkdir()
    for dataset, n, k in (("cifar-10", 6, 10), ("caltech-101", 4, 3)):
        for seed in (0, 1, 2):
            p = rng.random((n, k))
            rec = {"model_name": "ViT-B/32", "dataset_name": dataset,
                   "num_trainable_params": 1000 + 10 * seed, "num_params": 5000,
                   "num_visual_params": 4000, "num_backbone_params": 4500, "n_shot": 5,
                   "rnd_seeds": [seed], "predictions": [(p / p.sum(-1, keepdims=True)).tolist()]}
            (src / f"seed{seed}_{dataset}.json").write_text(json_prec_dump(rec))
        (src / f"seed0_{dataset}.json.complete").write_text("{}")  # never combined
    zips = {}
    for name, mod in (("jax", jprepare_submit), ("port", pprepare_submit)):
        folder = tmp_path / name
        shutil.copytree(src, folder)
        zips[name] = mod.main(["--combine_path", str(folder)])
        assert zips[name] == str(folder / "all_predictions.zip")
    with zipfile.ZipFile(zips["jax"]) as zj, zipfile.ZipFile(zips["port"]) as zp:
        assert zp.namelist() == zj.namelist() == ["caltech-101.json", "cifar-10.json"]
        for name in zj.namelist():
            assert zp.read(name) == zj.read(name), name
        combined = json.loads(zp.read("cifar-10.json"))
    assert combined["rnd_seeds"] == [0, 1, 2] and len(combined["predictions"]) == 3
    assert combined["num_trainable_params"] == 1010.0
