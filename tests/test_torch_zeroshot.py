"""Zero-shot evaluation against pevit_tpu/evaluation/zeroshot.py and
pevit_tpu/commands/zeroshot.py, float32 on the CPU, on a tiny CLIP written
as an OpenAI-layout checkpoint (vision 128 x 2 layers, patch 16, 32 px;
text 64 x 2 layers, the full 49408-token vocabulary), which both packages
load:

* ``extract_image_features`` agrees within 1e-5 of the largest feature,
  with the last chunk zero-padded (11 images in chunks of 4, and 160 in
  one chunk of 256);
* ``clip_zeroshot_evaluator`` gives the same score and logits on the same
  features, and scores 0.0 when the metric raises, in both packages;
* the command run through both packages on synthetic cifar-10 writes the
  same predictions JSON (probabilities within 1e-5, everything else equal)
  and the same features; a second port run replays both feature caches
  without computing a feature.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pevit_tpu_torch.evaluation as pevaluation
from pevit_tpu.ckpt import load_clip as jload_clip
from pevit_tpu.commands import zeroshot as jzeroshot
from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.evaluation import zeroshot as jzs
from pevit_tpu_torch.ckpt import clip_to_state_dict, load_clip
from pevit_tpu_torch.commands import zeroshot as pzeroshot
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.core import CLIPSpec, init_clip_params
from pevit_tpu_torch.core.clip import TextSpec, VisionSpec
from pevit_tpu_torch.evaluation import zeroshot as pzs

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
TINY = CLIPSpec(embed_dim=32,
                vision=VisionSpec(input_resolution=32, patch_size=16, width=128, layers=2, heads=2,
                                  output_dim=32),
                text=TextSpec(context_length=77, vocab_size=49408, width=64, heads=1, layers=2,
                              output_dim=32))


def write_tiny_checkpoint(path: Path, seed: int = 0) -> str:
    """A seeded tiny CLIP as an OpenAI-layout ``torch.save`` state dict."""
    clip = init_clip_params(torch.Generator().manual_seed(seed), TINY, device="cpu")
    torch.save(clip_to_state_dict(clip), path)
    return str(path)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(tmp_path_factory.mktemp("ckpt") / "tiny_clip.pt")


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= TOL * scale, f"{what}: max err {err} > {TOL} * {scale}"


@pytest.mark.parametrize("n,chunk", [(11, 4), (160, 256)])
def test_image_features_match_the_reference(checkpoint, n, chunk):
    params, jspec = jload_clip("ViT-B/32", checkpoint_path=checkpoint)
    clip, spec = load_clip("ViT-B/32", checkpoint_path=checkpoint, device="cpu")
    images = np.random.default_rng(n).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        want = jzs.extract_image_features(jax_defaults(), params, jspec, images, chunk=chunk)
    got = pzs.extract_image_features(get_default_config(), clip, spec, images, chunk=chunk)
    assert got.dtype == np.float32
    _close(got, want, "image features")
    # a tensor input gives the same features
    np.testing.assert_array_equal(
        pzs.extract_image_features(get_default_config(), clip, spec, torch.from_numpy(images),
                                   chunk=chunk), got)


@pytest.mark.parametrize("metric", ["accuracy", "mean-per-class", "no_such_metric"])
def test_evaluator_matches_the_reference(metric):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((20, 32)).astype(np.float32)
    text = rng.standard_normal((32, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 20)
    results = []
    for make, fn in ((jax_defaults, jzs.clip_zeroshot_evaluator),
                     (get_default_config, pzs.clip_zeroshot_evaluator)):
        cfg = make()
        cfg.defrost()
        cfg.TEST.METRIC = metric
        results.append(fn(feats.copy(), text, labels, cfg))
    (jres, jlogits, jname), (pres, plogits, pname) = results
    assert pres == jres and pname == jname
    np.testing.assert_array_equal(plogits, jlogits)
    if metric == "no_such_metric":
        assert pres == 0.0


def _argv(tmp_path, checkpoint, *device):
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model/vitb32_CLIP.yaml"), *device,
            "MODEL.PRETRAINED", checkpoint, "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(tmp_path / "data"), "OUTPUT_DIR", str(tmp_path / "out"),
            "TRAIN.IMAGE_SIZE", "[32,32]"]


PRED = "predictions/zeroshot_eval_wiki_False_wnh_False_wnd_False_gpt3_False/seed0_cifar-10.json"
FEATS = ("features/cifar-10_ViT-B_32_image.npy", "features/cifar-10_ViT-B_32_text.npy")


def test_command_matches_the_reference_and_replays_its_cache(checkpoint, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)  # knowledge and metadata paths are relative
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    with jax.default_matmul_precision("highest"):
        jres = jzeroshot.main(_argv(jdir, checkpoint))
    pres = pzeroshot.main(_argv(pdir, checkpoint, "--device", "cpu"))
    want = json.loads((jdir / "out" / PRED).read_text())
    got = json.loads((pdir / "out" / PRED).read_text())
    assert list(got) == list(want)
    preds = got.pop("predictions")
    np.testing.assert_allclose(np.sum(preds[0], axis=-1), 1.0, atol=1e-4)
    assert np.asarray(preds).shape == (1, 160, 10)
    _close(preds, want.pop("predictions"), "predictions")
    assert got == want
    assert abs(pres - jres) <= 1e-9 or np.isclose(pres, jres)
    for f in FEATS:
        _close(np.load(pdir / "out" / f), np.load(jdir / "out" / f), f)

    def no_features(*a, **k):
        raise AssertionError("a cached feature must not be computed again")

    monkeypatch.setattr(pevaluation, "extract_image_features", no_features)
    monkeypatch.setattr(pevaluation, "extract_text_features", no_features)
    assert pzeroshot.main(_argv(pdir, checkpoint, "--device", "cpu")) == pres
    assert json.loads((pdir / "out" / PRED).read_text())["predictions"] == preds
