"""The commands over the auxiliary backbones and an RN CLIP, against
pevit_tpu.commands, on the CPU in float32 (TPU.PARITY_FP32), with synthetic
cifar-10, 5 shots, 1 + 1 epochs, and checkpoints written from seeded
tensors that both packages load (a timm ViT, a DeCLIP model with the
family's 49409-token vocabulary, an OpenAI-layout RN CLIP):

* each command hands ``run_method`` the same inputs in both packages: the
  config (with the MAE linear probe's global pool turned off), the task's
  static part, the data, the backbone's weights and the text-initialised
  head.  DeCLIP's is the one divergence: the reference's text head for an
  auxiliary backbone normalises a read-only array in place, raises, and
  falls back to a random head (ROADMAP §3); the port's equals the
  reference's text features computed as that code means them, through
  ``declip_tokenize``;
* whole commands: ``linear_probe`` on MAE, DeCLIP and RN, ``finetune`` on a
  timm ViT-B/16 and ``zeroshot`` on RN give the same result, the same
  predictions within 1e-5 and the same TXT line.  A head with no text
  features is drawn by each package's own generator, so both packages'
  ``init_head`` are given one seeded kernel in its place (``fixed_heads``),
  and the DeCLIP run has no text head;
* a PEFT method on a non-CLIP backbone raises ValueError in both.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pevit_tpu.train
import pevit_tpu_torch.train
from pevit_tpu.commands import finetune as jfinetune
from pevit_tpu.commands import kronecker_adaptation_clip as jkadapt
from pevit_tpu.commands import linear_probe as jlinear_probe
from pevit_tpu.commands import zeroshot as jzeroshot
from pevit_tpu_torch import bridge
from pevit_tpu_torch.ckpt import clip_to_state_dict
from pevit_tpu_torch.commands import finetune as pfinetune
from pevit_tpu_torch.commands import kronecker_adaptation_clip as pkadapt
from pevit_tpu_torch.commands import linear_probe as plinear_probe
from pevit_tpu_torch.commands import zeroshot as pzeroshot
from pevit_tpu_torch.core import CLIPSpec, init_clip_params
from pevit_tpu_torch.core.clip import TextSpec
from pevit_tpu_torch.core.resnet import ResNetSpec

from .test_torch_bridge import bnhd_layout  # noqa: F401  (autouse fixture)
from .test_torch_declip import declip_state_dict
from .test_torch_vit import flat, np_tree, timm_state_dict

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
RN_TINY = CLIPSpec(embed_dim=32, vision_rn=ResNetSpec(32, 8, (1, 1, 1, 1), 32),
                   text=TextSpec(context_length=77, vocab_size=49408, width=64, heads=1,
                                 layers=1, output_dim=32))


def _scaled(sd, scale=0.2):
    """Seeded weights at a size that keeps a tower's activations moderate."""
    return {k: torch.from_numpy(v if k.endswith(("ln_1.weight", "ln_2.weight", "norm1.weight",
                                                  "norm2.weight")) else v * scale)
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    rng = np.random.default_rng(0)
    paths = {"timm": d / "vit.pth", "declip": d / "declip.pth.tar", "rn": d / "RN.pt"}
    torch.save(_scaled(timm_state_dict(rng, patch=16, grid=2)), paths["timm"])
    sd = declip_state_dict(rng, vocab=49409, context=77)
    torch.save({"model": _scaled(sd)}, paths["declip"])
    rn = init_clip_params(torch.Generator().manual_seed(0), RN_TINY, device="cpu")
    torch.save(clip_to_state_dict(rn), paths["rn"])
    return {k: str(v) for k, v in paths.items()}


# (model YAML, checkpoint option, image size) per backbone
MODELS = {"mae": ("mae_vitb16", "TEST.MODEL_FILE", "timm", 32),
          "vit": ("vit_base_patch16_224", "TEST.MODEL_FILE", "timm", 32),
          "declip": ("vitb32_DeCLIP", "TEST.MODEL_FILE", "declip", 64),
          "rn": ("vitb32_CLIP", "MODEL.PRETRAINED", "rn", 32)}


@pytest.fixture
def fixed_heads(monkeypatch):
    """Both packages' ``init_head`` take one seeded (dim, K) kernel where
    they would draw a random head."""
    import pevit_tpu.train.trainer as jt
    import pevit_tpu_torch.train.trainer as pt

    def fixed(init):
        def head(gen, dim, k, *, text_init_weights=None, **kw):
            if text_init_weights is None:
                rng = np.random.default_rng(dim * 1000 + k)
                text_init_weights = rng.uniform(-1, 1, (dim, k)).astype(np.float32) / dim ** 0.5
            return init(gen, dim, k, text_init_weights=text_init_weights, **kw)
        return head

    monkeypatch.setattr(jt, "init_head", fixed(jt.init_head))
    monkeypatch.setattr(pt, "init_head", fixed(pt.init_head))


def _argv(out, checkpoints, model, *options, device=(), text_head=True):
    yaml, key, ckpt, res = MODELS[model]
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model" / f"{yaml}.yaml"), *options, *device,
            "DATASET.NUM_SAMPLES_PER_CLASS", "5", "DATASET.RANDOM_SEED_SAMPLING", "0",
            "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", str(text_head), key, checkpoints[ckpt],
            "DATASET.ALLOW_SYNTHETIC", "True", "DATASET.ROOT", str(out / "data"),
            "OUTPUT_DIR", str(out / "out"), "TRAIN.IMAGE_SIZE", f"[{res},{res}]",
            "TPU.PARITY_FP32", "True", "TRAIN.END_EPOCH", "1", "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", "1"]


class _Stop(Exception):
    pass


def _inputs(monkeypatch, tmp_path, checkpoints, model, jmod, pmod):
    seen = {}

    def spy(key):
        def run(task, data, config, **kw):
            seen[key] = (task, data, config)
            raise _Stop
        return run

    monkeypatch.setattr(pevit_tpu.train, "run_method", spy("jax"))
    monkeypatch.setattr(pevit_tpu_torch.train, "run_method", spy("port"))
    for key, mod, device in (("jax", jmod, ()), ("port", pmod, ("--device", "cpu"))):
        with pytest.raises(_Stop):
            mod.main(_argv(tmp_path / key, checkpoints, model, "--no-tuning", "True",
                           device=device))
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("model,command", [("mae", "linear_probe"), ("declip", "linear_probe"),
                                           ("rn", "linear_probe"), ("vit", "finetune")])
def test_commands_hand_run_method_the_same_inputs(monkeypatch, tmp_path, checkpoints, model,
                                                  command):
    monkeypatch.chdir(REPO)
    mods = {"linear_probe": (jlinear_probe, plinear_probe), "finetune": (jfinetune, pfinetune)}
    (jtask, jdata, jcfg), (ptask, pdata, pcfg) = _inputs(monkeypatch, tmp_path, checkpoints,
                                                         model, *mods[command])
    if model == "mae":  # the MAE probe's override (linear_probe.py:88-91)
        assert jcfg.MODEL.SPEC.GLOBAL_POOL is False and pcfg.MODEL.SPEC.GLOBAL_POOL is False
    assert (ptask.backbone is None) == (jtask.backbone is None) == (model == "rn")
    for field in ("num_classes", "batch_size", "use_bn", "normalize_feature", "apply_logit_scale",
                  "compute_dtype", "feat_dim", "head_dim", "emulate_zero_shot"):
        assert getattr(ptask.static, field) == getattr(jtask.static, field), field
    for got, want in zip(pdata, jdata):
        assert np.array_equal(got.numpy(), np.asarray(want))
    want_tree = np_tree(jtask.clip_params)
    got_tree = bridge.module_to_jax(ptask.clip)
    assert flat(got_tree).keys() == flat(want_tree).keys()
    for k, v in flat(want_tree).items():
        assert np.array_equal(flat(got_tree)[k], v), k
    jw, pw = jtask.text_init_weights, ptask.text_init_weights
    assert (pw is None) is (model in ("mae", "vit"))
    if model == "declip":
        # the reference's fault: its text head raised and fell back to random
        assert jw is None
        jw = _reference_text_features(jcfg, jtask.backbone)
    if pw is not None:
        assert pw.shape == np.asarray(jw).shape
        err = np.abs(pw - np.asarray(jw)).max()
        assert err <= TOL * np.abs(jw).max(), err


def _reference_text_features(config, backbone):
    """What ``pevit_tpu/commands/_common.py:358-372`` computes, on a
    writable copy of the text features."""
    from pevit_tpu.evaluation.text_features import build_prompts

    texts, offsets = build_prompts(config)
    toks = backbone.tokenize(texts, config.MODEL.SPEC.TEXT.CONTEXT_LENGTH)
    emb = np.array(jax.jit(backbone.encode_text)(backbone.params, toks), np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12
    cols = [m / (np.linalg.norm(m) + 1e-12) for m in (emb[s:e].mean(0) for s, e in offsets)]
    return np.stack(cols, axis=1)


def _artifacts(out, folder):
    base = out / "out" / "predictions" / folder / "seed0_cifar-10"
    txt = base.with_suffix(".txt")
    return (json.loads(base.with_suffix(".json").read_text()),
            txt.read_text() if txt.exists() else None)


@pytest.mark.parametrize("model,command", [("mae", "linear_probe"), ("declip", "linear_probe"),
                                           ("rn", "linear_probe"), ("vit", "finetune")])
def test_whole_command_matches_the_reference(monkeypatch, fixed_heads, tmp_path, checkpoints,
                                             model, command):
    monkeypatch.chdir(REPO)
    jmod, pmod = {"linear_probe": (jlinear_probe, plinear_probe),
                  "finetune": (jfinetune, pfinetune)}[command]
    options = ("--no-tuning", "True", "--lr", "0.01", "--l2", "0.001")
    text_head = model == "rn"
    with jax.default_matmul_precision("highest"):
        jacc, jinfo = jmod.main(_argv(tmp_path / "jax", checkpoints, model, *options,
                                      text_head=text_head))
    pacc, pinfo = pmod.main(_argv(tmp_path / "port", checkpoints, model, *options,
                                  device=("--device", "cpu"), text_head=text_head))
    assert pacc == jacc
    for key in ("n_trainable_params", "n_params", "n_visual_params", "n_backbone_params"):
        assert pinfo[key] == jinfo[key], key
    folder = ("linear_probe" if command == "linear_probe" else "finetuning") + "_5"
    (gj, gtxt), (wj, wtxt) = _artifacts(tmp_path / "port", folder), \
        _artifacts(tmp_path / "jax", folder)
    gp, wp = np.asarray(gj.pop("predictions")), np.asarray(wj.pop("predictions"))
    assert gp.shape == wp.shape == (1, 160, 10)
    assert np.abs(gp - wp).max() <= TOL
    assert gj == wj and gtxt == wtxt


def test_rn_zeroshot_matches_the_reference(monkeypatch, tmp_path, checkpoints):
    monkeypatch.chdir(REPO)
    argv = lambda out, *device: ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
                                 "--model", str(REPO / "resources/model/vitb32_CLIP.yaml"),
                                 *device, "MODEL.NAME", "RN50", "MODEL.PRETRAINED",
                                 checkpoints["rn"], "DATASET.ALLOW_SYNTHETIC", "True",
                                 "DATASET.ROOT", str(out / "data"), "OUTPUT_DIR", str(out / "out"),
                                 "TRAIN.IMAGE_SIZE", "[32,32]"]
    with jax.default_matmul_precision("highest"):
        jres = jzeroshot.main(argv(tmp_path / "jax"))
    pres = pzeroshot.main(argv(tmp_path / "port", "--device", "cpu"))
    assert np.isclose(pres, jres, rtol=0, atol=1e-9)
    pred = "predictions/zeroshot_eval_wiki_False_wnh_False_wnd_False_gpt3_False/seed0_cifar-10.json"
    got = json.loads((tmp_path / "port" / "out" / pred).read_text())
    want = json.loads((tmp_path / "jax" / "out" / pred).read_text())
    gp, wp = np.asarray(got.pop("predictions")), np.asarray(want.pop("predictions"))
    assert gp.shape == (1, 160, 10) and np.abs(gp - wp).max() <= TOL
    assert got == want


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_peft_method_on_an_auxiliary_backbone_raises(monkeypatch, tmp_path, checkpoints,
                                                       package):
    monkeypatch.chdir(REPO)
    mod, device = (jkadapt, ()) if package == "jax" else (pkadapt, ("--device", "cpu"))
    with pytest.raises(ValueError, match="requires a CLIP backbone"):
        mod.main(_argv(tmp_path, checkpoints, "mae", "--no-tuning", "True", device=device))


def test_export_tool_on_a_factory_backbone(tmp_path, checkpoints):
    """``tools.export_model`` on MAE from its checkpoint (linear probe): the
    artifact, loaded back, equals the in-process serving forward of the task
    the tool builds."""
    from pevit_tpu_torch.serve import exported_callable, load_exported, make_serving_fn
    from pevit_tpu_torch.serve_daemon import config_from
    from pevit_tpu_torch.serving_loader import build_task
    from pevit_tpu_torch.tools import export_model

    ds = str(REPO / "resources/datasets/cifar10.yaml")
    model = str(REPO / "resources/model/mae_vitb16.yaml")
    opts = ["TEST.MODEL_FILE", checkpoints["timm"], "TRAIN.IMAGE_SIZE", "[32,32]",
            "TPU.COMPUTE_DTYPE", "float32"]
    out = tmp_path / "mae.pt2"
    export_model.main(["--model", model, "--ds", ds, "--method", "linear_probe", "--out", str(out),
                       "--device", "cpu", *opts])
    ep = load_exported(out)
    assert not any(".text." in n for n in ep.state_dict)
    task, static, trainable, frozen, bn = build_task(config_from(ds, model, opts), "linear_probe",
                                                     0, torch.device("cpu"), backbones=True)
    serve = make_serving_fn(static, trainable, frozen, bn, task.preproc,
                            forward_fn=task._forward_fn, device="cpu")
    x = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got, want = exported_callable(ep, device="cpu")(x), serve(x)
    assert got.shape == (3, 10)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
