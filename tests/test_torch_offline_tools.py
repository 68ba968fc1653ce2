"""The port's offline tools: ``pevit_tpu_torch.tools.validate_checkpoints``
and ``pevit_tpu_torch.tools.parity_eval``.

* The checkpoint auditor runs the port's mappers on seeded state dicts of
  every family (an OpenAI-layout CLIP ViT and RN, a DeCLIP-family FILIP
  checkpoint with its pretraining-only subtrees, a timm ViT, a Swin and a
  CLIP-Swin), with ``--family auto`` (the timm ViT named: a timm
  checkpoint's ``patch_embed.proj.weight`` sniffs as Swin, in the
  reference tool too): exit 0 and no unexpected key; its
  report classifies every key as the reference tool's does on the same
  file (``tools/validate_checkpoints.py``); an unexpected key exits 1 and
  is named, a missing key is a mapper failure and exits 2 (as
  ``tests/test_validate_checkpoints.py``).
* The parity harness resolves every method to a port command, and its
  ``--smoke`` grid runs one method through the port's command on the CPU
  (synthetic data, random weights, a tiny tower) and writes its report.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pevit_tpu_torch.tools import parity_eval as pe
from pevit_tpu_torch.tools import validate_checkpoints as vc

REPO = Path(__file__).resolve().parents[1]


def _reference_tool():
    spec = importlib.util.spec_from_file_location("ref_validate_checkpoints",
                                                  REPO / "tools" / "validate_checkpoints.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clip_vit_sd():
    from .test_torch_zeroshot import TINY

    from pevit_tpu_torch.ckpt import clip_to_state_dict
    from pevit_tpu_torch.core.clip import init_clip_params

    clip = init_clip_params(torch.Generator().manual_seed(0), TINY, device="cpu")
    return {k: v.numpy() for k, v in clip_to_state_dict(clip).items()}


def _clip_rn_sd():
    from .test_torch_resnet import spec_pair

    from pevit_tpu_torch.ckpt import clip_to_state_dict
    from pevit_tpu_torch.core.clip import init_clip_params

    _, spec = spec_pair("64px")
    clip = init_clip_params(torch.Generator().manual_seed(2), spec, device="cpu")
    return {k: v.numpy() for k, v in clip_to_state_dict(clip).items()}


def _declip_sd():
    from .test_torch_declip import declip_state_dict

    return declip_state_dict(np.random.default_rng(0), dense=True)


def _timm_sd():
    from .test_torch_vit import timm_state_dict

    return timm_state_dict(np.random.default_rng(1), classes=5)


def _swin_sd():
    from .test_swin_ckpt import synthetic_official_sd

    return synthetic_official_sd()


def _clip_swin_sd():
    from .test_torch_swin import clip_swin_state_dict

    return clip_swin_state_dict()


FAMILIES = {"clip": _clip_vit_sd, "clip-rn": _clip_rn_sd, "declip": _declip_sd,
            "timm_vit": _timm_sd, "swin": _swin_sd, "clip_swin": _clip_swin_sd}


def _save(sd: dict, path: Path) -> str:
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


def _report(capsys, argv, main=vc.main):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_every_family_audits_clean_with_the_references_classification(case, tmp_path, capsys):
    path = _save(FAMILIES[case](), tmp_path / f"{case}.pt")
    argv = ["--ckpt", path] + (["--family", case] if case == "timm_vit" else [])
    rc, rep = _report(capsys, argv)
    assert rep["family"] == case.split("-")[0]
    assert rep["mapper"] == "ok" and rep["n_param_leaves"] > 0
    assert rep["n_unexpected"] == 0, rep["unexpected"]
    assert rep["n_mapped"] > 0 and rc == 0
    if case == "declip":  # the pretraining-only subtrees are ignored, not mapped
        assert rep["n_ignored"] > 0
    # the reference tool, on the same file, classifies every key alike
    ref_rc, ref = _report(capsys, argv, _reference_tool().main)
    for key in ("family", "n_keys", "n_mapped", "n_ignored", "n_unexpected", "unexpected",
                "ignored", "mapper"):
        assert rep[key] == ref[key], key
    assert ref_rc == rc


def test_unexpected_keys_are_flagged(tmp_path, capsys):
    sd = _clip_vit_sd()
    sd["totally.unknown.weight"] = np.zeros((3, 3), np.float32)
    np.savez(tmp_path / "clip.npz", **sd)
    rc, rep = _report(capsys, ["--ckpt", str(tmp_path / "clip.npz")])
    assert rep["n_unexpected"] == 1 and rep["unexpected"] == ["totally.unknown.weight"]
    assert rc == 1


@pytest.mark.parametrize("case,key", [("clip", "visual.ln_post.weight"),
                                      ("timm_vit", "blocks.1.mlp.fc2.weight")])
def test_a_missing_key_is_a_mapper_failure(case, key, tmp_path, capsys):
    sd = FAMILIES[case]()
    del sd[key]
    np.savez(tmp_path / "ckpt.npz", **sd)
    rc, rep = _report(capsys, ["--ckpt", str(tmp_path / "ckpt.npz"), "--family", case])
    assert rep["mapper"].startswith("FAILED")
    assert rc == 2


def test_parity_harness_resolves_every_method_to_a_port_command():
    assert len(pe.ALL_DATASETS) == 20
    for ds in pe.ALL_DATASETS:
        assert (REPO / "resources" / "datasets" / f"{ds}.yaml").exists(), ds
    for name, (modpath, avg, params) in pe.METHODS.items():
        assert modpath.startswith("pevit_tpu_torch.commands.")
        assert callable(importlib.import_module(modpath).main), name
        assert (avg is None and params == 0) if name == "zeroshot" else (50 < avg < 80 and params)
    # the device option precedes the KEY VALUE overrides, which take the rest
    ns = type("A", (), dict(model="vitb32_CLIP", no_tuning="True", lr=0.01, l2=1e-4,
                            device="cpu", shots=5, output_dir="out", data_root="", weights="",
                            smoke=True))()
    argv = pe.command_argv("lora", "cifar10", 0, ns)
    assert argv.index("--device") < argv.index("DATASET.NUM_SAMPLES_PER_CLASS")
    assert pe.model_yaml("vitb32_CLIP") == REPO / "resources/model/vitb32_CLIP.yaml"


def test_parity_smoke_runs_a_port_command(tmp_path):
    from .test_torch_serving_tools import _tiny_model

    report = tmp_path / "report.json"
    rep = pe.main(["--smoke", "--methods", "linear_probe", "--datasets", "cifar10", "--seeds", "0",
                   "--model", _tiny_model(tmp_path), "--output-dir", str(tmp_path / "out"),
                   "--report", str(report)])
    arm = rep["methods"]["linear_probe"]
    assert arm["published_average_top1"] == 66.32
    assert 0.0 <= arm["per_dataset"]["cifar10"]["per_seed"][0] <= 100.0
    assert json.loads(report.read_text())["config"]["smoke"] is True
    assert list((tmp_path / "out" / "linear_probe").rglob("*.json"))  # the command's artifacts
