"""The port's copy of the config tree against pevit_tpu.config: the same
defaults, the same YAML merge, and no PyYAML import until a YAML file is
read."""

import subprocess
import sys
from pathlib import Path

import pytest

from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu_torch.config import get_default_config

REPO = Path(__file__).resolve().parents[1]


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_plain(v) for v in node)
    return node


def test_default_tree_matches():
    assert _plain(get_default_config()) == _plain(jax_defaults())


def test_yaml_merge_matches(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("TRAIN:\n  LR: 0.5\n  SCHEDULE: [3, 6]\n")
    cfg_file = tmp_path / "task.yaml"
    cfg_file.write_text("BASE: ['base.yaml']\nDATASET:\n  NUM_CLASSES: 7\n  EXTRA_KEY: 1\n"
                        "TPU:\n  PARITY_FP32: true\nTRAIN:\n  BATCH_SIZE_PER_GPU: 16\n")
    trees = []
    for make in (get_default_config, jax_defaults):
        cfg = make()
        cfg.merge_from_file(str(cfg_file))
        cfg.merge_from_list(["TRAIN.WD", "0.01", "TEST.METRIC", "accuracy"])
        cfg.freeze()
        trees.append(_plain(cfg))
    assert trees[0] == trees[1]
    assert trees[0]["TRAIN"]["LR"] == 0.5 and trees[0]["DATASET"]["EXTRA_KEY"] == 1


def test_unknown_key_and_frozen_write_raise():
    cfg = get_default_config()
    with pytest.raises(KeyError):
        cfg.merge_from_list(["TRAIN.NOT_A_KEY", "1"])
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.TRAIN.LR = 1.0


def test_config_import_does_not_import_yaml():
    code = ("import sys\nimport pevit_tpu_torch.config as c\nc.get_default_config().clone()\n"
            "print('yaml' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "False"
