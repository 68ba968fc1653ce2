"""The port's YAML reader and writer (``config/yaml_subset.py``) and the
command's config, against PyYAML and the JAX package:

* the reader equals ``yaml.safe_load`` on every YAML file under resources/
  and on a set of scalar forms PyYAML resolves specially, and raises on the
  constructs it does not cover;
* ``CfgNode.dump()`` reads back through ``yaml.safe_load`` (and the port's
  reader) to the same tree;
* after ``setup_config`` + ``apply_shared_dataset_tweaks``, the port's config
  and experiment name equal the JAX package's for every dataset YAML with
  ``vitb32_CLIP.yaml`` and the overrides of ``scripts/kadapter_clip.sh``, at
  5, 1 and all shots.
"""

import argparse
import math
from pathlib import Path

import pytest
import yaml

from pevit_tpu.commands import _common as jax_common
from pevit_tpu.config.cfg_node import _to_plain as jax_plain
from pevit_tpu_torch.commands import _common as port_common
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.config.cfg_node import _to_plain
from pevit_tpu_torch.config.yaml_subset import dump, load

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(REPO)) for p in (REPO / "resources").rglob("*.yaml"))
DATASETS = sorted(p.name for p in (REPO / "resources" / "datasets").glob("*.yaml"))


def test_there_are_35_yaml_files():
    assert len(YAMLS) == 35 and len(DATASETS) == 20


@pytest.mark.parametrize("path", YAMLS)
def test_reader_equals_safe_load(path):
    text = (REPO / path).read_text()
    assert load(text) == yaml.safe_load(text)


SCALARS = ["1e-5", "1.0e-05", "0.", "4.", "-0", "+3", "1_000", "0o17", "1.5e3", "true", "False",
           "TRUE", "~", "null", "", "''", "'it''s'", '"a \\"b\\" \\\\c"', "http://x.y/z", "a b",
           "b # c", "[1, [2, 'x'], b c]", "[]", "{}", "[x, y,]", "'a: b'", "'on'"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_forms_equal_safe_load(text):
    got, want = load(f"k: {text}"), yaml.safe_load(f"k: {text}")
    assert got == want and type(got["k"]) is type(want["k"])


@pytest.mark.parametrize("text", [
    "- a\n- b", "k: &x 1", "k: *x", "k: !!str 1", "k: |\n  x", "k: {a: 1}", "k: [1,\n  2]",
    "k: [a: 1]", "a:\n\tb: 1", "k: a: b", "---\nk: 1", "x", "[1, 2]",
    # plain scalars PyYAML resolves to something else than this reader would
    "k: on", "k: Off", "k: No", "k: yes", "k: 012", "k: 0x1F", "k: 0b11", "k: .inf", "k: -.Inf",
    "k: .nan", "k: .5", "k: 1:30", "k: 2001-01-01", 'k: "tab\\there"'])
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        load(text)


def test_dump_reads_back_to_the_same_tree():
    cfg = get_default_config()
    cfg.defrost()
    cfg.merge_from_file(str(REPO / "resources/model/vitb32_DeCLIP.yaml"))
    cfg.OUTPUT_DIR = "it's a path: with # and 'quotes'"
    cfg.TRAIN.LR = 1e-5
    cfg.TRAIN.SCHEDULE = [3, 7]
    cfg.TRAIN.OPTIMIZER_ARGS.momentum = -1.5e300
    cfg.MODEL.STATS.on = None
    text = cfg.dump()
    want = _to_plain(cfg)
    assert yaml.safe_load(text) == want and load(text) == want
    assert yaml.safe_load(text)["TRAIN"]["LR"] == 1e-5  # not the string '1e-05'


def test_dump_of_scalars_and_empty_nodes():
    tree = {"A": {"B": [1, 2.5, 1e-300, "x y", "ünï", "q\"\\", (0.1, True, None)],
                  "E": {}, "on": "off", "1": "2", "null": None}, "Z": [], "Y": ""}
    plain = {"A": {**tree["A"], "B": tree["A"]["B"][:-1] + [[0.1, True, None]]}, "Z": [], "Y": ""}
    assert yaml.safe_load(dump(tree)) == plain and load(dump(tree)) == plain
    assert dump({}) == "{}\n" and load(dump({})) == {}


@pytest.mark.parametrize("value", [float("inf"), float("nan"), "tab\there", "line\n", {"x": [{}]}])
def test_dump_raises_outside_its_subset(value):
    with pytest.raises(ValueError):
        dump({"k": value if not isinstance(value, dict) else [value]})


def _script_argv(dataset: str, shots: int) -> list:
    """The argument list of scripts/kadapter_clip.sh for one dataset."""
    return [
        "--ds", f"resources/datasets/{dataset}", "--model", "resources/model/vitb32_CLIP.yaml",
        "--no-tuning", "False", "--lr", "0.0", "--l2", "0.0",
        "MODEL.CLIP_FP32", "False", "DATASET.NUM_SAMPLES_PER_CLASS", str(shots),
        "DATASET.ROOT", "../DATASET/datasets", "OUTPUT_DIR", "../OUTPUT/0/vitb32_CLIP/log",
        "DATASET.RANDOM_SEED_SAMPLING", "0", "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", "True",
        "TRAIN.MERGE_ENCODER_AND_HEAD_PROJ", "False", "KNOWLEDGE.WORDNET.USE_HIERARCHY", "False",
        "KNOWLEDGE.WORDNET.USE_DEFINITION", "False", "KNOWLEDGE.WIKITIONARY.USE_DEFINITION", "False",
        "KNOWLEDGE.GPT3.USE_GPT3", "False", "KNOWLEDGE.AGGREGATION.NUM_GPT3_ITEMS", "0",
        "TEST.MODEL_FILE", "",
    ]


@pytest.mark.parametrize("shots", [5, 1, -1])
@pytest.mark.parametrize("dataset", DATASETS)
def test_command_config_equals_jax(dataset, shots, monkeypatch):
    monkeypatch.chdir(REPO)
    argv = _script_argv(dataset, shots)
    out = {}
    for name, common in (("jax", jax_common), ("port", port_common)):
        args = common.add_common_args(argparse.ArgumentParser()).parse_args(argv)
        config = common.setup_config(args)
        exp = common.apply_shared_dataset_tweaks(config, "finetuning")
        out[name] = (exp, yaml.safe_load(config.dump()), config)
    assert out["port"][0] == out["jax"][0]
    assert _to_plain(out["port"][2]) == jax_plain(out["jax"][2])
    assert out["port"][1] == out["jax"][1]  # the two dumps read back to one tree
