"""The port's data splits against pevit_tpu.data: ``build_splits`` gives
bit-identical images and labels

* for a ``synthetic-*`` name and for cifar-10 with DATASET.ALLOW_SYNTHETIC,
  at 1 (the command's tweak makes it 2), 5 and all shots, and across
  sampling seeds;
* for voc-2007 (multilabel: the greedy cover val split and multi-hot labels);
* through the ``.npz`` fast path, with an explicit val split too;

and the command's ``load_device_data`` puts the same arrays on the device as
the JAX command does, and raises for a split over TPU.MAX_DEVICE_DATA_GB.
"""

import numpy as np
import pytest
import torch

from pevit_tpu.commands import _common as jax_common
from pevit_tpu.config import get_default_config as jax_defaults
from pevit_tpu.data import sources as jsrc
from pevit_tpu_torch.commands import _common as port_common
from pevit_tpu_torch.config import get_default_config
from pevit_tpu_torch.data import sources as psrc


def _config(make, root, dataset, *, shots=5, seed=0, classes=0, synthetic=True, val_set=""):
    cfg = make()
    cfg.defrost()
    cfg.DATASET.DATASET = dataset
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NUM_CLASSES = classes
    cfg.DATASET.NUM_SAMPLES_PER_CLASS = shots
    cfg.DATASET.RANDOM_SEED_SAMPLING = seed
    cfg.DATASET.ALLOW_SYNTHETIC = synthetic
    cfg.DATASET.VAL_SET = val_set
    cfg.TRAIN.IMAGE_SIZE = [8, 8]
    cfg.freeze()
    return cfg


def _same_splits(tmp_path, dataset, **kw):
    """Both packages' splits, after each command's dataset tweaks."""
    cfgs = []
    for make, common, sub in ((jax_defaults, jax_common, "jax"),
                              (get_default_config, port_common, "port")):
        cfgs.append(_config(make, tmp_path / sub, dataset, **kw))
        common.apply_shared_dataset_tweaks(cfgs[-1], "finetuning")
    want, got = jsrc.build_splits(cfgs[0]), psrc.build_splits(cfgs[1])
    for g, w in zip(got, want):
        for a, b in ((g.images, w.images), (g.labels, w.labels)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("shots", [1, 5, -1])
@pytest.mark.parametrize("dataset,classes", [("synthetic-test", 6), ("cifar-10", 10)])
def test_synthetic_splits_are_identical(tmp_path, dataset, classes, shots, seed):
    train, val, test = _same_splits(tmp_path, dataset, shots=shots, seed=seed, classes=classes)
    if shots > 0:
        assert len(train) + len(val) == max(shots, 2) * classes
    assert len(test) == 16 * classes


@pytest.mark.parametrize("shots", [2, 5, -1])
def test_voc_multilabel_splits_are_identical(tmp_path, shots):
    train, val, _ = _same_splits(tmp_path, "voc-2007-classification", shots=shots, classes=20)
    assert train.labels.ndim == 2 and train.labels.shape[1] == 20 and len(val)


def test_real_name_without_data_raises(tmp_path):
    for make, mod in ((jax_defaults, jsrc), (get_default_config, psrc)):
        with pytest.raises(FileNotFoundError):
            mod.build_splits(_config(make, tmp_path, "cifar-10", synthetic=False))


@pytest.mark.parametrize("val_set", ["", "val"])
def test_npz_fast_path(tmp_path, val_set):
    rng = np.random.default_rng(4)
    splits = {split: (rng.integers(0, 256, (n, 8, 8, 3), np.uint8), np.arange(n) % 4)
              for split, n in (("train", 60), ("val", 12), ("test", 20))}
    for root in (tmp_path / "jax", tmp_path / "port"):
        root.mkdir()
        for split, (images, labels) in splits.items():
            np.savez(root / f"{split}.npz", images=images, labels=labels)
    train, val, test = _same_splits(tmp_path, "cifar-10", shots=5, synthetic=False,
                                    val_set=val_set, classes=4)
    assert len(test) == 20 and len(val) == (12 if val_set else 4)


def test_load_device_data_matches_the_jax_command(tmp_path):
    want = jax_common.load_device_data(_config(jax_defaults, tmp_path / "j", "voc-2007-classification",
                                               classes=20))
    got = port_common.load_device_data(_config(get_default_config, tmp_path / "p",
                                               "voc-2007-classification", classes=20), "cpu")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert isinstance(g, torch.Tensor) and str(g.dtype).endswith(str(w.dtype))
        np.testing.assert_array_equal(g.numpy(), w)


def test_load_device_data_raises_over_the_device_limit(tmp_path):
    cfg = _config(get_default_config, tmp_path, "cifar-10", classes=10)
    cfg.defrost()
    cfg.TPU.MAX_DEVICE_DATA_GB = 1e-6
    cfg.freeze()
    with pytest.raises(NotImplementedError, match="streaming"):
        port_common.load_device_data(cfg, "cpu")
