"""ELEVATER dataset registry: the 20-dataset benchmark surface.

A copy of ``pevit_tpu/data/registry.py`` (the port imports nothing of the
JAX package).

Mirrors the per-dataset metadata the reference spreads across
resources/datasets/*.yaml (name, class count, metric) plus the multilabel
set (kadaptation_clip.py:46).  Dataset keys are the reference's
``DATASET.DATASET`` values so existing YAMLs/scripts resolve identically.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    num_classes: int
    metric: str = "accuracy"
    multilabel: bool = False


ELEVATER_DATASETS = {
    d.name: d
    for d in [
        DatasetInfo("cifar-10", 10, "accuracy"),
        DatasetInfo("cifar-100", 100, "accuracy"),
        DatasetInfo("caltech-101", 102, "mean-per-class"),
        DatasetInfo("country211", 211, "accuracy"),
        DatasetInfo("dtd", 47, "accuracy"),
        DatasetInfo("eurosat_clip", 10, "accuracy"),
        DatasetInfo("fer-2013", 7, "accuracy"),
        DatasetInfo("fgvc-aircraft-2013b-variants102", 100, "mean-per-class"),
        DatasetInfo("oxford-flower-102", 102, "mean-per-class"),
        DatasetInfo("food-101", 101, "accuracy"),
        DatasetInfo("gtsrb", 43, "accuracy"),
        DatasetInfo("hateful-memes", 2, "roc_auc"),
        DatasetInfo("kitti-distance", 4, "accuracy"),
        DatasetInfo("mnist", 10, "accuracy"),
        DatasetInfo("oxford-iiit-pets", 37, "mean-per-class"),
        DatasetInfo("patch-camelyon", 2, "accuracy"),
        DatasetInfo("rendered-sst2", 2, "accuracy"),
        DatasetInfo("resisc45_clip", 45, "accuracy"),
        DatasetInfo("stanford-cars", 196, "accuracy"),
        DatasetInfo("voc-2007-classification", 20, "11point_mAP", multilabel=True),
    ]
}

MULTILABEL_DATASETS = {"voc-2007-classification", "chestx-ray8"}


def get_dataset_info(name: str) -> DatasetInfo:
    if name in ELEVATER_DATASETS:
        return ELEVATER_DATASETS[name]
    if name in MULTILABEL_DATASETS:
        return DatasetInfo(name, 0, "11point_mAP", multilabel=True)
    return DatasetInfo(name, 0)
