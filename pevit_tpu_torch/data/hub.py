"""The ELEVATER dataset-hub surface, local data only.

Counterpart of ``pevit_tpu/data/hub.py`` (reference common/constants.py:1-11,
the storage URL and the DatasetHub factory, and the vision_datasets
manifest flow of feature.py:551-598).  The hub resolves splits stored
locally (the layouts ``sources.py`` reads) and fetches nothing: a split
that is not there gives None, or raises where downloading was asked for.
The storage URL is kept as the reference names it.
"""

from __future__ import annotations

import logging
from pathlib import Path

VISION_DATASET_STORAGE = "https://cvinthewildeus.blob.core.windows.net/datasets"


class DatasetHub:
    """A vision-datasets-hub compatible facade over local storage."""

    def __init__(self, root: str = "", allow_download: bool = False):
        self.root = Path(root) if root else None
        self.allow_download = allow_download

    def list_data_version_and_types(self) -> list:
        from .registry import ELEVATER_DATASETS

        return [{"name": name, "version": 1, "type": "classification_multiclass"}
                for name in ELEVATER_DATASETS]

    def create_dataset_manifest(self, storage_url: str, local_dir: str, name: str,
                                usage: str = "test"):
        """A local split as ``(dataset, info, None)`` (hub.create_dataset_manifest,
        feature.py:560,581,586), or None where it is not stored."""
        from .sources import load_split

        split = {"train_purpose": "train", "val_purpose": "val", "test_purpose": "test"}.get(
            str(usage).lower(), str(usage).lower())
        try:
            ds = load_split(name, local_dir or (str(self.root) if self.root else ""), split,
                            allow_synthetic=False)
            return ds, {"name": name, "type": "classification_multiclass"}, None
        except FileNotFoundError as e:
            if self.allow_download:
                raise NotImplementedError(
                    f"downloading from {storage_url} is not supported; store the split "
                    "locally") from e
            logging.warning("dataset %s split %s not available locally: %s", name, split, e)
            return None


def get_dataset_hub(root: str = "") -> DatasetHub:
    return DatasetHub(root)
