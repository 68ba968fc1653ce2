"""Dataset class names and CLIP prompt templates.

A copy of ``pevit_tpu/data/prompts.py`` (the port imports nothing of the
JAX package); it reads the same ``resources/metadata`` files.

Replaces the reference's 3.3K-line ``datasets/prompts.py`` module with JSON
resources (resources/metadata/*.json, generated by
tools/import_class_metadata.py from the public benchmark metadata).  Exposes
the same ``class_map`` / ``template_map`` lookup surface
(reference: datasets/prompts.py:3221-3275).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

_META_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "resources",
    "metadata",
)

DEFAULT_TEMPLATES = ["a photo of a {}"]  # feature.py:473 fallback


@lru_cache()
def _load(name: str) -> dict:
    path = os.path.join(_META_DIR, name)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def get_class_names(dataset: str):
    """Class-name list (or None when the dataset isn't in the metadata)."""
    return _load("class_names.json").get(dataset)


def get_templates(dataset: str):
    """Prompt-template list; defaults to ['a photo of a {}'] like the
    reference (feature.py:473)."""
    return _load("prompt_templates.json").get(dataset, DEFAULT_TEMPLATES)


class _LazyMap:
    def __init__(self, getter):
        self._getter = getter

    def get(self, key, default=None):
        v = self._getter(key)
        return default if v is None else v

    def __getitem__(self, key):
        v = self._getter(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self._getter(key) is not None


class_map = _LazyMap(get_class_names)
template_map = _LazyMap(lambda d: _load("prompt_templates.json").get(d))
