"""Path-based partition of the model bundle (counterpart of
``pevit_tpu/train/partition.py``).

The bundle is a nested dict, ``{"clip": CLIP, "peft": module or None,
"head": Head}``; anything that is not a dict is a leaf (a module or a
tensor), so the serving path splits and joins it at module granularity.
"""

from __future__ import annotations

from typing import Callable


def partition(tree: dict, pred: Callable[[tuple], bool], _path: tuple = ()):
    """Split ``tree`` into (matching, rest); unselected leaves become None."""
    match, rest = {}, {}
    for key, val in tree.items():
        path = _path + (key,)
        if isinstance(val, dict):
            match[key], rest[key] = partition(val, pred, path)
        elif pred(path):
            match[key], rest[key] = val, None
        else:
            match[key], rest[key] = None, val
    return match, rest


def combine(a: dict, b: dict) -> dict:
    """Merge two same-structure trees where one side of each leaf is None."""
    if a.keys() != b.keys():
        raise ValueError(f"trees differ: {sorted(a)} vs {sorted(b)}")
    out = {}
    for key in a:
        x, y = a[key], b[key]
        out[key] = combine(x, y) if isinstance(x, dict) else (y if x is None else x)
    return out
