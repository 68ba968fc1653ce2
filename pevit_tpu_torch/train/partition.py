"""Leaf-level partition of the model bundle (counterpart of
``pevit_tpu/train/partition.py``).

The bundle is a nested dict, ``{"clip": CLIP, "peft": module or None,
"head": Head}``.  A parameter's path is its bundle key followed by its dotted
name inside the module, e.g. ``("head", "logit_scale")`` or ``("peft",
"layers", "0", "q_left")``, so a predicate decides per parameter, as the
reference's does per pytree leaf.  :func:`partition` records the decision in
each parameter's ``requires_grad`` and splits the tree at module granularity:
a module with trainable and frozen parameters (a head whose logit scale is
frozen) sits on both sides.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def _leaves(val, path: tuple) -> dict:
    if isinstance(val, nn.Module):
        return {path + tuple(n.split(".")): p for n, p in val.named_parameters()}
    if isinstance(val, torch.Tensor):
        return {path: val}
    return {}


def named_parameters(tree: dict, _path: tuple = ()) -> dict:
    """``{"dotted.path": tensor}`` for every parameter in the tree, in
    module order."""
    out = {}
    for key, val in tree.items():
        path = _path + (key,)
        if isinstance(val, dict):
            out.update(named_parameters(val, path))
        else:
            out.update({".".join(p): t for p, t in _leaves(val, path).items()})
    return out


def partition(tree: dict, pred: Callable[[tuple], bool], _path: tuple = ()):
    """Split ``tree`` into (matching, rest), deciding per parameter path.

    Each parameter's ``requires_grad`` is set to ``pred(path)``; a module is
    on the matching side if any of its parameters match and on the rest side
    if any do not.  Leaves on neither side are None."""
    match, rest = {}, {}
    for key, val in tree.items():
        path = _path + (key,)
        if isinstance(val, dict):
            match[key], rest[key] = partition(val, pred, path)
            continue
        flags = []
        for p_path, p in _leaves(val, path).items():
            flags.append(bool(pred(p_path)))
            p.requires_grad_(flags[-1])
        match[key] = val if any(flags) else None
        rest[key] = val if (val is not None and not all(flags)) else None
    return match, rest


def combine(a: dict, b: dict) -> dict:
    """Merge two same-structure trees, taking ``a``'s leaf where it is not
    None (a module on both sides is the same object)."""
    if a.keys() != b.keys():
        raise ValueError(f"trees differ: {sorted(a)} vs {sorted(b)}")
    out = {}
    for key in a:
        x, y = a[key], b[key]
        out[key] = combine(x, y) if isinstance(x, dict) else (y if x is None else x)
    return out


def count_params(tree) -> int:
    """Number of parameter elements in a bundle tree, a module, or a
    ``{name: tensor}`` dict (0 for None)."""
    if tree is None:
        return 0
    if isinstance(tree, nn.Module):
        tree = {"": tree}
    return int(sum(t.numel() for t in named_parameters(tree).values()))
