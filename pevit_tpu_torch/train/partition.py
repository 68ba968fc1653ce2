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

:func:`stack_trials` gives a batch of trials its stacked storage: one bundle
whose per-trial modules hold each parameter stacked over a leading trial
axis, with every trial's own module made a view into its slice.  A frozen
tower is shared by every trial; a trained one (``full_finetune``) is
stacked like the rest, each trial starting from an :func:`alias` of the
pretrained tower, so the stack is the only copy of it.
"""

from __future__ import annotations

import copy
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


def _set_parameter(module: nn.Module, name: str, param: nn.Parameter) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf, param)


def alias(module: nn.Module, keep=()) -> nn.Module:
    """A module of ``module``'s structure whose parameters are new
    parameters over the same storage (nothing is copied) and whose buffers
    are the same tensors: a trial's own tower, which :func:`partition` can
    flag and :func:`stack_trials` can re-point, leaving ``module`` as it is.
    The submodules and parameters in ``keep`` (a frozen text tower every
    trial shares) stay the same objects."""
    memo = {id(p): nn.Parameter(p.detach(), requires_grad=p.requires_grad)
            for p in module.parameters()}
    memo.update({id(b): b for b in module.buffers()})
    memo.update({id(k): k for k in keep})
    return copy.deepcopy(module, memo)


def stack_trials(bundles: list) -> dict:
    """One bundle for the trials of ``bundles`` (one bundle each, of one
    structure, partitioned).  The ``clip`` entry is the first bundle's
    where none of its parameters trains (every trial holds the same frozen
    tower).  Every other module, and a ``clip`` that trains, becomes an
    :func:`alias` of the first trial's whose parameters are the trials'
    stacked, (T, ...), with the first trial's ``requires_grad``; of a
    ``clip`` only the trained parameters are stacked, and its frozen ones
    (a text tower, a logit scale) stay the first trial's.  Each trial's own
    module is made a view into the stack: its parameters become parameters
    over slice t of the stack's storage, so an in-place update of the stack
    is every trial's, and the trial's modules and trees go on reading their
    own trial.  A stacked module must be each trial's own object."""
    out = {}
    for key, first in bundles[0].items():
        names = [] if first is None else [
            n for n, p in first.named_parameters() if key != "clip" or p.requires_grad]
        if not names:
            out[key] = first
            continue
        modules = [b[key] for b in bundles]
        if len({id(m) for m in modules}) != len(modules):
            raise ValueError(f"the trials share one {key!r} module; give each its own "
                             "(partition.alias)")
        stacked = alias(first)
        for name in names:
            flag = first.get_parameter(name).requires_grad
            data = torch.stack([m.get_parameter(name).detach() for m in modules])
            big = nn.Parameter(data, requires_grad=flag)
            _set_parameter(stacked, name, big)
            for t, m in enumerate(modules):
                _set_parameter(m, name, nn.Parameter(big.detach()[t], requires_grad=flag))
        out[key] = stacked
    return out
