"""Carry a bundle, its BN state and an optimiser state between the JAX
reference's layout and the port.

The reference keeps its parameters as nested dicts of arrays, with every
linear kernel ``(in, out)`` and each tower's blocks stacked on a leading
layer axis.  The port keeps the same ``(in, out)`` kernels (so ``in_proj``'s
packed ``[q | k | v]`` columns and the head-major ``(H, hd)`` split carry
over unchanged) with one module per layer; parameter names match the
reference's paths, so the mapping only unstacks and restacks the layer axis:

  clip.visual.blocks.<path>[i]  <->  clip.visual.blocks.<i>.<path>
  peft.layers.<name>[i]         <->  peft.layers.<i>.<name>

The optimiser state (``SgdState``, ``AdamState``, ``RmspropState``) maps the
same way: the reference's state holds trees shaped like its trainable tree
(None at frozen leaves), the port's holds ``{dotted name: tensor}`` dicts
keyed like the bundle's parameters, so a test can start both stacks mid-run
from one state.

Only numpy crosses the boundary; this module imports neither JAX nor the
reference package.  The reference's text tower is not ported, so
``from_jax`` leaves it out and ``to_jax`` does not produce it.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.clip import CLIP, CLIPSpec
from .peft.base import PeftConfig, require_ported
from .peft.kadaptation import KAdaptation
from .train.head import Head
from .train.optim import AdamState, RmspropState, SgdState
from .utils.device import resolve_device

_STACKED = {"clip": ("visual", "blocks"), "peft": ("layers",)}


_OPT_STATES = {cls.__name__: cls for cls in (SgdState, AdamState, RmspropState)}


def _flatten(tree, prefix: tuple = ()) -> dict:
    """Leaves of a nested dict by path; None leaves (frozen) are left out."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, prefix + (key,)))
        elif val is not None:
            out[prefix + (key,)] = val
    return out


def _to_state_dict(flat: dict, stacked: tuple) -> dict:
    sd = {}
    k = len(stacked)
    for path, arr in flat.items():
        arr = np.asarray(arr)
        if stacked and path[:k] == stacked:
            for i in range(arr.shape[0]):
                sd[".".join(stacked + (str(i),) + path[k:])] = torch.from_numpy(np.array(arr[i]))
        else:
            sd[".".join(path)] = torch.from_numpy(np.array(arr))
    return sd


def _from_state_dict(sd: dict, stacked: tuple) -> dict:
    k = len(stacked)
    tree: dict = {}
    layers: dict = {}
    for name, t in sd.items():
        path = tuple(name.split("."))
        arr = t.detach().cpu().numpy()
        if stacked and path[:k] == stacked:
            layers.setdefault(path[k + 1:], {})[int(path[k])] = arr
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for sub, per_layer in layers.items():
        node = tree
        for key in stacked + sub[:-1]:
            node = node.setdefault(key, {})
        node[sub[-1]] = np.stack([per_layer[i] for i in range(len(per_layer))])
    return tree


def _load(module: torch.nn.Module, sd: dict, what: str) -> None:
    want = set(module.state_dict())
    if want != set(sd):
        raise ValueError(f"{what}: parameters differ; missing {sorted(want - set(sd))}, "
                         f"unexpected {sorted(set(sd) - want)}")
    module.load_state_dict(sd)


def from_jax(bundle_np: dict, bn_state_np: dict, spec: CLIPSpec, peft_cfg: PeftConfig, *,
             device=None):
    """Reference bundle ``{"clip", "peft", "head"}`` and BN state ``{"mean",
    "var"}`` as numpy -> (the port's bundle of modules, BN state tensors) on
    ``device``."""
    dev = resolve_device(device)
    clip_np = {"visual": bundle_np["clip"]["visual"],
               "logit_scale": bundle_np["clip"]["logit_scale"]}
    clip = CLIP(spec)
    _load(clip, _to_state_dict(_flatten(clip_np), _STACKED["clip"]), "clip")

    peft = None
    if peft_cfg.has_peft_params:
        require_ported(peft_cfg)
        peft = KAdaptation(spec.vision.layers, spec.vision.width)
        _load(peft, _to_state_dict(_flatten(bundle_np["peft"]), _STACKED["peft"]), "peft")

    kernel = np.asarray(bundle_np["head"]["linear"]["kernel"])
    head = Head(*kernel.shape)
    _load(head, _to_state_dict(_flatten(bundle_np["head"]), ()), "head")

    bundle = {"clip": clip.to(dev), "peft": None if peft is None else peft.to(dev),
              "head": head.to(dev)}
    bn = {k: torch.from_numpy(np.array(bn_state_np[k], np.float32)).to(dev)
          for k in ("mean", "var")}
    return bundle, bn


def to_jax(bundle: dict, bn_state: dict):
    """The port's bundle and BN state -> the reference's layout as numpy
    (``clip`` holds ``visual`` and ``logit_scale``)."""
    out = {"clip": _from_state_dict(bundle["clip"].state_dict(), _STACKED["clip"]),
           "peft": None if bundle.get("peft") is None
           else _from_state_dict(bundle["peft"].state_dict(), _STACKED["peft"]),
           "head": _from_state_dict(bundle["head"].state_dict(), ())}
    bn = {k: v.detach().cpu().numpy() for k, v in bn_state.items()}
    return out, bn


def _tree_to_port(tree: dict, dev) -> dict:
    """A reference tree over the bundle (``{"clip", "peft", "head"}``, None
    at frozen leaves) -> ``{dotted name: tensor}``, layers unstacked."""
    out = {}
    for top, sub in tree.items():
        if isinstance(sub, dict):
            sd = _to_state_dict(_flatten(sub), _STACKED.get(top, ()))
            out.update({f"{top}.{name}": t.to(dev) for name, t in sd.items()})
    return out


def _tree_to_jax(named: dict) -> dict:
    """``{dotted name: tensor}`` -> the reference's nested numpy tree over
    the bundle, layers restacked (frozen leaves absent)."""
    by_top: dict = {}
    for name, t in named.items():
        top, rest = name.split(".", 1)
        by_top.setdefault(top, {})[rest] = t
    return {top: _from_state_dict(sd, _STACKED.get(top, ())) for top, sd in by_top.items()}


def opt_state_from_jax(state_np, *, device=None):
    """The reference's optimiser state as numpy (its ``SgdState``,
    ``AdamState`` or ``RmspropState``, or any named tuple of those names and
    fields) -> the port's, on ``device``."""
    dev = resolve_device(device)
    cls = _OPT_STATES[type(state_np).__name__]
    fields = state_np._asdict()
    return cls(**{k: int(np.asarray(v)) if k == "step" else _tree_to_port(v, dev)
                  for k, v in fields.items()})


def opt_state_to_jax(state):
    """The port's optimiser state -> the same named tuple with the
    reference's numpy trees (``step`` as an int32 array)."""
    return type(state)(**{k: np.asarray(v, np.int32) if k == "step" else _tree_to_jax(v)
                          for k, v in state._asdict().items()})
