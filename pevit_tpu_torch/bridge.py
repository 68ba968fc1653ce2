"""Carry a bundle, its BN state and an optimiser state between the JAX
reference's layout and the port.

The reference keeps its parameters as nested dicts of arrays, with every
linear kernel ``(in, out)`` and each tower's blocks stacked on a leading
layer axis.  The port keeps the same ``(in, out)`` kernels (so ``in_proj``'s
packed ``[q | k | v]`` columns and the head-major ``(H, hd)`` split carry
over unchanged) with one module per layer; parameter names match the
reference's paths, so the mapping only unstacks and restacks the layer axis:

  clip.visual.blocks.<path>[i]  <->  clip.visual.blocks.<i>.<path>
  clip.text.blocks.<path>[i]    <->  clip.text.blocks.<i>.<path>
  peft.layers.<name>[i]         <->  peft.layers.<i>.<name>

A serving weight bundle (``serve.serving_weights``: ``{"bundle", "bn_state"}``)
maps the same way, int8 leaves included: the reference's stacked
``{"_q8": (L, ...), "scale": (L, 1, out)}`` is one ``{"_q8", "scale"}`` a
layer in the port, its scale ``(1, out)``, or the shared ``(out,)`` row of a
stacked ``(L, out)`` leaf, which the reference scales over its layer axis.

The optimiser state (``SgdState``, ``AdamState``, ``RmspropState``) maps the
same way: the reference's state holds trees shaped like its trainable tree
(None at frozen leaves), the port's holds ``{dotted name: tensor}`` dicts
keyed like the bundle's parameters, so a test can start both stacks mid-run
from one state.

Only numpy crosses the boundary; this module imports neither JAX nor the
reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.clip import CLIP, CLIPSpec
from .peft.base import MODULE_CLASSES, PeftConfig
from .train.head import Head
from .train.optim import AdamState, RmspropState, SgdState
from .utils.device import resolve_device

# the prefixes under which the reference stacks layers on a leading axis
_STACKED = {"clip": (("visual", "blocks"), ("text", "blocks")), "peft": (("layers",),)}


def _stacked_prefix(path: tuple, prefixes: tuple):
    """The stacked prefix that ``path`` lies under, or None."""
    for stacked in prefixes:
        if path[:len(stacked)] == stacked:
            return stacked
    return None


def stacked_layer_axes(name: str) -> int:
    """Layer axes the reference stacks onto the leaf behind the port's
    dotted parameter ``name``: 1 for ``clip.visual.blocks.<i>.*``,
    ``clip.text.blocks.<i>.*`` and ``peft.layers.<i>.*`` (one layer's slice
    of a stacked leaf), else 0."""
    top, _, rest = name.partition(".")
    path = tuple(rest.split("."))
    stacked = _stacked_prefix(path, _STACKED.get(top, ()))
    k = len(stacked or ())
    return int(stacked is not None and len(path) > k + 1 and path[k].isdigit())


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


def _to_state_dict(flat: dict, prefixes: tuple) -> dict:
    sd = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        stacked = _stacked_prefix(path, prefixes)
        if stacked is not None:
            k = len(stacked)
            for i in range(arr.shape[0]):
                sd[".".join(stacked + (str(i),) + path[k:])] = torch.from_numpy(np.array(arr[i]))
        else:
            sd[".".join(path)] = torch.from_numpy(np.array(arr))
    return sd


def _from_state_dict(sd: dict, prefixes: tuple) -> dict:
    tree: dict = {}
    layers: dict = {}
    for name, t in sd.items():
        path = tuple(name.split("."))
        arr = t.detach().cpu().numpy()
        stacked = _stacked_prefix(path, prefixes)
        if stacked is not None:
            k = len(stacked)
            layers.setdefault((stacked, path[k + 1:]), {})[int(path[k])] = arr
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for (stacked, sub), per_layer in layers.items():
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


def clip_from_jax(clip_np: dict, spec: CLIPSpec, *, device=None) -> CLIP:
    """The reference's CLIP tree (``visual``, ``text``, ``logit_scale``) as
    numpy -> the port's ``CLIP`` on ``device``."""
    clip = CLIP(spec)
    _load(clip, _to_state_dict(_flatten(clip_np), _STACKED["clip"]), "clip")
    return clip.to(resolve_device(device))


def from_jax(bundle_np: dict, bn_state_np: dict, spec: CLIPSpec, peft_cfg: PeftConfig, *,
             device=None):
    """Reference bundle ``{"clip", "peft", "head"}`` and BN state ``{"mean",
    "var"}`` as numpy -> (the port's bundle of modules, BN state tensors) on
    ``device``."""
    dev = resolve_device(device)
    clip = clip_from_jax(bundle_np["clip"], spec, device=dev)

    peft = None
    if peft_cfg.has_peft_params:
        peft = MODULE_CLASSES[peft_cfg.method](spec.vision.layers, spec.vision.width)
        _load(peft, _to_state_dict(_flatten(bundle_np["peft"]), _STACKED["peft"]), "peft")

    kernel = np.asarray(bundle_np["head"]["linear"]["kernel"])
    head = Head(*kernel.shape)
    _load(head, _to_state_dict(_flatten(bundle_np["head"]), ()), "head")

    bundle = {"clip": clip, "peft": None if peft is None else peft.to(dev),
              "head": head.to(dev)}
    bn = {k: torch.from_numpy(np.array(bn_state_np[k], np.float32)).to(dev)
          for k in ("mean", "var")}
    return bundle, bn


def _peft_tree(tree: dict) -> dict:
    """A PEFT tree in the reference's layout: ``"shared"`` is None for a
    method that shares nothing (LoRA, the adapter)."""
    return {"shared": tree.get("shared"), **tree}


def to_jax(bundle: dict, bn_state: dict):
    """The port's bundle and BN state -> the reference's layout as numpy."""
    out = {"clip": _from_state_dict(bundle["clip"].state_dict(), _STACKED["clip"]),
           "peft": None if bundle.get("peft") is None
           else _peft_tree(_from_state_dict(bundle["peft"].state_dict(), _STACKED["peft"])),
           "head": _from_state_dict(bundle["head"].state_dict(), ())}
    bn = {k: v.detach().cpu().numpy() for k, v in bn_state.items()}
    return out, bn


def _reference_path(path: tuple, prefixes: tuple) -> tuple:
    """A port parameter path inside a module -> the reference's leaf path
    (a stacked prefix's layer index dropped)."""
    stacked = _stacked_prefix(path, prefixes)
    return path if stacked is None else stacked + path[len(stacked) + 1:]


def _fill(tree: dict, values: dict) -> None:
    for key, val in values.items():
        if isinstance(val, dict):
            _fill(tree[key], val)
        else:
            tree[key] = val


def trainable_to_jax(bundle: dict) -> dict:
    """The reference's trainable partition of a bundle (``{"clip", "peft",
    "head"}`` of modules or None): every module's tree in the reference's
    layout, the parameters that require a gradient as numpy (layers
    restacked) and every other leaf None; a None module stays None."""
    out = {}
    for top, module in bundle.items():
        if module is None:
            out[top] = None
            continue
        prefixes = _STACKED.get(top, ())
        named = dict(module.named_parameters())
        tree: dict = {}
        for name in named:
            path = _reference_path(tuple(name.split(".")), prefixes)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = None
        _fill(tree, _from_state_dict({n: p for n, p in named.items() if p.requires_grad},
                                     prefixes))
        out[top] = _peft_tree(tree) if top == "peft" else tree
    return out


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


def _flatten_leaves(tree, prefix: tuple = ()) -> dict:
    """Like ``_flatten``, with the reference's int8 leaves ``{"_q8",
    "scale"}`` kept whole."""
    from .quant import QUANT_KEY

    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) and QUANT_KEY not in val:
            out.update(_flatten_leaves(val, prefix + (key,)))
        elif val is not None:
            out[prefix + (key,)] = val
    return out


def _layer_slice(leaf, i: int, dev):
    """Layer ``i`` of a stacked leaf, as a tensor or an int8 leaf."""
    if not isinstance(leaf, dict):
        return torch.from_numpy(np.array(leaf[i])).to(dev)
    q8, scale = np.asarray(leaf["_q8"]), np.asarray(leaf["scale"])
    row = scale[0] if q8.ndim == 2 else scale[i]  # a stacked (L, out) leaf shares its scale row
    return {"_q8": torch.from_numpy(np.array(q8[i])).to(dev),
            "scale": torch.from_numpy(np.array(row)).to(dev)}


def _whole(leaf, dev):
    if isinstance(leaf, dict):
        return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in leaf.items()}
    return torch.from_numpy(np.array(leaf)).to(dev)


def serving_weights_from_jax(weights_np: dict, *, device=None) -> dict:
    """The reference's ``serving_weights`` tree as numpy (``{"bundle":
    {"clip", "peft", "head"}, "bn_state"}``, int8 leaves included) -> the
    port's ``serve.serving_weights`` dict on ``device``, layers unstacked."""
    dev = resolve_device(device)
    bundle = {}
    for top, sub in weights_np["bundle"].items():
        if sub is None:
            continue
        prefixes = _STACKED.get(top, ())
        for path, leaf in _flatten_leaves(sub).items():
            stacked = _stacked_prefix(path, prefixes)
            if stacked is None:
                bundle[".".join((top,) + path)] = _whole(leaf, dev)
                continue
            k = len(stacked)
            n_layers = np.asarray(leaf["_q8"] if isinstance(leaf, dict) else leaf).shape[0]
            for i in range(n_layers):
                name = ".".join((top,) + stacked + (str(i),) + path[k:])
                bundle[name] = _layer_slice(leaf, i, dev)
    bn = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
          for k, v in weights_np["bn_state"].items()}
    return {"bundle": bundle, "bn_state": bn}


def _stack_layers(leaves: list):
    if not isinstance(leaves[0], dict):
        return np.stack([t.detach().cpu().numpy() for t in leaves])
    q8 = np.stack([q["_q8"].cpu().numpy() for q in leaves])
    if q8.ndim == 2:
        scale = leaves[0]["scale"].cpu().numpy()[None]
    else:
        scale = np.stack([q["scale"].cpu().numpy() for q in leaves])
    return {"_q8": q8, "scale": scale}


def serving_weights_to_jax(weights: dict) -> dict:
    """The port's ``serve.serving_weights`` dict -> the reference's tree as
    numpy, layers restacked (LoRA's and the adapter's ``peft`` get the
    reference's ``"shared": None``, a bundle with no PEFT module ``"peft":
    None``)."""
    to_np = lambda t: ({k: v.cpu().numpy() for k, v in t.items()} if isinstance(t, dict)
                       else t.detach().cpu().numpy())
    layers: dict = {}
    tree: dict = {}
    for name, leaf in weights["bundle"].items():
        top, rest = name.split(".", 1)
        path = tuple(rest.split("."))
        stacked = _stacked_prefix(path, _STACKED.get(top, ()))
        if stacked is not None and stacked_layer_axes(name):
            k = len(stacked)
            layers.setdefault((top, stacked + path[k + 1:]), {})[int(path[k])] = leaf
            continue
        node = tree.setdefault(top, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_np(leaf)
    for (top, path), per_layer in layers.items():
        node = tree.setdefault(top, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _stack_layers([per_layer[i] for i in range(len(per_layer))])
    if "peft" in tree:
        tree["peft"] = _peft_tree(tree["peft"])
    elif "head" in tree:  # a whole bundle of a method with no PEFT module
        tree["peft"] = None
    bn = {k: v.detach().cpu().numpy() for k, v in weights["bn_state"].items()}
    order = [k for k in ("clip", "peft", "head") if k in tree]
    return {"bundle": {k: tree[k] for k in order}, "bn_state": bn}


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
