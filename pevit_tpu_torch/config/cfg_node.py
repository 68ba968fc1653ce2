"""A minimal yacs-compatible configuration node.

A copy of ``pevit_tpu/config/cfg_node.py`` (the port imports nothing of the
JAX package), with one change: YAML is read and written by the port's own
``yaml_subset`` module, not by PyYAML, which the card's Python lacks.

The reference framework configures everything through yacs ``CfgNode`` trees
(reference: vision_benchmark/config/default.py:7-272).  This module provides
a from-scratch implementation of the subset of the yacs API the framework
surface needs:

* attribute-style access over a nested dict,
* ``freeze()`` / ``defrost()`` mutation discipline,
* ``merge_from_file(yaml)`` with recursive ``BASE`` includes,
* ``merge_from_list(["KEY.SUBKEY", value, ...])`` CLI override grammar,
* ``new_allowed`` nodes that accept keys not present in the defaults.

The semantics (type coercion rules, error behaviour on unknown keys) follow
what the reference relies on, so existing ``--ds/--model ... KEY VALUE``
invocations behave identically.
"""

from __future__ import annotations

import ast
import copy
import os.path as op
from typing import Any

from . import yaml_subset

_FROZEN = "__frozen__"
_NEW_ALLOWED = "__new_allowed__"


class CfgNode(dict):
    """Nested, attribute-accessible config container."""

    def __init__(self, init_dict: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        object.__setattr__(self, _NEW_ALLOWED, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._to_node(v, new_allowed)

    @classmethod
    def _to_node(cls, value: Any, new_allowed: bool = False) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value, new_allowed=new_allowed)
        return value

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(
                f"Attempted to set {name} on an immutable CfgNode. Call defrost() first."
            )
        if name not in self and not object.__getattribute__(self, _NEW_ALLOWED):
            # Key creation is allowed only before first freeze (default-tree
            # construction) or on new_allowed nodes; mirror yacs behaviour of
            # rejecting typo'd override keys.
            if getattr(self, "_sealed", False):
                raise KeyError(f"Non-existent config key: {name}")
        super().__setitem__(name, self._to_node(value, object.__getattribute__(self, _NEW_ALLOWED)))

    # -- freeze discipline -------------------------------------------------
    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, _FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def seal(self) -> None:
        """Mark the default tree complete: unknown keys now raise (yacs parity)."""
        super().__setattr__("_sealed", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.seal()

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode | dict") -> None:
        self._merge_dict(dict(other))

    def _merge_dict(self, d: dict) -> None:
        for k, v in d.items():
            if k in self and isinstance(self[k], CfgNode) and isinstance(v, dict):
                self[k]._merge_dict(v)
            elif k in self:
                super().__setitem__(k, _coerce(v, self[k], k))
            elif object.__getattribute__(self, _NEW_ALLOWED):
                super().__setitem__(k, self._to_node(v, True))
            else:
                raise KeyError(f"Non-existent config key: {k}")

    def merge_from_file(self, cfg_file: str) -> None:
        """Merge a YAML file, honouring recursive BASE includes
        (reference: vision_benchmark/config/default.py:237-249)."""
        with open(cfg_file, "r") as f:
            yaml_cfg = yaml_subset.load(f.read()) or {}
        for base in yaml_cfg.pop("BASE", ["" ]) or [""]:
            if base:
                self.merge_from_file(op.join(op.dirname(cfg_file), base))
        was_frozen = self.is_frozen()
        if was_frozen:
            self.defrost()
        self._merge_dict(yaml_cfg)
        if was_frozen:
            self.freeze()

    def merge_from_list(self, opts: list) -> None:
        """Merge ``[KEY, VALUE, KEY, VALUE, ...]`` CLI overrides."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf in node:
                super(CfgNode, node).__setitem__(leaf, _coerce(_parse(value), node[leaf], key))
            elif object.__getattribute__(node, _NEW_ALLOWED):
                super(CfgNode, node).__setitem__(leaf, _parse(value))
            else:
                raise KeyError(f"Non-existent config key: {key}")

    def __deepcopy__(self, memo) -> "CfgNode":
        # dict-subclass deepcopy re-applies instance state (incl. _sealed)
        # before re-inserting items, which trips the unknown-key guard; build
        # the copy explicitly instead.
        node = CfgNode.__new__(CfgNode)
        dict.__init__(node)
        object.__setattr__(node, _FROZEN, False)
        object.__setattr__(node, _NEW_ALLOWED, object.__getattribute__(self, _NEW_ALLOWED))
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        if getattr(self, "_sealed", False):
            object.__setattr__(node, "_sealed", True)
        object.__setattr__(node, _FROZEN, object.__getattribute__(self, _FROZEN))
        return node

    def clone(self) -> "CfgNode":
        node = copy.deepcopy(self)
        node._set_frozen(False)
        return node

    def dump(self) -> str:
        """YAML text of the tree, keys sorted (``yaml_subset.dump``)."""
        return yaml_subset.dump(_to_plain(self))

    def get(self, key, default=None):  # keep dict.get semantics (used for SPEC lookups)
        return super().get(key, default)


def _to_plain(node: Any) -> Any:
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
    return node


def _parse(value: Any) -> Any:
    """Parse a CLI string into a Python literal when possible (yacs grammar)."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    """yacs-compatible type checking with the standard allowed casts."""
    if old is None or new is None:
        return new
    old_t, new_t = type(old), type(new)
    if old_t is new_t:
        return new
    # allowed conversions mirroring yacs _check_and_coerce_cfg_value_type
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float):
        return new  # widen silently (LR grids pass floats over int defaults)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, str) or isinstance(new, str):
        # the reference passes e.g. `--no-tuning False` through argparse as str
        if isinstance(old, bool):
            return str(new).lower() in ("true", "1", "yes")
        if isinstance(old, (int, float)):
            try:
                return old_t(new)
            except ValueError:
                pass
    raise ValueError(
        f"Type mismatch ({old_t} vs {new_t}) for config key {key}: {old} vs {new}"
    )
