"""The YAML the config files use, read and written without PyYAML.

The card's Python has no PyYAML, so the config reads and writes YAML with
this module on every host (one reader, so the CPU tests run the card's
path).  It covers the subset of YAML 1.1 that the repo's files and
:func:`dump` use, and reads it as PyYAML's ``safe_load`` does:

* a mapping at the top, block mappings by indentation (spaces only),
  ``key: value`` and ``key:`` followed by a deeper block or by nothing
  (null);
* flow sequences ``[a, 'b', [1, 2]]`` on one line, and the empty mapping
  ``{}``;
* quoted scalars (single quotes; double quotes with no escapes but ``\\\\``
  and ``\\"``), and plain scalars: null, ``true``/``false``, decimal
  integers, floats that carry a dot such as ``0.`` or ``1.0e-05``
  (``1e-5`` is a string, as in PyYAML), and strings;
* ``#`` comments.

Anything else raises ``ValueError``: block sequences, anchors and aliases,
tags, block scalars, multi-line flow collections, several documents, tabs,
and the plain scalars that PyYAML resolves to something else than the list
above says (``yes``/``on``/``off``, octal, hex and binary integers,
``.inf`` and ``.nan``, sexagesimal numbers, dates).
"""

from __future__ import annotations

import math
import re
from typing import Any

_NULL = ("~", "null", "Null", "NULL", "")
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?")
# plain scalars PyYAML resolves specially, beyond the forms above: YAML 1.1
# booleans, octal/hex/binary integers, .inf/.nan, sexagesimal numbers, dates,
# and the '=' and '<<' keys
_SPECIAL = re.compile(
    r"yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|[-+]?0[0-7_]+|[-+]?0[xb][0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|=|<<")


def _plain(text: str, where: str) -> Any:
    """A plain scalar, resolved as PyYAML's implicit resolvers do."""
    if (text.startswith(("&", "*", "!", "|", ">", "%", "@", "`", "{", "- ")) or text == "-"
            or _SPECIAL.fullmatch(text)):
        raise ValueError(f"{where}: plain scalar {text!r} is outside the supported YAML subset; "
                         "quote it if it is a string")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    return text


class _Line:
    """Scans one line's content: scalars, flow sequences, the comment."""

    def __init__(self, text: str, where: str, start: int):
        self.s, self.where, self.i = text, where, start

    def error(self, what: str):
        return ValueError(f"{self.where}: {what} in {self.s!r}")

    def skip_spaces(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment."""
        self.skip_spaces()
        if self.i >= len(self.s):
            return True
        return self.s[self.i] == "#" and self.s[self.i - 1] == " "

    def quoted(self) -> str:
        q = self.s[self.i]
        j = self.i + 1
        while True:
            if j >= len(self.s):
                raise self.error("unterminated quoted scalar (multi-line scalars are not supported)")
            if q == "'" and self.s[j] == "'":
                if self.s[j + 1:j + 2] != "'":
                    break
                j += 1
            elif q == '"' and self.s[j] == "\\":
                if self.s[j + 1:j + 2] not in ('"', "\\"):
                    raise self.error("escapes other than \\\\ and \\\" are not supported")
                j += 1
            elif q == '"' and self.s[j] == '"':
                break
            j += 1
        body = self.s[self.i + 1:j]
        self.i = j + 1
        return body.replace("''", "'") if q == "'" else re.sub(r"\\(.)", r"\1", body)

    def plain_until(self, stops: str) -> str:
        """A plain scalar up to a stop character or `` #``."""
        j = self.i
        while j < len(self.s):
            ch = self.s[j]
            if ch in stops or (ch == "#" and self.s[j - 1] == " "):
                break
            if ch == ":" and (j + 1 == len(self.s) or self.s[j + 1] == " "):
                raise self.error("mappings inside a flow sequence or on one line are not supported")
            j += 1
        text = self.s[self.i:j].rstrip(" ")
        self.i = j
        return text

    def flow_item(self) -> Any:
        self.skip_spaces()
        ch = self.s[self.i:self.i + 1]
        if not ch:
            raise self.error("multi-line flow sequences are not supported")
        if ch == "[":
            return self.flow_sequence()
        if ch in "'\"":
            return self.quoted()
        if ch == "{":
            raise self.error("flow mappings are not supported")
        return _plain(self.plain_until(",]"), self.where)

    def flow_sequence(self) -> list:
        self.i += 1  # '['
        items = []
        self.skip_spaces()
        while self.s[self.i:self.i + 1] != "]":
            items.append(self.flow_item())
            self.skip_spaces()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
                self.skip_spaces()
            elif ch != "]":
                raise self.error("multi-line flow sequences are not supported" if not ch
                                 else f"unexpected {ch!r} in a flow sequence")
        self.i += 1
        return items

    def value(self) -> Any:
        """A whole-line value: a flow sequence, ``{}``, or a scalar."""
        self.skip_spaces()
        ch = self.s[self.i:self.i + 1]
        if ch == "[":
            v = self.flow_sequence()
        elif ch == "{":
            if not self.s[self.i:].startswith("{}"):
                raise self.error("only the empty flow mapping {} is supported")
            self.i += 2
            v = {}
        elif ch in ("'", '"'):
            v = self.quoted()
        else:
            return _plain(self.plain_until(""), self.where)
        if not self.at_end():
            raise self.error("unexpected text after a value")
        return v

    def key(self) -> Any:
        """``key:`` at the line's start; the scanner is left after the colon."""
        if self.s[self.i] in "'\"":
            k = self.quoted()
        else:
            j = self.i
            while j < len(self.s) and not (self.s[j] == ":" and (j + 1 == len(self.s)
                                                                  or self.s[j + 1] == " ")):
                j += 1
            k = _plain(self.s[self.i:j].rstrip(" "), self.where)
            self.i = j
        if self.s[self.i:self.i + 1] != ":":
            raise self.error("expected 'key: value' (only a mapping may stand at the top)")
        self.i += 1
        return k


def load(text: str) -> Any:
    """Parse YAML text of the supported subset, as ``yaml.safe_load``."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        stripped = raw.strip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("\t"):
            raise ValueError(f"{where}: tabs in indentation are not supported")
        if stripped.startswith(("---", "...", "%")):
            raise ValueError(f"{where}: directives and multiple documents are not supported")
        if stripped == "-" or stripped.startswith("- "):
            raise ValueError(f"{where}: block sequences are not supported")
        indent = len(raw) - len(raw.lstrip(" "))
        lines.append((indent, _Line(raw, where, indent)))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1].s.strip(" ") == "{}":  # dump's empty tree
        return {}
    value, pos = _block_mapping(lines, 0, lines[0][0])
    if pos != len(lines):
        raise lines[pos][1].error("bad indentation")
    return value


def _block_mapping(lines: list, pos: int, indent: int) -> tuple:
    out: dict = {}
    while pos < len(lines) and lines[pos][0] == indent:
        scan = lines[pos][1]
        key = scan.key()
        pos += 1
        if not scan.at_end():
            out[key] = scan.value()
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _block_mapping(lines, pos, lines[pos][0])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise lines[pos][1].error("bad indentation")
    return out, pos


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float) and math.isfinite(v):
        r = repr(v)
        return r if "." in r else r.replace("e", ".0e", 1)  # 1e-05 would read back as a string
    if isinstance(v, str) and v.isprintable():
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    raise ValueError(f"cannot write {type(v).__name__} {v!r} in the supported YAML subset")


def _key(k: str) -> str:
    if not isinstance(k, str):
        raise ValueError(f"config keys are strings, got {k!r}")
    plain = _PLAIN_KEY.fullmatch(k) and not _SPECIAL.fullmatch(k) and _plain(k, "key") == k
    return k if plain else _scalar(k)


def dump(tree: dict) -> str:
    """YAML text for a tree of dicts, lists/tuples and scalars, keys sorted;
    it reads back (here and through ``yaml.safe_load``) to the same tree."""
    if not tree:
        return "{}\n"
    out: list = []

    def block(node: dict, indent: int) -> None:
        for k in sorted(node):
            v = node[k]
            head = " " * indent + _key(k) + ":"
            if isinstance(v, dict) and v:
                out.append(head)
                block(v, indent + 2)
            else:
                out.append(head + " " + ("{}" if isinstance(v, dict) else _scalar(v)))

    block(tree, 0)
    return "\n".join(out) + "\n"
