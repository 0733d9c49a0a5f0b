"""Config system: YAML files, an attribute dict and dotted overrides.

Counterpart of ``isegprobe_tpu/utils/config.py``: the same names, the same
files (``configs/eval_cfg.yaml``, ``train_cfg.yaml``, ``main_cfg.yaml``)
and the same ``a.b.c=value`` overrides. The card's machine has no YAML
package, so the port reads the form those files have, with PyYAML's
``SafeLoader`` types:

* ``#`` comments, on a line of their own or after a value;
* block maps nested by spaces (``key:`` opens a map, or is null when
  nothing is nested under it);
* scalars quoted with ``'`` or ``"``, or bare;
* flow sequences, nested too (``[[0, 3], [15, 1]]``).

Bare scalars are typed by YAML 1.1, as ``SafeLoader`` types them: ``null``
and ``~`` (and nothing at all), ``true``/``yes``/``on`` and ``false``/
``no``/``off`` in their three case forms, ints (with ``0x``, ``0b``,
leading-zero octal, ``_`` and base 60), floats (with a dot, or ``.inf``
and ``.nan``); anything else is a string. A form outside this subset
(anchors, aliases, tags, block scalars, block sequences, flow maps,
timestamps, multi-line scalars, tabs) raises ``ValueError`` naming its
line: it is never read as something else.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Optional

__all__ = ["EDict", "load_yaml", "apply_overrides", "load_config",
           "find_main_config"]


class EDict(dict):
    """Attribute-access dict (the reference's easydict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def convert(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.convert(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.convert(v) for v in obj)
        return obj


class _Malformed(ValueError):
    """Text that PyYAML refuses too."""


class _Unsupported(ValueError):
    """A YAML form that PyYAML reads and this reader does not."""


# PyYAML's implicit resolvers (resolver.py), tried in its order
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF")
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN)""", re.X)
_INT = re.compile(r"""[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(r"""[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?""",
                        re.X)
_SAFE_TAG = re.compile(r"!!(?:str|int|float|bool|null|seq|map|binary"
                       r"|timestamp|omap|pairs|set)(?=[\s\0]|$)")
_BOOL_TRUE = ("yes", "true", "on")
_BREAK = "\0 \t\r\n"


def _sexagesimal(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve(text: str) -> Any:
    """A bare scalar's value, as ``SafeLoader`` resolves and constructs
    it."""
    first = text[:1]
    if first in "yYnNtTfFoO" and first and _BOOL.fullmatch(text):
        return text.lower() in _BOOL_TRUE
    if first in "-+0123456789." and first and _FLOAT.fullmatch(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if first in "-+0123456789" and first and _INT.fullmatch(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if first in ("~", "n", "N", "") and _NULL.fullmatch(text):
        return None
    if first.isdigit() and _TIMESTAMP.fullmatch(text):
        raise _Unsupported(f"timestamp {text!r}")
    if text in ("<<", "="):
        raise _Malformed(f"{text!r} (SafeLoader constructs no value)")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Scalars:
    """A recursive-descent reader of one line's value: a scalar or a
    (nested) flow sequence."""

    def __init__(self, text: str) -> None:
        self.s = text
        self.i = 0

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1

    def document(self) -> Any:
        """The whole text as a block-context value."""
        self.spaces()
        if self.peek() == "#":
            self.i = len(self.s)
        value = self.node(flow=False)
        self.spaces()
        if self.peek() == "#":
            self.i = len(self.s)
        if self.i < len(self.s):
            if self.peek() == ":" and self.peek(1) in _BREAK:
                raise _Unsupported("a map inside a value")
            raise _Malformed(f"text after the value: {self.s[self.i:]!r}")
        return value

    def node(self, flow: bool) -> Any:
        ch = self.peek()
        nxt = self.peek(1)
        if ch == "[":
            return self.sequence()
        if ch == "{":
            raise _Unsupported("a flow map")
        if ch in "'\"":
            return self.quoted(ch)
        if ch == "!" and not _SAFE_TAG.match(self.s, self.i):
            raise _Malformed(f"a tag that SafeLoader refuses: {self.s!r}")
        if ch in "&!|>":
            raise _Unsupported(f"{ch!r} (an anchor, a tag or a block "
                               "scalar)")
        if ch in "-?:" and nxt in _BREAK + (",[]{}" if flow else ""):
            if ch == "-" or ch == "?":
                raise _Unsupported("a block sequence or a complex key")
            raise _Unsupported("a map inside a value")
        if ch in "*@`%,]}":
            raise _Malformed(f"{ch!r} cannot start a scalar")
        if ch == "\0":
            return None
        if ch == "\t":
            raise _Unsupported("a tab")
        return _resolve(self.plain(flow))

    def plain(self, flow: bool) -> str:
        start = self.i
        end = self.i
        while True:
            ch = self.peek()
            if ch == "\0":
                break
            if ch == "\t":
                raise _Unsupported("a tab")
            if ch == ":" and self.peek(1) in _BREAK + (",[]{}" if flow
                                                        else ""):
                break
            if flow and ch in ",?[]{}":
                break
            if ch == " ":
                j = self.i
                while self.peek() == " ":
                    self.i += 1
                if self.peek() in "#\0":
                    self.i = j
                    break
                continue
            self.i += 1
            end = self.i
        self.i = end
        return self.s[start:end]

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while True:
            ch = self.peek()
            if ch == "\0" and self.i >= len(self.s):
                raise _Malformed("an unclosed quoted scalar (or one that "
                                 "goes on to another line)")
            if ch == "\t":
                raise _Unsupported("a tab")
            if q == "'" and ch == "'":
                if self.peek(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                break
            if q == '"' and ch == '"':
                self.i += 1
                break
            if q == '"' and ch == "\\":
                esc = self.peek(1)
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                    continue
                if esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not re.fullmatch(
                            r"[0-9a-fA-F]+", digits):
                        raise _Malformed(f"a bad escape in {self.s!r}")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                    continue
                raise _Malformed(f"an unknown escape \\{esc}, or a quoted "
                                 "scalar that goes on to another line")
            out.append(ch)
            self.i += 1
        return "".join(out)

    def sequence(self) -> List:
        self.i += 1
        items: List = []
        while True:
            self.spaces()
            ch = self.peek()
            if ch == "]":
                self.i += 1
                return items
            if ch == "\0" or ch == "#":
                raise _Malformed("an unclosed flow sequence (or one that "
                                 "goes on to another line)")
            if ch == ",":
                raise _Malformed("an empty entry in a flow sequence")
            items.append(self.node(flow=True))
            self.spaces()
            ch = self.peek()
            if ch == ",":
                self.i += 1
            elif ch == ":":
                raise _Unsupported("a map inside a flow sequence")
            elif ch != "]":
                raise _Malformed(f"expected ',' or ']' in {self.s!r}")


_KEY = re.compile(r"([^\s#'\"\[\]{},&*!|>%@`:-][^\s:]*)\s*:(?:[ ](.*))?$")


def _parse_lines(text: str, name: str) -> dict:
    """The block maps of a file, nested by indentation."""
    root: dict = {}
    # the open maps: (indent of their keys, the map)
    stack = [(0, root)]
    pending = None  # (indent, map, key) of a key with no value yet
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        body = raw.rstrip(" \r")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body:
            raise ValueError(f"{where}: a tab (outside this reader's YAML "
                             "subset)")
        if stripped in ("---", "...") or stripped.startswith(("--- ",
                                                              "%")):
            raise ValueError(f"{where}: a document marker or directive "
                             "(outside this reader's YAML subset)")
        indent = len(body) - len(stripped)
        match = _KEY.match(stripped)
        if not match:
            raise ValueError(f"{where}: {stripped!r} is not a 'key: value' "
                             "line of a block map (block sequences and "
                             "multi-line scalars are outside this reader's "
                             "YAML subset)")
        if pending is not None:
            p_indent, p_map, p_key = pending
            if indent > p_indent:
                child: dict = {}
                p_map[p_key] = child
                stack.append((indent, child))
            pending = None
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: the indentation does not match its "
                             "map")
        key_text, value_text = match.group(1), match.group(2) or ""
        try:
            key = _resolve(key_text)
            if not isinstance(key, str):
                raise _Unsupported(f"a key that is not a string "
                                   f"({key_text!r})")
            value = _Scalars(value_text).document()
        except ValueError as e:
            raise ValueError(f"{where}: {e} (outside this reader's YAML "
                             "subset or malformed)") from None
        target = stack[-1][1]
        target[key] = value
        if value is None and not value_text.strip(" ").split("#")[0]:
            pending = (indent, target, key)
    return root


def load_yaml(path: str | Path) -> EDict:
    """The file's maps as an :class:`EDict`, without the Hydra-only
    ``defaults`` and ``hydra`` keys."""
    path = Path(path)
    data = _parse_lines(path.read_text(), str(path))
    data.pop("defaults", None)
    data.pop("hydra", None)
    return EDict.convert(data)


_SCI_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+")


def _parse_value(text: str) -> Any:
    """An override's value as PyYAML reads it, or the raw text where PyYAML
    refuses it; an exponent-form string such as ``2e-4`` (a string in YAML
    1.1) is the float it means."""
    if "\n" in text or "\r" in text:
        raise ValueError(f"a value of several lines: {text!r}")
    try:
        value = _Scalars(text).document()
    except _Malformed:
        return text
    if isinstance(value, str) and _SCI_FLOAT.fullmatch(value):
        return float(value)
    return value


def apply_overrides(cfg: EDict, overrides: List[str]) -> EDict:
    """Apply ``a.b.c=value`` overrides in place (Hydra CLI syntax)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like key=value, got: {ov}")
        key, _, raw = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = EDict()
            node = node[part]
        node[parts[-1]] = EDict.convert(_parse_value(raw))
    return cfg


def load_config(config_path: str | Path,
                overrides: Optional[List[str]] = None) -> EDict:
    cfg = load_yaml(config_path)
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def find_main_config(start: str | Path,
                     name: str = "main_cfg.yaml") -> Optional[Path]:
    """The machine-paths file, searched upward from ``start`` (in a
    directory or its ``configs/``)."""
    p = Path(start).resolve()
    for parent in [p, *p.parents]:
        candidate = parent / name
        if candidate.exists():
            return candidate
        candidate = parent / "configs" / name
        if candidate.exists():
            return candidate
    return None
