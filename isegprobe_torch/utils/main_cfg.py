"""A reader of ``configs/main_cfg.yaml``'s form, without a YAML package.

The root CLIs read the machine paths (``EXPS_PATH``, ``DATASETS.*``) from
the file that ``main_cfg_path`` names, with PyYAML. The card's machine has
no PyYAML, so the port reads the form that file has: ``#`` comments, maps
nested by indentation (spaces), and scalars quoted with ``"`` or ``'`` or
bare. Anything else (lists, flow collections, anchors, tags, block
scalars, tabs) raises ``ValueError`` naming its line.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["read_main_cfg"]

_KEY = re.compile(r"([A-Za-z_][\w.-]*)\s*:(?:\s+(.*))?$")


def _scalar(text: str, where: str) -> str:
    """A scalar with its trailing comment removed and its quotes taken
    off."""
    if text[:1] in ("'", '"'):
        end = text.find(text[0], 1)
        rest = text[end + 1:].strip() if end > 0 else ""
        if end < 0 or (rest and not rest.startswith("#")):
            raise ValueError(f"{where}: unclosed or trailing text after a "
                             f"quoted scalar: {text!r}")
        return text[1:end]
    value = re.split(r"\s#", text, maxsplit=1)[0].strip()
    if value[:1] in ("[", "{", "|", ">", "&", "*", "!", "-", "@", "`"):
        raise ValueError(f"{where}: {value!r} is outside the form of "
                         "configs/main_cfg.yaml (maps and scalars)")
    return value


def read_main_cfg(path) -> Dict[str, str]:
    """The file's scalars by dotted key (``DATASETS.SBD_PATH``); a key
    with no value and no children maps to ``""``."""
    path = Path(path)
    out: Dict[str, str] = {}
    # the open maps: (indent of the map's key, dotted prefix, indent of
    # its children)
    stack: List[Tuple[int, str, int]] = []
    pending = None  # a key opened as a map, not yet given a child
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        where = f"{path}:{lineno}"
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body[:len(body) - len(stripped)]:
            raise ValueError(f"{where}: indentation by tabs")
        indent = len(body) - len(stripped)
        match = _KEY.match(stripped)
        if not match:
            raise ValueError(f"{where}: {stripped!r} is not a 'key: value' "
                             "line of configs/main_cfg.yaml's form")
        if pending is not None:
            if indent > pending[0]:
                stack.append((*pending, indent))
            else:
                out[pending[1]] = ""
            pending = None
        while stack and indent <= stack[-1][0]:
            stack.pop()
        if indent != (stack[-1][2] if stack else 0):
            raise ValueError(f"{where}: indentation does not match its map")
        key = (stack[-1][1] + "." if stack else "") + match.group(1)
        value = (match.group(2) or "").strip()
        if not value or value.startswith("#"):
            pending = (indent, key)
            continue
        out[key] = _scalar(value, where)
    if pending is not None:
        out[pending[1]] = ""
    return out
