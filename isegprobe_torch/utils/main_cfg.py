"""``configs/main_cfg.yaml``'s machine paths by dotted key.

The root CLIs read the machine paths (``EXPS_PATH``, ``DATASETS.*``) from
the file that ``main_cfg_path`` names; the port reads it with
``utils/config.py:load_yaml`` (no YAML package) and flattens its maps.
"""

from __future__ import annotations

from typing import Dict

from isegprobe_torch.utils.config import load_yaml

__all__ = ["read_main_cfg", "flatten"]


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """A tree of maps as ``{"A.B": leaf}``."""
    out: Dict[str, object] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def read_main_cfg(path) -> Dict[str, str]:
    """The file's scalars by dotted key (``DATASETS.SBD_PATH``) as text; a
    key with no value and no children maps to ``""``."""
    return {key: "" if value is None else str(value)
            for key, value in flatten(load_yaml(path)).items()}
