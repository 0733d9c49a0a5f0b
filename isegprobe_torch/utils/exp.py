"""Run directories of the train command line: numbering and resuming.

Counterpart of the run numbering and resume lookup of
``isegprobe_tpu/utils/exp.py:init_experiment``. A model's runs live under
``<exp_path>/<model_name>/`` as ``NNN_<name>`` (zero-padded, one more than
the highest number there), each with its ``checkpoints/``. Resuming
(``resume_exp``) picks the last run whose directory name starts with the
given prefix (an int is zero-padded: ``0`` is ``000``; ``False`` means a
fresh run, not run 000) and, inside its ``checkpoints/``, the last
checkpoint whose name starts with ``resume_prefix`` (``latest``:
``last_checkpoint*``; an int is zero-padded to the epoch checkpoints'
``008.ckpt``). The resumed run keeps writing into its own directory.
"""

from __future__ import annotations

import logging
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Union

__all__ = ["init_experiment"]

logger = logging.getLogger("isegprobe_torch")


def _padded(value):
    """An int prefix zero-padded to the run and epoch names' three digits
    (``True`` and ``False`` are not ints here)."""
    if isinstance(value, int) and not isinstance(value, bool):
        return f"{value:03d}"
    return value


def _find_resume_exp(parent: Path, pattern: str) -> Path:
    candidates = sorted(parent.glob(f"{pattern}*"))
    if not candidates:
        raise FileNotFoundError(
            f"No experiments matching '{pattern}' under {parent}")
    if len(candidates) > 1:
        logger.warning("Multiple resume candidates; using %s", candidates[-1])
    return candidates[-1]


def init_experiment(exp_path: Union[str, Path], model_name: str,
                    name: Optional[str] = None, resume_exp=None,
                    resume_prefix="latest") -> Dict:
    """Make (or, with ``resume_exp``, find) a run directory of
    ``model_name`` under ``exp_path``. Returns ``{"exp_path": run
    directory, "checkpoints_path": its checkpoints/, "weights": the
    checkpoint to resume from or None}``. ``name`` defaults to today's
    date, as in the JAX package."""
    parent = Path(exp_path) / model_name
    parent.mkdir(parents=True, exist_ok=True)
    if isinstance(resume_exp, bool):
        resume_exp = None  # false means "do not resume", not run 000
    weights = None
    if resume_exp is not None and resume_exp != "":
        run = _find_resume_exp(parent, _padded(resume_exp))
        prefix = _padded(resume_prefix)
        pattern = "last_checkpoint*" if prefix == "latest" else f"{prefix}*"
        candidates = sorted((run / "checkpoints").glob(pattern + ".ckpt"))
        if candidates:
            weights = str(candidates[-1])
            logger.info("Resuming from %s", weights)
    else:
        last = max((int(p.name.split("_")[0]) for p in parent.iterdir()
                    if p.is_dir() and p.name.split("_")[0].isdigit()),
                   default=-1)
        name = name or datetime.now().strftime("%Y-%m-%d")
        run = parent / f"{last + 1:03d}_{name}"
        run.mkdir()
    checkpoints = run / "checkpoints"
    checkpoints.mkdir(exist_ok=True)
    logger.info("Experiment dir: %s", run)
    return {"exp_path": run, "checkpoints_path": checkpoints,
            "weights": weights}
