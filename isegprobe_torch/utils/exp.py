"""Run directories of the train command line: numbering, resuming, the
script copy and the run log.

Counterpart of ``isegprobe_tpu/utils/exp.py:init_experiment``. A run of
the model script ``models/<dirs>/<stem>.py`` lives under
``<exp_path>/<dirs>/<stem>/`` as ``NNN_<name>`` (zero-padded, one more than
the highest number there; a script outside ``models/`` goes to
``<exp_path>/<stem>/``), the path the JAX package gives it, so that one
``exp_path`` holds the runs of either package. A run directory holds
``checkpoints/``, ``vis/`` (the training image dumps), ``logs/`` (the
TensorBoard events and ``train.log``, a file handler on the package
logger) and a copy of the model script when the script exists (a file
copy: the port does not import it). Resuming (``resume_exp``) picks the
last run whose directory name starts with the given prefix (an int is
zero-padded: ``0`` is ``000``; ``False`` means a fresh run, not run 000)
and, inside its ``checkpoints/``, the last checkpoint whose name starts
with ``resume_prefix`` (``latest``: ``last_checkpoint*``; an int is
zero-padded to the epoch checkpoints' ``008.ckpt``). The resumed run keeps
writing into its own directory.
"""

from __future__ import annotations

import logging
import shutil
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

__all__ = ["init_experiment", "run_parent"]

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


def run_parent(model_path: Union[str, Path]) -> Tuple[Path, str]:
    """(directories, stem) of a model script's runs: the script's
    directories under the last ``models`` of its path (none outside
    ``models/``) and its stem."""
    model_path = Path(model_path)
    parts = model_path.parts
    if "models" in parts:
        idx = len(parts) - 1 - parts[::-1].index("models")
        return Path(*parts[idx + 1:-1]), model_path.stem
    return Path(), model_path.stem


class _RunLog(logging.FileHandler):
    """The file handler of a run's ``train.log``."""


def _log_to(path: Path) -> None:
    """Route the package logger to ``path`` (the run's ``train.log``),
    closing the handler of an earlier run of this process."""
    for old in [h for h in logger.handlers if isinstance(h, _RunLog)]:
        logger.removeHandler(old)
        old.close()
    handler = _RunLog(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)


def _world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_experiment(exp_path: Union[str, Path],
                    model_path: Union[str, Path],
                    name: Optional[str] = None, resume_exp=None,
                    resume_prefix="latest") -> Dict:
    """Make (or, with ``resume_exp``, find) a run directory of the model
    script ``model_path`` under ``exp_path``. Returns ``{"exp_path": run
    directory, "checkpoints_path", "vis_path", "logs_path": its
    subdirectories, "weights": the checkpoint to resume from or None}``.
    ``name`` defaults to today's date, as in the JAX package."""
    rel, stem = run_parent(model_path)
    parent = Path(exp_path) / rel / stem
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
        run_num = last + 1
        multiproc = _world() > 1
        if multiproc:
            # every rank takes rank 0's number, so that they agree on the
            # run directory even where a shared file system makes the scan
            # racy (the JAX package broadcasts it the same way)
            import torch.distributed as dist

            box = [run_num]
            dist.broadcast_object_list(box, src=0)
            run_num = int(box[0])
        run = parent / f"{run_num:03d}_{name}"
        run.mkdir(parents=True, exist_ok=multiproc)
    paths = {key: run / sub for key, sub in (
        ("checkpoints_path", "checkpoints"), ("vis_path", "vis"),
        ("logs_path", "logs"))}
    for p in paths.values():
        p.mkdir(exist_ok=True)
    if Path(model_path).exists():
        shutil.copy(model_path, run / Path(model_path).name)
    _log_to(paths["logs_path"] / "train.log")
    logger.info("Experiment dir: %s", run)
    return {"exp_path": run, **paths, "weights": weights}
