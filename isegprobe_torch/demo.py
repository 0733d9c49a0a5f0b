"""The interactive demo's command line, the port's counterpart of the root
``demo.py``.

Usage (on a CUDA GPU; ``device=cpu`` runs the plain PyTorch path):

    python -m isegprobe_torch.demo checkpoint=/path/to/ckpt \\
        [eval_mode=fixed224] [dtype=float32] [thresh=0.5] [device=cpu]

It takes the evaluate CLI's ``key=value`` keys (``isegprobe_torch.
evaluate.parse_args``: ``configs/eval_cfg.yaml`` at the working directory,
as the root demo reads it) and builds the predictor as the
root does: ``load_model_for_eval`` at 448², the ZoomIn of
``get_zoomin_params(..., "demo")``, and ``inference/brs.py:get_predictor``
with flip TTA and ``lbfgs_params={"maxfun": lbfgs_max_iters}``. Left click
adds a positive point, right click a negative one; the mouse wheel zooms,
middle-drag (or Ctrl+drag) pans. The controls column has the options the
reference GUI has (ZoomIn, BRS mode, thresholds, blending).

:func:`make_predictor_builder` builds the model and returns the builder
the app calls on every option change, with no display needed; only
:func:`main`'s ``run_app`` opens a Tk window.
"""

from __future__ import annotations

import sys
from typing import Dict

__all__ = ["parse_args", "make_predictor_builder", "main"]

def parse_args(argv) -> Dict:
    """The evaluate CLI's settings (``configs/eval_cfg.yaml`` with the
    overrides)."""
    from isegprobe_torch.evaluate import parse_args as eval_args

    return eval_args(argv)


def make_predictor_builder(cfg: Dict, model=None):
    """The root ``demo.py``'s ``predictor_builder`` over the checkpoint's
    model (``model``, when given, is used as it is). The builder takes
    ``brs_mode``, ``prob_thresh``, ``zoomin_params``, ``predictor_params``
    and ``lbfgs_max_iters``; ``zoomin_params=None`` is the GUI's "Use
    ZoomIn" box off (the frame resized, no ROI), and only an omitted
    argument takes the eval config's ZoomIn. The builder carries
    ``model``, ``device`` and ``default_zoomin``."""
    from isegprobe_torch import resolve_device
    from isegprobe_torch.evaluate import (
        DTYPES,
        get_zoomin_params,
        load_model_for_eval,
    )
    from isegprobe_torch.inference.brs import get_predictor

    device = resolve_device(cfg["device"])
    if model is None:
        model, _ = load_model_for_eval(cfg["checkpoint"], DTYPES[cfg["dtype"]],
                                       device=device,
                                       eval_ritm=cfg["eval_ritm"],
                                       fuse_hr_head=cfg["fuse_hr_head"])
    default_zoomin = get_zoomin_params(cfg["eval_ritm"], cfg["eval_mode"],
                                       "demo")
    unset = object()

    def predictor_builder(brs_mode="NoBRS", prob_thresh=0.5,
                          zoomin_params=unset, predictor_params=None,
                          lbfgs_max_iters=20):
        return get_predictor(
            model, brs_mode=brs_mode, prob_thresh=prob_thresh,
            with_flip=True,
            zoom_in_params=(default_zoomin if zoomin_params is unset
                            else zoomin_params),
            predictor_params=predictor_params,
            lbfgs_params={"maxfun": lbfgs_max_iters}, device=device)

    predictor_builder.model = model
    predictor_builder.device = device
    predictor_builder.default_zoomin = default_zoomin
    return predictor_builder


def main(argv=None) -> int:
    # as the root demo.py, arguments without '=' are ignored
    argv = sys.argv[1:] if argv is None else argv
    cfg = parse_args([a for a in argv if "=" in a])
    builder = make_predictor_builder(cfg)
    from isegprobe_torch.interactive_demo.app import run_app

    run_app(builder, prob_thresh=cfg["thresh"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
