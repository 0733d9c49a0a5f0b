"""Median milliseconds of the predictor's ``get_prediction`` (crop, flip,
forward, paste, copy to the host) over the traced stretch's clicks, from
the span the benchmark's proxy records around each call."""

import numpy as np


def read(run):
    s = run.stretch
    if not s or not s["clicks"]:
        return None
    lo = s["first"]["clicks"]
    return 1e3 * float(np.median(run.result["predict_s"][lo:lo + s["clicks"]]))
