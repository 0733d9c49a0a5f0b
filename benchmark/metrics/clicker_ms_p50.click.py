"""Median milliseconds of a click outside ``get_prediction`` (the host
protocol: the clicker's EDT, the IoU, the loop), over the traced
stretch's clicks: each click's time less its prediction span."""

import numpy as np


def read(run):
    s = run.stretch
    if not s or not s["clicks"]:
        return None
    lo, hi = s["first"]["clicks"], s["first"]["clicks"] + s["clicks"]
    click = np.asarray(run.result["click_s"][lo:hi])
    predict = np.asarray(run.result["predict_s"][lo:hi])
    return 1e3 * float(np.median(click - predict))
