"""The model's FLOPs of the counted clicks (a click: one forward of the
crop and one of its flip; FLOPs of the reference forward by
``FlopCounterMode``) over the traced stretch and the card's published
dense peak for the configuration's dtype."""

from benchmark.lib import roofline


def read(run):
    s = run.stretch
    if not s or not s["clicks"]:
        return None
    flops = s["clicks"] * 2 * run.forward_flops()
    return 100.0 * flops / s["seconds"] / roofline.PEAK_OPS[
        run.config["dtype"]]
