"""Device milliseconds a loop step of the work launched inside the device
loop's ``loop.clicker`` span (kernel C's EDT, the click bookkeeping, the
ZoomIn ROI candidate), over the traced stretch's ``loop.step`` spans."""

from benchmark.lib import spans


def read(run):
    j = spans.device_join(run)
    steps = j.named("loop.step") if j is not None else []
    if not steps:
        return None
    return sum(j.device_under({"loop.clicker"}).values()) / 1e6 / len(steps)
