"""Share of the traced stretch in which the device idled while the host
was inside the host protocol's own work: the ``clicker``, ``iou`` and
``predictor.roi`` spans (the EDT, the IoU and the ZoomIn ROI machine in
numpy on the full frame)."""

from benchmark.lib import spans


def read(run):
    j = spans.device_join(run)
    if j is None or not j.named("clicker"):
        return None
    return j.idle_share({"clicker", "iou", "predictor.roi"})
