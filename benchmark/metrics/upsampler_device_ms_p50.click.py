"""Median over the traced stretch's clicks of the device milliseconds
launched inside a click's ``model.upsampler`` spans (LoftUp: kernel D,
its convolutions and GEMMs, kernel B; the convhead fused into it)."""

from benchmark.lib import spans


def read(run):
    j = spans.device_join(run)
    if j is None:
        return None
    return spans.median_ms(j.device_under({"model.upsampler"}).values())
