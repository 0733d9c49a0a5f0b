"""Share of the traced stretch in which the device idled while the host was
inside one of the device loop's ``loop.step`` spans (its launches, the
clicker's work, the read of the step's flag), from the program's spans
joined with the device trace (``lib/spans.py``)."""

from benchmark.lib import spans


def read(run):
    j = spans.device_join(run)
    if j is None or not j.named("loop.step"):
        return None
    return j.idle_share({"loop.step"})
