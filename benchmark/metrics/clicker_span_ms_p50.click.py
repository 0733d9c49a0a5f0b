"""Median milliseconds of the program's ``clicker`` span (the host
clicker's ``make_next_click``: the EDT of the error on the full frame)
over the traced stretch's clicks."""

from benchmark.lib import spans


def read(run):
    j = spans.join(run)
    if j is None:
        return None
    return spans.median_ms(s.end - s.start for s in j.named("clicker"))
