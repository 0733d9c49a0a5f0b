"""``lib/spans.py``'s join of the program's spans with the device trace, on
synthetic event lists, and the six span readers on each cell's traced run
at a tiny size on the CPU, where only the host span reader has something to
read."""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark.lib import spans
from benchmark.lib.spans import OUTSIDE, Event, Join, Span

HOST = 7  # the launching thread


def kernel(a, b, corr):
    return Event(a, b, "k", True, False, corr, 0)


def launch(t, corr, tid=HOST):
    return Event(t, t + 1, "cudaLaunchKernel", False, True, corr, tid)


def span(serial, name, a, b, parent=None, rid=None, tid=HOST):
    return Span(serial, name, rid, parent, tid, a, b)


# a step (10..60) holding a clicker (12..20) and a forward (25..50), a batch
# span (0..100) around it; the stretch runs from 0 to 100
SPANS = [span(1, "loop.dataset", 0, 100, rid=0),
         span(2, "loop.step", 10, 60, 1, rid=5),
         span(3, "loop.clicker", 12, 20, 2, rid=5),
         span(4, "loop.forward", 25, 50, 2, rid=5)]


def test_join_puts_launches_in_the_innermost_span():
    evs = [launch(13, 1), kernel(14, 18, 1),    # clicker
           launch(26, 2), kernel(30, 45, 2),    # forward
           launch(21, 3), kernel(46, 48, 3),    # the step itself
           launch(70, 4), kernel(72, 80, 4),    # the batch span
           launch(95, 5, tid=99), kernel(96, 98, 5),  # another thread
           kernel(85, 86, 6)]                   # no launch record
    j = Join(evs, SPANS, 0, 100)
    assert j.device_ns == {3: 4, 4: 15, 2: 2, 1: 8, OUTSIDE: 2}
    assert j.device_total == 32 and j.unlinked == 1
    assert j.device_under({"loop.clicker"}) == {5: 4}
    assert j.device_under({"loop.step"}) == {5: 21}
    assert j.device_under({"loop.dataset"}) == {5: 21, 0: 8}
    d = j.diagnostics()
    assert d["linked_pct"] == pytest.approx(100 * 31 / 32)


def test_join_outside_every_span():
    """A launch before the first span and one after the last count outside
    the program, and so does the idle there."""
    evs = [launch(1, 1), kernel(2, 4, 1), launch(105, 2), kernel(106, 110, 2)]
    j = Join(evs, [span(1, "click", 10, 100, rid=(0, 0))], 0, 120)
    assert j.device_ns == {OUTSIDE: 6}
    assert j.idle_total == 120 - 6
    assert j.idle_ns == {OUTSIDE: 2 + 6 + 6 + 10, 1: 90}


def test_join_cuts_idle_at_span_boundaries():
    """The device idles from 0 to 14 (10 ns in the batch span, 2 in the
    step, 2 in the clicker), from 18 to 30 (2 in the clicker, 5 in the step
    between its children, 5 in the forward) and from 45 to 100 (5 in the
    forward, 10 in the step, 40 in the batch span)."""
    evs = [launch(13, 1), kernel(14, 18, 1), launch(26, 2),
           kernel(30, 45, 2)]
    j = Join(evs, SPANS, 0, 100)
    assert j.idle_total == 100 - 19
    assert j.idle_ns == {1: 10 + 40, 2: 2 + 5 + 10, 3: 2 + 2, 4: 5 + 5}
    assert j.idle_share({"loop.step"}) == pytest.approx(17 + 4 + 10)
    assert j.idle_share({"loop.dataset"}, {"loop.step"}) == 50
    assert (j.idle_share({"loop.step"})
            + j.idle_share({"loop.dataset"}, {"loop.step"})
            + j.diagnostics()["idle_outside_pct"]
            == pytest.approx(j.diagnostics()["idle_pct"]))


def test_join_overlapping_kernels_and_the_window():
    """Kernels that overlap are busy once; a kernel that straddles the
    stretch's edge counts its part inside."""
    evs = [launch(5, 1), kernel(-10, 20, 1), launch(6, 2),
           kernel(15, 30, 2)]
    j = Join(evs, [span(1, "loop.step", 0, 100)], 0, 100)
    assert j.device_total == 20 + 15
    assert j.idle_total == 70 and j.idle_ns == {1: 70}


NEW = {"step_idle_pct.eval", "batch_idle_pct.eval", "clicker_device_ms.eval",
       "clicker_span_ms_p50.click", "protocol_idle_pct.click",
       "upsampler_device_ms_p50.click"}


@pytest.mark.parametrize("workload", ["noup_eval_f32", "loftup_click_f32"])
def test_span_readers_on_the_cpu(tiny, workload):
    line, _ = bench_run.run_cell(workload, 2**31 + 11, 1.0, 1,
                                 device="cpu", require_cuda=False)
    got = NEW & set(line["metrics"])
    if workload == "loftup_click_f32":
        assert got == {"clicker_span_ms_p50.click"}
        assert line["metrics"]["clicker_span_ms_p50.click"]["value"] > 0
    else:
        assert got == set()


def test_no_recorder_no_join(monkeypatch):
    """A program without ``utils/trace.py`` (a checkout from before the
    recorder) gives no spans, so no join and no reading."""
    import builtins

    real = builtins.__import__

    def without(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "isegprobe_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", without)
    assert spans.program_spans(0, 2**62) == []
