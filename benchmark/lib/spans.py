"""The program's own spans (``isegprobe_torch/utils/trace.py``) joined with a
traced stretch's ``torch.profiler`` events.

The program records its spans while a profiler records, on the clock of
the profiler's host events; this joins them with the stretch that
``lib/trace.py``'s window covers:

- device time by span: each kernel or copy follows its ``correlation_id()``
  to its launch record on the host, and goes to the innermost
  span that covers the launch on the launching thread ("outside the
  program" where none does, "no launch record" where there is none);
- idle time by span: each interval in which the device runs nothing
  (computed as ``trace.summarize`` computes it) is cut at span boundaries,
  and each piece goes to the innermost span the host was in (the thread
  with the most spans in the stretch: the one the click paths run on).

A program without the recorder (the module missing) or a stretch with no
span gives no join, and every reader then gives nothing.
"""

from __future__ import annotations

import bisect
import statistics
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from benchmark.lib.trace import WINDOW

OUTSIDE = -1  # the label of time in no span


class Event(NamedTuple):
    """One profiler event: ``device`` for a kernel or copy, ``launch`` for
    its launch record on the host, a CUDA API call (``tid`` its native
    thread id)."""
    start: int
    end: int
    name: str
    device: bool
    launch: bool
    correlation: int
    tid: int


class Span(NamedTuple):
    serial: int
    name: str
    rid: object
    parent: Optional[int]
    tid: int
    start: int
    end: int


def events(prof) -> List[Event]:
    """The kineto events the join reads, as :class:`Event`: the device's,
    the launch records and the window's host span. A launch record is a
    host event of a CUDA API call (``cuda*``, ``cu*``), whose correlation
    id is its device activity's (the torch ops' ids are of another
    space)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        device = "CUDA" in str(e.device_type())
        launch = not device and name.startswith("cu")
        if device or launch or name == WINDOW:
            start = e.start_ns()
            out.append(Event(start, start + e.duration_ns(), name, device,
                             launch, e.correlation_id(),
                             e.device_resource_id()))
    return out


def program_spans(t0_ns: int, t1_ns: int) -> List[Span]:
    """The program's spans overlapping the stretch; none where the program
    has no recorder."""
    try:
        from isegprobe_torch.utils import trace
    except ImportError:
        return []
    return [Span(*r) for r in trace.spans(t0_ns, t1_ns)]


def _segments(spans: Iterable[Span]) -> Tuple[List[int], List[int]]:
    """One thread's nested spans as a partition of time: from
    ``bounds[i]`` to ``bounds[i + 1]`` the innermost span is
    ``labels[i]`` (a serial, or ``OUTSIDE``)."""
    bounds: List[int] = []
    labels: List[int] = []
    stack: List[Tuple[int, int]] = []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            bounds.append(end)
            labels.append(stack[-1][1] if stack else OUTSIDE)

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        close_until(s.start)
        bounds.append(s.start)
        labels.append(s.serial)
        stack.append((s.end, s.serial))
    close_until(float("inf"))
    return bounds, labels


def _label_at(seg, t: int) -> int:
    bounds, labels = seg
    i = bisect.bisect_right(bounds, t) - 1
    return labels[i] if i >= 0 else OUTSIDE


class Join:
    """Device and idle nanoseconds of a stretch by innermost span."""

    def __init__(self, evs: List[Event], spans: List[Span], t0: int,
                 t1: int) -> None:
        self.t0, self.t1 = t0, t1
        self.spans = {s.serial: s for s in spans}
        by_thread: Dict[int, List[Span]] = defaultdict(list)
        for s in spans:
            by_thread[s.tid].append(s)
        segs = {tid: _segments(ss) for tid, ss in by_thread.items()}
        host = max(by_thread, key=lambda t: len(by_thread[t]))
        launches = {e.correlation: e for e in evs if e.launch}

        dev = sorted((max(e.start, t0), min(e.end, t1), e.correlation)
                     for e in evs if e.device and e.name != WINDOW
                     and e.end > t0 and e.start < t1)
        self.device_ns: Dict[int, int] = Counter()
        self.device_total = self.unlinked = 0
        busy_until, gaps = t0, []
        for a, b, corr in dev:
            self.device_total += b - a
            launch = launches.get(corr)
            if launch is None:
                self.unlinked += b - a
            else:
                seg = segs.get(launch.tid)
                label = _label_at(seg, launch.start) if seg else OUTSIDE
                self.device_ns[label] += b - a
            if a > busy_until:
                gaps.append((busy_until, a))
            busy_until = max(busy_until, b)
        if t1 > busy_until:
            gaps.append((busy_until, t1))

        self.idle_ns: Dict[int, int] = Counter()
        bounds, labels = segs[host]
        for g0, g1 in gaps:
            i = bisect.bisect_right(bounds, g0) - 1
            cursor = g0
            while cursor < g1:
                nxt = bounds[i + 1] if i + 1 < len(bounds) else g1
                end = min(nxt, g1)
                self.idle_ns[labels[i] if i >= 0 else OUTSIDE] += end - cursor
                cursor, i = end, i + 1
        self.idle_total = sum(b - a for a, b in gaps)

    def under(self, serial: int, names) -> bool:
        """Whether span ``serial`` or one of its ancestors is named in
        ``names``."""
        s = self.spans.get(serial)
        while s is not None:
            if s.name in names:
                return True
            s = self.spans.get(s.parent)
        return False

    def device_under(self, names) -> Dict[object, int]:
        """Device nanoseconds launched under spans named in ``names``, by
        request id."""
        out: Dict[object, int] = Counter()
        for serial, ns in self.device_ns.items():
            if self.under(serial, names):
                out[self.spans[serial].rid] += ns
        return out

    def idle_share(self, inside, outside=()) -> float:
        """Percent of the stretch the device idled while the host's
        innermost span lay under ``inside`` and not under ``outside``."""
        ns = sum(v for serial, v in self.idle_ns.items()
                 if self.under(serial, inside)
                 and not self.under(serial, outside))
        return 100.0 * ns / (self.t1 - self.t0)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans.values() if s.name == name]

    def diagnostics(self) -> Dict[str, float]:
        """The join's own checks: the share of device time that found its
        launch record, and the idle outside every span."""
        window = self.t1 - self.t0
        return dict(
            linked_pct=100.0 * (1 - self.unlinked / self.device_total)
            if self.device_total else None,
            idle_pct=100.0 * self.idle_total / window,
            idle_outside_pct=100.0 * self.idle_ns.get(OUTSIDE, 0) / window,
            device_outside_pct=100.0 * self.device_ns.get(OUTSIDE, 0)
            / self.device_total if self.device_total else None)


def join(run) -> Optional[Join]:
    """The join of a traced run (``run.result["window"].prof``), made once
    a run; None without a profile or without spans in its stretch."""
    if "spans_join" not in vars(run):
        run.spans_join = None
        prof = run.result["window"].prof
        if prof is not None:
            evs = events(prof)
            t0, t1 = next((e.start, e.end) for e in evs
                          if e.name == WINDOW and not e.device)
            spans = program_spans(t0, t1)
            if spans:
                run.spans_join = Join(evs, spans, t0, t1)
    return run.spans_join


def device_join(run) -> Optional[Join]:
    """:func:`join` where the stretch ran something on the device."""
    j = join(run)
    return j if j is not None and j.device_total > 0 else None


def median_ms(values_ns) -> Optional[float]:
    values = list(values_ns)
    return statistics.median(values) / 1e6 if values else None
