"""The traced stretch of a run: ``torch.profiler`` over the device, reduced
to the device's busy time, the kernels by name and the idle gaps by what
the host was doing meanwhile."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _intervals(prof) -> Tuple[List, List]:
    """(device intervals, host op intervals) as (start_ns, end_ns, name)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if "CUDA" in str(e.device_type()):
            dev.append(span)
        else:
            host.append(span)
    return dev, host


WINDOW = "benchmark_traced_window"


def window():
    """The span a client wraps around its traced stretch (ended after a
    device synchronize)."""
    from torch.profiler import record_function

    return record_function(WINDOW)


def summarize(prof) -> Dict:
    """Busy seconds of the device inside the :func:`window` span (the union of
    its kernels and copies), the window's seconds, device seconds by
    kernel name and launch count, and the fifty longest idle gaps' seconds
    summed by the innermost host op that covers each gap's middle."""
    dev, host = _intervals(prof)
    t0_ns, t1_ns = next((a, b) for a, b, n in host if n == WINDOW)
    host = [h for h in host if h[2] != WINDOW]
    dev = [d for d in dev if d[2] != WINDOW]  # the span's device-side copy
    dev = sorted((max(a, t0_ns), min(b, t1_ns), n) for a, b, n in dev
                 if b > t0_ns and a < t1_ns)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    busy, cursor, gaps = 0, t0_ns, []
    for a, b, name in dev:
        by_name[name][0] += (b - a) / 1e9
        by_name[name][1] += 1
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if t1_ns > cursor:
        gaps.append((cursor, t1_ns))
    starts = np.array([h[0] for h in host], np.int64)
    ends = np.array([h[1] for h in host], np.int64)
    gap_by_host: Dict[str, float] = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
        mid = (g0 + g1) // 2
        cover = np.flatnonzero((starts <= mid) & (ends > mid))
        label = (host[cover[np.argmin(ends[cover] - starts[cover])]][2]
                 if cover.size else "host outside any op")
        gap_by_host[label] += (g1 - g0) / 1e9
    ops = sorted(([n, s] for n, (s, _) in by_name.items()),
                 key=lambda r: -r[1])
    return dict(busy_s=busy / 1e9, window_s=(t1_ns - t0_ns) / 1e9,
                kernels={n: dict(seconds=s, launches=c)
                         for n, (s, c) in by_name.items()},
                device_ops=ops[:10],
                idle_gaps=sorted(([n, s] for n, s in gap_by_host.items()),
                                 key=lambda r: -r[1])[:10])


def kernel_seconds(kernels: Dict, pattern: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``pattern``."""
    hits = [v for n, v in kernels.items() if pattern in n]
    return (sum(v["seconds"] for v in hits),
            sum(v["launches"] for v in hits))
