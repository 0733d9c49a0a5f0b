"""The measured window of a run, and its traced stretch.

A client calls :meth:`Window.tick` after each unit of work (a batch, a
click) and stops when it returns True. In a ``--trace 1`` run the first
``trace_seconds`` of the window run under ``torch.profiler``; the profiler
stops at the first tick past that, and the program's counters are taken
at both ends of the stretch, so the per-layer metrics read the stretch the
trace covers.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from benchmark.lib import trace


class Window:
    def __init__(self, seconds: float, trace_seconds: Optional[float],
                 counters: Callable[[], Dict], device) -> None:
        self.seconds = seconds
        self.trace_seconds = trace_seconds
        self.counters = counters
        self.device = device
        self.prof = self.span = None
        self.stretch: Optional[Dict] = None
        self.elapsed = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> "Window":
        self._sync()
        if self.trace_seconds is not None:
            self.prof = trace.start()
            self.span = trace.window()
            self.span.__enter__()
            self._c0 = self.counters()
        self.t0 = time.perf_counter()
        return self

    def _end_stretch(self) -> None:
        self._sync()
        now = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.span = None
        self._c1 = c1 = self.counters()
        self.stretch = {k: c1[k] - self._c0[k] for k in c1}
        self.stretch["first"] = self._c0
        self.stretch["seconds"] = now
        self.prof.stop()

    def tick(self) -> bool:
        """True once the window is over."""
        self.elapsed = time.perf_counter() - self.t0
        if self.span is not None and self.elapsed >= self.trace_seconds:
            self._end_stretch()
        return self.elapsed >= self.seconds

    def finish(self) -> float:
        self._sync()
        self.elapsed = time.perf_counter() - self.t0
        if self.span is not None:
            self._end_stretch()
        self.counters = None  # let the program's state go with the client's
        return self.elapsed
