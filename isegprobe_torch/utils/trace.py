"""Spans at the port's layer boundaries, recorded while a ``torch.profiler``
records in the process.

    from isegprobe_torch.utils import trace

    with trace.span("predictor.forward"):
        ...

A span records nothing unless ``torch.profiler`` is recording (one check
of the autograd profiler's flag a span, ~80 ns on a CPU): there is no
other switch. Off, :func:`span` returns one shared no-op context and takes
no clock reading. On, each span appends one record to a bounded ring in
memory when it ends::

    (serial, name, rid, parent serial or None, thread, start_ns, end_ns)

``rid``, a request id, is the one given to the span, else its parent's:
a root span (a click, a dataset call) names its request and every span
below it carries that id. ``thread`` is ``threading.get_native_id()``, the
id the profiler's host events carry as ``device_resource_id()``. Times are
``time.time_ns()``, the clock of the profiler's host events, so a reader
joins the ring with a trace by time: :func:`spans` cuts the ring to the
window a profiler covered (the program cannot see when one starts).

The spans are not ``record_function`` ranges: the profiler copies such a
range onto the device's timeline, where it would read as device time.
They add no device work, host read or synchronisation.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Hashable, List, Optional, Tuple

import torch

__all__ = ["span", "spans"]

Record = Tuple[int, str, Hashable, Optional[int], int, int, int]

RING_SIZE = 1 << 18
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_serial = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "rid", "serial", "parent", "stack", "t0")

    def __init__(self, name: str, rid: Hashable) -> None:
        self.name, self.rid = name, rid

    def __enter__(self) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent, inherited = stack[-1] if stack else (None, None)
        if self.rid is None:
            self.rid = inherited
        self.serial = next(_serial)
        self.stack = stack
        stack.append((self.serial, self.rid))
        self.t0 = time.time_ns()

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        self.stack.pop()
        _ring.append((self.serial, self.name, self.rid, self.parent,
                      threading.get_native_id(), self.t0, t1))


def span(name: str, rid: Hashable = None):
    """A context that records ``name`` from entry to exit while a
    ``torch.profiler`` records; ``rid`` names the request (default: the
    enclosing span's)."""
    if not _recording():
        return _OFF
    return _Span(name, rid)


def spans(t0_ns: int, t1_ns: int) -> List[Record]:
    """The ring's records that overlap ``[t0_ns, t1_ns]``, oldest end
    first."""
    return [r for r in list(_ring) if r[6] >= t0_ns and r[5] <= t1_ns]
