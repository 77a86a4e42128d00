"""Spans: named intervals of the program's own work, on the host's clock and,
for ``device_span``, on the card's.

``span(name, key=None)`` is a context manager that records ``name``, its
start and end from ``time.perf_counter_ns()``, a ``key`` tying one
request's, tick's or step's spans together (a request id, a tick's time,
a step number) and the name of its parent: the span open on the same
thread, or ``parent=`` where the work runs on another thread (a pool
worker, autograd's device thread).  ``span(...).open()`` and ``.close()``
do the same across calls; ``.discard()`` drops a span that will not end.
``record`` stores a span from two stamps taken earlier (a request's wait in
a queue).  ``device_span(name, key=None, device=None)`` also records a
pair of CUDA timing events on ``device``'s current stream; their elapsed
time is read only when the spans are read, so a span never synchronises.
Off a CUDA device it times the host instead.

Each name has a ring of ``CAPACITY`` spans that drops its oldest and counts
what it dropped: one append a span, atomic in CPython, so the plane's pool
thread and autograd's threads record without a lock.  The ring always
records.  While a ``torch.profiler`` profile records
(``torch.autograd.profiler._is_profiler_enabled``), an open span is also a
host range of its own name on the profiler's timeline: the range
``record_function`` makes, without its user scope
(``torch._C._profiler._RecordFunctionFast``), since a user-scope range
also lays a ``gpu_user_annotation`` event over its kernels on the
device's timeline, which a trace's reader would count as the card's
work.  PyTorch records such ranges on the thread that started the
profiler and on autograd's threads, and on every thread under
``profile_all_threads``.  A span from ``record`` is never one.  Names are
short fixed strings with no index in them.

``spans(name)`` reads a ring, oldest first; ``reset()`` empties them all.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _host_range

CAPACITY = 1 << 17

now_ns = time.perf_counter_ns
_HOST = ()               # a device span timed on the host's clock


class _Ring:
    __slots__ = ("buf", "seq")

    def __init__(self):
        # entries: (sequence number, start ns, end ns, key, parent, events)
        self.buf = collections.deque(maxlen=CAPACITY)
        self.seq = itertools.count()


_rings: dict[str, _Ring] = {}
_rings_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack = []          # the thread's open spans, innermost last


_local = _Local()


def _ring(name: str) -> _Ring:
    r = _rings.get(name)
    if r is None:
        with _rings_lock:
            r = _rings.setdefault(name, _Ring())
    return r


def record(name: str, start_ns: int, end_ns: int, key=None, parent=None,
           events=None):
    """Store a span of ``name`` from stamps of ``now_ns()``."""
    r = _rings.get(name) or _ring(name)
    r.buf.append((next(r.seq), start_ns, end_ns, key, parent, events))


class span:
    """A span of ``name``; ``parent`` None takes the innermost span open on
    the opening thread."""
    __slots__ = ("name", "key", "parent", "start_ns", "_rf", "_stack")

    def __init__(self, name: str, key=None, parent: str | None = None):
        self.name, self.key, self.parent = name, key, parent

    def __enter__(self):
        stack = self._stack = _local.stack
        if self.parent is None and stack:
            self.parent = stack[-1].name
        stack.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _host_range(self.name)
            self._rf.__enter__()
        self.start_ns = now_ns()
        return self

    open = __enter__

    def __exit__(self, *exc):
        record(self.name, self.start_ns, now_ns(), self.key, self.parent,
               self._events())
        self.discard()

    def close(self):
        self.__exit__()

    def discard(self):
        """Leave the span without recording it."""
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)

    def _events(self):
        return None


class device_span(span):
    """A span that also times the card between two CUDA events recorded on
    the current stream of ``device`` (the host's clock off CUDA)."""
    __slots__ = ("_cuda", "_ev0")

    def __init__(self, name: str, key=None, parent: str | None = None,
                 device=None):
        super().__init__(name, key, parent)
        dev = None if device is None else torch.device(device)
        self._cuda = (dev if dev is not None and dev.type == "cuda"
                      and torch.cuda.is_available() else None)

    def __enter__(self):
        self._ev0 = None
        if self._cuda is not None:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(torch.cuda.current_stream(self._cuda))
        return super().__enter__()

    open = __enter__

    def _events(self):
        if self._ev0 is None:
            return _HOST
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record(torch.cuda.current_stream(self._cuda))
        return self._ev0, ev1


class Spans(NamedTuple):
    """A ring's spans, oldest first: ``start`` and ``end`` in seconds on the
    ``time.perf_counter`` clock, ``key`` (NaN where none was given),
    ``parent`` names, ``device_ms`` (a device span's card time, or its host
    time where it ran off CUDA; NaN for host spans) and the number of
    spans the ring ``dropped``."""
    start: np.ndarray
    end: np.ndarray
    key: np.ndarray
    parent: list
    device_ms: np.ndarray
    dropped: int


def _device_ms(start_ns: int, end_ns: int, events) -> float:
    if events is None:
        return float("nan")
    if events is _HOST:
        return (end_ns - start_ns) / 1e6
    ev0, ev1 = events
    ev1.synchronize()
    return ev0.elapsed_time(ev1)


def spans(name: str) -> Spans:
    r = _rings.get(name)
    rows = list(r.buf) if r is not None else []
    start = np.array([e[1] for e in rows], np.float64) / 1e9
    end = np.array([e[2] for e in rows], np.float64) / 1e9
    key = np.array([np.nan if e[3] is None else e[3] for e in rows],
                   np.float64)
    dev = np.array([_device_ms(e[1], e[2], e[5]) for e in rows], np.float64)
    dropped = max(e[0] for e in rows) + 1 - len(rows) if rows else 0
    return Spans(start, end, key, [e[4] for e in rows], dev, dropped)


def reset():
    """Empty every ring (tests)."""
    with _rings_lock:
        _rings.clear()
