"""Spans of host work, counters, and the operator's trace exporter.

``span(name)`` marks a region of host work and ``count(name, n)`` adds
to a named counter. Both do nothing unless ``recording()`` is open: off,
``span`` checks one module flag and returns a shared no-op object,
reading no clock and allocating nothing. On, each span keeps its name,
its thread's id and name, its start and end on ``time.time_ns`` (the
clock on which ``torch.profiler`` places the device's events), the
thread's CPU time inside it (``time.thread_time_ns``), the enclosing span
of its thread and the ``run_inference3d`` call it belongs to. Spans stay
in memory; nothing is written while recording.

``trace`` records a ``torch.profiler`` trace of the enclosed block (the
host's operators and, on CUDA, the device's kernels) with the spans
recorded beside it, and writes both as JSON.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

__all__ = ["span", "count", "recording", "new_call", "current_call",
           "Span", "Recording", "trace"]

# the one switch: read by every span() and count(), set by recording()
_on = False
_rec = None
_local = threading.local()
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)


class Span(NamedTuple):
    """One closed span. Times are integer nanoseconds: ``start_ns`` and
    ``end_ns`` on ``time.time_ns``, ``cpu_ns`` the thread's CPU time
    between them. ``parent`` is the ``id`` of the span open around it on
    the same thread; ``call`` the ``run_inference3d`` call's id."""

    id: int
    name: str
    thread: int
    thread_name: str
    start_ns: int
    end_ns: int
    cpu_ns: int
    parent: int | None
    call: int | None


class Recording(list):
    """The spans of one ``recording()``, in the order they closed, and
    its ``counters`` ({name: total})."""

    def __init__(self):
        super().__init__()
        self.counters = {}
        self._lock = threading.Lock()

    def summary(self):
        """{name: {"total_s", "count"}} over the recorded spans."""
        out = {}
        for s in self:
            entry = out.setdefault(s.name, {"total_s": 0.0, "count": 0})
            entry["total_s"] += (s.end_ns - s.start_ns) / 1e9
            entry["count"] += 1
        return out


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("rec", "name", "call", "id", "parent", "start", "cpu")

    def __init__(self, rec, name, call):
        self.rec, self.name, self.call = rec, name, call

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        self.parent = parent.id if parent is not None else None
        if self.call is None and parent is not None:
            self.call = parent.call
        stack.append(self)
        self.start = time.time_ns()
        self.cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        cpu = time.thread_time_ns() - self.cpu
        end = time.time_ns()
        _stack().pop()
        thread = threading.current_thread()
        self.rec.append(Span(self.id, self.name, thread.ident, thread.name,
                             self.start, end, cpu, self.parent, self.call))
        return False


def span(name, call=None):
    """A context manager around host work named ``name``. ``call``: the
    ``run_inference3d`` call's id (``new_call``); None takes the
    enclosing span's on this thread."""
    if not _on:
        return _OFF
    return _Open(_rec, name, call)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while recording."""
    if not _on:
        return
    rec = _rec
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def new_call():
    """A fresh call id while recording, else None."""
    return next(_call_ids) if _on else None


def current_call():
    """The call id of this thread's innermost open span, else None. An
    object or closure that serves a call on another thread takes it
    where it is made."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].call if stack else None


@contextlib.contextmanager
def recording():
    """Record spans and counters over the block; yields the
    ``Recording``. Nested, it yields the open one."""
    global _on, _rec
    if _on:
        yield _rec
        return
    _rec = Recording()
    _on = True
    try:
        yield _rec
    finally:
        _on = False
        _rec = None


@contextlib.contextmanager
def trace(log_dir="torch-trace", enabled=True):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    where a card is present) while recording spans; write
    ``<log_dir>/trace.json``, viewable in Perfetto or chrome://tracing,
    and beside it ``spans.json``: the spans (``Span``'s fields, times in
    epoch nanoseconds of ``time.time_ns``) and the counters."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording() as spans, profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"clock": "time.time_ns",
                   "spans": [s._asdict() for s in spans],
                   "counters": spans.counters}, f)
    print(f"profile written to {path}")
