"""The device trace of a window: ``torch.profiler`` with CUDA activity
only (kernels, copies and sets, timed by CUPTI; the host's operators
are not recorded, so the profiler adds little host work), beside the
harness's own spans, stamped on the host with ``time.time_ns`` (the
clock of the profiler's timeline).

Reduced to the device's busy seconds (the union of the intervals in
which a kernel, copy or set ran, within the ``window`` span), the
window's length, the device operations that took the most time and the
longest idle gaps, each named by the innermost harness span open when
the gap began.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Tracer", "reduce_events", "WINDOW"]

WINDOW = "window"
TOP = 10


def reduce_events(ops, spans):
    """``ops``: (name, start_ns, end_ns) of the device's operations;
    ``spans``: (name, start_ns, end_ns) of the harness's spans, one of
    them ``WINDOW``. Returns {"op_seconds" (by name), "busy_s",
    "window_s", "device_ops" (the top ten), "idle_gaps"}, or None without
    a window or a device operation in it."""
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    clipped, by_name = [], {}
    for n, s, e in ops:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            by_name[n] = by_name.get(n, 0) + (e - s)
    if not clipped:
        return None
    clipped.sort()
    merged = []
    for s, e in clipped:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [t for m in merged for t in m] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    inner = [(s, e, n) for n, s, e in spans if n != WINDOW]

    def name_at(t):
        best = None
        for s, e, n in inner:
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else WINDOW

    return {
        "op_seconds": {n: t / 1e9 for n, t in by_name.items()},
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": [[n[:80], t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
        "idle_gaps": [[name_at(s), (e - s) / 1e9] for s, e in gaps[:TOP]],
    }


class Tracer:
    """With ``on``: profiles the device over the block of a ``with`` and
    keeps the spans opened by ``span``; ``result`` then holds
    ``reduce_events``'s reduction. Off, it does nothing."""

    def __init__(self, on):
        self.on, self.spans, self.result, self.prof = on, [], None, None

    @contextlib.contextmanager
    def span(self, name):
        if not self.on:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))

    def __enter__(self):
        if self.on and torch.cuda.is_available():
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        self.prof.__exit__(*exc)
        if exc[0] is None:
            cpu = torch.autograd.DeviceType.CPU
            self.result = reduce_events(
                [(e.name(), e.start_ns(), e.end_ns())
                 for e in self.prof.profiler.kineto_results.events()
                 if e.device_type() != cpu and not e.is_user_annotation()],
                self.spans)
        self.prof = None
        return False
