"""Tracing and per-stage timing.

``trace`` records a ``torch.profiler`` trace of the enclosed block (the
host's operators and, on CUDA, the device's kernels) and writes it as a
Chrome / Perfetto JSON; ``StageTimer`` sums host wall time per named
stage; ``ProgressMeter`` keeps a running average (the JAX package's
``utils/profiling.py``, the last two copied as they are).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

__all__ = ["trace", "StageTimer", "ProgressMeter"]


@contextlib.contextmanager
def trace(log_dir="torch-trace", enabled=True):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    where a card is present) and write ``<log_dir>/trace.json``, viewable
    in Perfetto or chrome://tracing."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")


class StageTimer:
    """Accumulates wall time per named stage; thread-safe enough for the
    single-producer pipeline loops."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "mean_ms": round(
                       1000 * self.totals[name] / max(self.counts[name], 1),
                       3)}
            for name in self.totals
        }

    def report(self):
        for name, s in sorted(self.summary().items()):
            print(f"{name:>24}: {s['total_s']:8.2f}s total, "
                  f"{s['mean_ms']:8.2f}ms/call x{s['count']}")


class ProgressMeter:
    """Running average + latest value printer (reference train.py:571-608
    ProgressAverageMeter/ProgressMeter equivalents)."""

    def __init__(self, name, fmt=":.3f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def __str__(self):
        return (f"{self.name} {format(self.val, self.fmt.strip(':'))} "
                f"({format(self.avg, self.fmt.strip(':'))})")
