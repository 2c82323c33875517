"""Stage timing, program spans and device traces.

The port's copy of ``variantformer_tpu/utils/profiling.py``: ``StageTimer``
accounts wall-clock per named stage of the host pipeline (build, pack,
dispatch, device sync), and ``device_trace`` records a ``torch.profiler``
trace (CPU and, where there is a card, CUDA activities) of a block into a
Chrome-trace JSON file under ``log_dir``. ``span(name)`` marks a stage of
the program in any profiler's trace, on the clock of its device activity;
with no profiler running it costs one flag check.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

log = logging.getLogger(__name__)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else a shared no-op context. Read the flag at each call: a profiler
    may start or stop between two spans. An exported graph holds no span:
    with no profiler running none is opened, and ``torch.export`` drops a
    ``record_function`` range opened under one."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class StageTimer:
    """Accumulates wall-clock per named stage. Stages may be timed from
    several threads (the sweeps' host builds run on a pool). With a
    ``prefix``, each stage is also the span ``<prefix>.<stage>``."""

    def __init__(self, prefix: str | None = None):
        self.prefix = prefix
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"{self.prefix}.{name}") if self.prefix else _OFF:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in sorted(self.totals)
        }

    def log_summary(self, prefix: str = "stage timing"):
        for name, stats in self.summary().items():
            log.info("%s: %-18s %8.1f ms total  (%d calls, %.2f ms/call)",
                     prefix, name, stats["total_s"] * 1e3, stats["count"],
                     stats["mean_ms"])


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace around a block; yields the profiler. When the
    block exits (the card synchronised first), the trace is written as
    ``trace_<pid>_<ns>.json`` under ``log_dir`` (Chrome trace format:
    ``chrome://tracing`` or Perfetto); its path is ``prof.trace_file``.
    Every thread is recorded, so the spans of a sweep's build pool appear
    beside the main thread's."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_file = str(out / f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_file)
