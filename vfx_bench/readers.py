"""Arithmetic the per-layer metric readers share (``metrics/<name>.py``).

Each returns None where its run has nothing to read, and the harness then
leaves the metric out of the line."""

from __future__ import annotations

from vfx_bench.flops import PEAKS


def mfu_pct(run) -> float | None:
    """Model matmul FLOPs of the work completed in the window over the
    window's seconds times the bf16 dense peak, in percent."""
    c = run.counters
    if not c.get("window_s") or "flops" not in c:
        return None
    return 100.0 * c["flops"] / (c["window_s"] * PEAKS["bf16_flops"])


def roofline_pct(run) -> float | None:
    """The traced work's least time over the device's busy time, in percent."""
    if run.trace is None or not run.trace.busy_s or "trace_least_s" not in run.counters:
        return None
    return 100.0 * run.counters["trace_least_s"] / run.trace.busy_s


def idle_frac(run) -> float | None:
    """1 - the union of device intervals over the traced window."""
    if run.trace is None or not run.trace.window_s:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
