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


def _spans(run, span: str):
    """The traced run's ``spans.Spans`` where the trace holds device work and
    ``span`` opened in it, else None."""
    spans = None if run.trace is None else run.trace.spans
    if spans is None or not spans.device_total_s or not spans.count.get(span):
        return None
    return spans


def span_device_ms(run, span: str, per: str) -> float | None:
    """Device ms launched inside ``span`` over the counter ``per`` (traced
    genes or steps)."""
    spans = _spans(run, span)
    if spans is None or not run.counters.get(per):
        return None
    return 1e3 * spans.device_s.get(span, 0.0) / run.counters[per]


def span_roofline_pct(run, span: str, stage: str) -> float | None:
    """The traced work's least time in ``stage`` (``flops.least_counters``)
    over the device seconds launched inside ``span``, in percent."""
    spans = _spans(run, span)
    least = run.counters.get(f"trace_least_s.{stage}")
    if spans is None or not spans.device_s.get(span) or least is None:
        return None
    return 100.0 * least / spans.device_s[span]


def span_idle_frac(run, span: str) -> float | None:
    """Device-idle seconds while the call thread has ``span`` open, over the
    traced window."""
    spans = _spans(run, span)
    if spans is None or span not in spans.idle_s or not run.trace.window_s:
        return None
    return spans.idle_s[span] / run.trace.window_s
