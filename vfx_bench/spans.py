"""The program's spans in a traced window: device and idle seconds inside each.

The port marks its stages as ``record_function`` ranges (``seq2gene.*``,
``sweep.*``, ``train.*``, ``fit.*``; ``utils/profiling.span``), which the
profiler's Chrome trace holds as ``user_annotation`` events on the thread
that opened them, on the clock of the device activity. ``reduce_spans``
joins each device event (kernel, copy, set) to its launch record (a CUDA
runtime or driver call of the same correlation id) and gives it the stack
of program spans open on the launching thread at the launch; where that
thread has none open (autograd's device thread runs the backward's
launches), the stack open on the call thread at that moment, the thread
of the harness's ``vfx_bench.<call>`` spans. Then:

* device seconds inside a span: the summed durations of the device events
  whose stack holds it;
* idle seconds inside a span: the device-idle time (outside the union of
  device intervals that ``trace.reduce_events`` counts as busy) while the
  call thread has the span open;
* unattributed device seconds: device events with no launch record or an
  empty stack.

The readers of the per-layer metrics (``readers.py``) take their numbers
from a traced run's ``trace.Trace.spans``; ``shares`` gives the
attribution's own shares, which the harness prints beside its counters.
``python3 -m vfx_bench.spans`` with ``vfx_bench.run``'s arguments is a
traced run of ``vfx_bench.run``, whose result line carries the span metrics.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from vfx_bench.trace import DEVICE_CATS, _union

PROGRAM = ("seq2gene.", "sweep.", "scan.", "train.", "fit.")
CALL = "vfx_bench."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Spans:
    device_s: dict            # span -> device seconds of events launched inside it
    idle_s: dict              # span -> device-idle seconds while the call thread has it open
    count: dict               # span -> occurrences on every thread
    device_total_s: float     # summed durations of every device event
    kernel_s: float           # summed durations of the kernels
    kernel_launched_s: float  # ... of those that have a launch record
    unattributed_s: float     # device seconds with no launch record or an empty stack


class _Stacks:
    """The program spans open on one thread, as a step function of time."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        edges = sorted([(a, 1, n) for a, _, n in spans] + [(b, -1, n) for _, b, n in spans],
                       key=lambda e: (e[0], e[1]))
        self.times: list[float] = []
        self.stacks: list[tuple] = []
        open_: dict[str, int] = defaultdict(int)
        for t, d, n in edges:
            open_[n] += d
            if self.times and self.times[-1] == t:
                self.times.pop()
                self.stacks.pop()
            self.times.append(t)
            self.stacks.append(tuple(k for k, v in open_.items() if v > 0))

    def at(self, ts: float) -> tuple:
        i = bisect.bisect_right(self.times, ts) - 1
        return self.stacks[i] if i >= 0 else ()


def _overlap(merged: list[tuple[float, float]], starts: list[float], a: float, b: float) -> float:
    """Length of [a, b] inside the sorted disjoint intervals ``merged``."""
    total = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(merged) and merged[i][0] < b:
        total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return total


def reduce_spans(events: list[dict]) -> Spans:
    """A Chrome trace's events -> ``Spans`` (times in us there, seconds here)."""
    launches: dict = {}
    device, program = [], defaultdict(list)
    calls: dict = defaultdict(int)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, dur, cat, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ev.get("tid"), ts)
        elif cat == "user_annotation":
            if name.startswith(PROGRAM):
                program[ev.get("tid")].append((ts, ts + dur, name))
            elif name.startswith(CALL):
                calls[ev.get("tid")] += 1
    call_tid = max(calls, key=calls.get) if calls else None
    stacks = {tid: _Stacks(s) for tid, s in program.items()}
    none = _Stacks([])
    device_s: dict = defaultdict(float)
    total = kernel = launched = unattributed = 0.0
    for ts, dur, cat, corr in device:
        total += dur
        kernel += dur if cat == "kernel" else 0.0
        launch = launches.get(corr) if corr is not None else None
        if launch is None:
            unattributed += dur
            continue
        launched += dur if cat == "kernel" else 0.0
        tid, at = launch
        stack = stacks.get(tid, none).at(at)
        if not stack and tid != call_tid:
            stack = stacks.get(call_tid, none).at(at)
        if not stack:
            unattributed += dur
        for name in stack:
            device_s[name] += dur * 1e-6
    busy = _union([(ts, ts + dur) for ts, dur, _, _ in device])
    starts = [a for a, _ in busy]
    idle_s: dict = defaultdict(float)
    by_name: dict = defaultdict(list)
    for a, b, name in program.get(call_tid, []):
        by_name[name].append((a, b))
    for name, ivs in by_name.items():
        for a, b in _union(ivs):
            idle_s[name] += (b - a - _overlap(busy, starts, a, b)) * 1e-6
    count: dict = defaultdict(int)
    for spans in program.values():
        for _, _, name in spans:
            count[name] += 1
    return Spans(device_s=dict(device_s), idle_s=dict(idle_s), count=dict(count),
                 device_total_s=total * 1e-6, kernel_s=kernel * 1e-6,
                 kernel_launched_s=launched * 1e-6, unattributed_s=unattributed * 1e-6)


FORWARD_STAGES = ("seq2gene.window_encoder", "seq2gene.maps", "seq2gene.cre_stack",
                  "seq2gene.gene_stack", "seq2gene.heads")


def shares(spans: Spans) -> dict:
    """How much the attribution reaches: the five stages' device seconds
    over the forward's, the kernels' seconds with a launch record over all
    kernel seconds, and the device seconds with no span over all (None
    where there is nothing to divide by)."""
    fwd = spans.device_s.get("seq2gene.forward", 0.0)
    return {
        "stage_share_of_forward": (sum(spans.device_s.get(s, 0.0) for s in FORWARD_STAGES) / fwd
                                   if fwd else None),
        "kernel_launched_share": (spans.kernel_launched_s / spans.kernel_s
                                  if spans.kernel_s else None),
        "unattributed_share": (spans.unattributed_s / spans.device_total_s
                               if spans.device_total_s else None),
    }


if __name__ == "__main__":
    import sys

    from vfx_bench import run

    sys.exit(run.main([*sys.argv[1:], "--trace", "1"]))
