"""CUDA kernels that ran in the traced window (profiler trace) per query."""


def read(run):
    if run.trace is None or not run.counters.get("trace_calls"):
        return None
    return run.trace.kernels / run.counters["trace_calls"]
