"""Device ms launched inside the port's ``train.optimizer`` span (the Adam
update) per traced step."""

from vfx_bench.readers import span_device_ms


def read(run):
    return span_device_ms(run, "train.optimizer", "trace_calls")
