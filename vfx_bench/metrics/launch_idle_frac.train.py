"""The device's idle seconds while a train step (``train.step``) is open
on the call thread, over the traced window."""

from vfx_bench.readers import span_idle_frac


def read(run):
    return span_idle_frac(run, "train.step")
