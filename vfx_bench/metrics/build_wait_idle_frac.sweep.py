"""The device's idle seconds while the sweep waits for its host builds
(``sweep.wait_build``), over the traced window."""

from vfx_bench.readers import span_idle_frac


def read(run):
    return span_idle_frac(run, "sweep.wait_build")
