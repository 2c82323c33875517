"""The device's idle seconds while a forward (``seq2gene.forward``) is
open on the call thread, over the traced window: the host's launches."""

from vfx_bench.readers import span_idle_frac


def read(run):
    return span_idle_frac(run, "seq2gene.forward")
