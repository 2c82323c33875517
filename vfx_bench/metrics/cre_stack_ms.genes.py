"""Device ms launched inside the port's ``seq2gene.cre_stack`` span per
traced gene."""

from vfx_bench.readers import span_device_ms


def read(run):
    return span_device_ms(run, "seq2gene.cre_stack", "trace_genes")
