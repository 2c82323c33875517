"""Device ms launched inside the port's ``seq2gene.gene_stack`` span per
traced gene."""

from vfx_bench.readers import span_device_ms


def read(run):
    return span_device_ms(run, "seq2gene.gene_stack", "trace_genes")
