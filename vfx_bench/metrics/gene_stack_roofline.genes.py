"""The gene stack's least time over the device time launched inside its
``seq2gene.gene_stack`` span, in percent."""

from vfx_bench.readers import span_roofline_pct


def read(run):
    return span_roofline_pct(run, "seq2gene.gene_stack", "gene_stack")
