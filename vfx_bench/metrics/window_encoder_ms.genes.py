"""Device ms launched inside the port's ``seq2gene.window_encoder`` span
(both window sets, their pools) per traced gene."""

from vfx_bench.readers import span_device_ms


def read(run):
    return span_device_ms(run, "seq2gene.window_encoder", "trace_genes")
