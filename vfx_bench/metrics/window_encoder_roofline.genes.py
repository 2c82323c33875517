"""The window encoder's least time over the device time launched inside
its ``seq2gene.window_encoder`` span, in percent."""

from vfx_bench.readers import span_roofline_pct


def read(run):
    return span_roofline_pct(run, "seq2gene.window_encoder", "window_encoder")
