"""Adam's least time (28 bytes a trained f32 value) over the device time
launched inside the ``train.optimizer`` span, in percent."""

from vfx_bench.readers import span_roofline_pct


def read(run):
    return span_roofline_pct(run, "train.optimizer", "optimizer")
