"""The least time of the traced work (flops.least_time) over the summed
device busy time, in percent: how far the kernels, and the plain PyTorch
operations beside them, sit from their roofline."""

from vfx_bench.readers import roofline_pct as read  # noqa: F401
