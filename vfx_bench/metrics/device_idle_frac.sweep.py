"""The device's idle share of the traced window, from the profiler's trace."""

from vfx_bench.readers import idle_frac as read  # noqa: F401
