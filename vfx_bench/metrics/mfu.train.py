"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s)."""

from vfx_bench.readers import mfu_pct as read  # noqa: F401
