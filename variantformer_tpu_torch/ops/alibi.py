"""ALiBi slope schedule (Press et al., 2022).

A copy of ``variantformer_tpu/ops/alibi.py``: geometric slopes for
power-of-two head counts, with the interleaved fallback otherwise. The bias
applied in non-causal (bidirectional) attention is ``-slope * |i - j|`` with
positions taken within each unpadded sequence — identical under suffix padding.
"""

from __future__ import annotations

import math

import numpy as np


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes, shape [num_heads], float32."""

    def power_of_2_slopes(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = power_of_2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        extra = alibi_slopes(2 * closest)[0::2][: num_heads - closest]
        slopes = power_of_2_slopes(closest) + list(extra)
    return np.asarray(slopes, dtype=np.float32)
