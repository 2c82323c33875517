"""Sweep helpers of the port (``variantformer_tpu/api/sweeps.py``).

Only ``_bounded_map`` so far, which ``VariantProcessor.predict`` uses to run
its host sample builds on worker threads ahead of the device.
"""

from __future__ import annotations

from collections import deque


def _bounded_map(pool, fn, items, limit: int):
    """Yield fn(item) in order with at most ``limit`` builds in flight.

    Executor.map would submit every item up front, letting workers race
    arbitrarily far ahead of the device and pinning the whole work list's
    samples in host memory; this keeps a fixed window of futures instead."""
    pending: deque = deque()
    it = iter(items)

    def top_up():
        while len(pending) < limit:
            item = next(it, None)
            if item is None:
                return
            pending.append(pool.submit(fn, item))

    top_up()
    while pending:
        result = pending.popleft().result()
        top_up()
        yield result
