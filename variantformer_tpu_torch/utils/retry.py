"""Retry with exponential backoff.

The port's copy of ``retry_with_backoff`` and the ``multi_try_load_*`` readers from
``variantformer_tpu/utils/retry.py``: shared-filesystem and object-store
reads can fail transiently under concurrent runs, so fetches retry with
exponential backoff up to a wall-clock ceiling instead of killing a long run.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")

# Errors that no amount of retrying fixes: environment/programming problems,
# not transient store/filesystem glitches. Raised immediately.
PERMANENT_ERRORS = (
    ImportError, TypeError, AttributeError, NameError, KeyboardInterrupt,
)


def retry_with_backoff(
    fn: Callable[[], T],
    *,
    timeout: float = 600.0,
    initial_delay: float = 0.1,
    max_delay: float = 60.0,
    exceptions: tuple[type[BaseException], ...] = (Exception,),
    describe: str = "operation",
) -> T:
    """Run ``fn`` until it succeeds, sleeping ``initial_delay * 2**attempt``
    (capped at ``max_delay``) between failures; raise the last error once
    ``timeout`` seconds have elapsed (reference semantics: 600 s ceiling)."""
    start = time.monotonic()
    delay = initial_delay
    while True:
        try:
            return fn()
        except exceptions as exc:
            if isinstance(exc, PERMANENT_ERRORS):
                log.error("%s failed permanently (non-transient %s): %s",
                          describe, type(exc).__name__, exc)
                raise
            if time.monotonic() - start > timeout:
                log.error("%s failed permanently after %.0fs: %s",
                          describe, timeout, exc)
                raise
            log.warning("%s failed (%s); retrying in %.1fs", describe, exc, delay)
            time.sleep(delay)
            delay = min(delay * 2, max_delay)



def multi_try_load_csv(path, timeout: float = 600.0, **kwargs):
    import pandas as pd

    return retry_with_backoff(
        lambda: pd.read_csv(path, **kwargs),
        timeout=timeout, describe=f"read_csv({path})",
    )


def multi_try_load_pickle(path, timeout: float = 600.0, **kwargs):
    import pandas as pd

    return retry_with_backoff(
        lambda: pd.read_pickle(path, **kwargs),
        timeout=timeout, describe=f"read_pickle({path})",
    )


def multi_try_load_npz(path, timeout: float = 600.0, **kwargs):
    import numpy as np

    return retry_with_backoff(
        lambda: np.load(path, **kwargs),
        timeout=timeout, describe=f"np.load({path})",
    )
