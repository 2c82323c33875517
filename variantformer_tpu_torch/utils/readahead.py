"""Page-cache readahead for cold hosts.

The port's copy of ``variantformer_tpu/utils/readahead.py``. The sample
builders read the reference FASTA (and the donor VCF) with random positioned
reads (``os.pread``). On a freshly booted machine none of those blocks are in
the OS page cache, and each read pays a disk seek. One sequential pass turns
that into streaming reads, and runs in the background while the model loads,
so the builders start against a warm cache.
"""

from __future__ import annotations

import os
import threading

_BLOCK = 1 << 22  # 4 MiB sequential reads

# Never warm more than this fraction of currently-available memory: streaming
# a ~3 GB FASTA through a small-RAM host would EVICT pages the run actively
# needs and degrade rather than improve throughput.
_AVAIL_FRACTION = 0.5


def _available_bytes() -> int | None:
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (AttributeError, ValueError, OSError):
        return None


def warm_page_cache(
    paths, background: bool = True, block: int = _BLOCK
) -> threading.Thread | None:
    """Sequentially read ``paths`` to populate the OS page cache.

    posix_fadvise(WILLNEED) alone is advisory (and a no-op on some kernels
    for large spans), so the pass actually reads the bytes. The total warmed
    span is capped at half of currently-available memory (per-file budget,
    largest-priority order preserved as given) so the pass cannot thrash a
    small-RAM host. Missing paths and IO errors are ignored; set
    VFX_NO_READAHEAD=1 to disable entirely. With ``background=True`` returns
    the started daemon thread.
    """
    if os.environ.get("VFX_NO_READAHEAD") == "1":
        return None
    paths = [str(p) for p in paths if p]

    def _warm():
        avail = _available_bytes()
        budget = int(avail * _AVAIL_FRACTION) if avail else None
        for p in paths:
            if budget is not None and budget <= 0:
                break
            try:
                fd = os.open(p, os.O_RDONLY)
            except OSError:
                continue
            try:
                size = os.fstat(fd).st_size
                span = size if budget is None else min(size, budget)
                try:
                    os.posix_fadvise(fd, 0, span, os.POSIX_FADV_WILLNEED)
                except (AttributeError, OSError):
                    pass
                off = 0
                while off < span:
                    if not os.pread(fd, block, off):
                        break
                    off += block
                if budget is not None:
                    budget -= off
            except OSError:
                pass
            finally:
                os.close(fd)

    if background:
        t = threading.Thread(target=_warm, daemon=True, name="vfx-readahead")
        t.start()
        return t
    _warm()
    return None
