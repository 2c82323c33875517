"""Per-chromosome sorted interval index for gene lookups.

The port's copy of ``variantformer_tpu/utils/intervals.py``. Built ONCE from
the gencode frame (O(n log n)), it answers "which genes lie within a window
of this variant" in O(log n + hits) by binary search over start-sorted numpy
arrays with a max-interval-length bound, instead of a scan of every gencode
row per variant.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

_RECORD_COLS = ("gene_id", "start", "end", "gene_name", "strand", "chromosome")


class GeneIntervalIndex:
    """Answers: which genes have ``start - w < pos < end + w``?

    The semantics of a per-row scan: strict inequalities, gene body
    inflated by ``window_size`` on both sides.
    """

    def __init__(self, gencode: pd.DataFrame, window_size: int = 1_000_000):
        self.window_size = int(window_size)
        self._by_chrom: dict[str, tuple] = {}
        cols = [c for c in _RECORD_COLS if c in gencode.columns]
        for chrom, grp in gencode.groupby("chromosome", sort=False):
            grp = grp.sort_values("start", kind="stable")
            starts = grp["start"].to_numpy(np.int64)
            ends = grp["end"].to_numpy(np.int64)
            max_len = int((ends - starts).max()) if len(grp) else 0
            records = grp[cols].to_dict("records")
            for rec in records:
                rec.setdefault("gene_name", "")
            self._by_chrom[str(chrom)] = (starts, ends, max_len, records)

    def query(self, chrom: str, pos: int) -> list[dict]:
        entry = self._by_chrom.get(str(chrom))
        if entry is None:
            return []
        starts, ends, max_len, records = entry
        w = self.window_size
        # start < pos + w  (strict), and any hit must have
        # start = end - len >= end - max_len > pos - w - max_len.
        lo = int(np.searchsorted(starts, pos - w - max_len, side="left"))
        hi = int(np.searchsorted(starts, pos + w, side="left"))
        if hi <= lo:
            return []
        hit = np.nonzero(ends[lo:hi] > pos - w)[0]
        return [records[lo + i] for i in hit]
