"""Offline training data: (gene, donor) samples with expression labels ->
npz shards. A copy of the seq2gene half of
``variantformer_tpu/data/train_pipeline.py`` on the port's
``GeneSampleBuilder``, with the same npz keys and file names
(``{gene_id}__{donor}.npz`` and a ``manifest.json``).

Expression table contract: columns (gene_id, donor, tissue, TPM, FPKM).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd

from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
from variantformer_tpu_torch.utils.constants import IGNORE_CHRS

log = logging.getLogger(__name__)

DEFAULT_TEST_CHROMS = ("chr8", "chr21")


@dataclasses.dataclass
class ExpressionLabel:
    tissue_id: int
    tpm: float
    fpkm: float

    @property
    def log1p_tpm(self) -> float:
        return float(np.log1p(self.tpm))

    @property
    def log1p_fpkm(self) -> float:
        return float(np.log1p(self.fpkm))


def split_by_chromosome(gencode: pd.DataFrame, test_chroms=DEFAULT_TEST_CHROMS
                        ) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Chromosome-level train/test split (no within-chromosome leakage)."""
    gencode = gencode[~gencode["chromosome"].isin(IGNORE_CHRS)]
    test = gencode[gencode["chromosome"].isin(test_chroms)]
    train = gencode[~gencode["chromosome"].isin(test_chroms)]
    return train.reset_index(drop=True), test.reset_index(drop=True)


class TrainingShardWriter:
    """Builds and writes per-(gene, donor) training samples as npz shards."""

    def __init__(
        self,
        builders: dict[str, GeneSampleBuilder],  # donor -> builder (own VCF)
        expression: pd.DataFrame,
        tissue_vocab: dict[str, int],
        out_dir: str | Path,
        label: str = "log1p_tpm",
    ):
        self.builders = builders
        self.tissue_vocab = tissue_vocab
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.label = label
        exp = expression.copy()
        exp["tissue_id"] = exp["tissue"].map(tissue_vocab)
        exp = exp.dropna(subset=["tissue_id"])
        self._labels: dict[tuple[str, str], list[ExpressionLabel]] = {}
        for row in exp.itertuples(index=False):
            self._labels.setdefault((row.gene_id, row.donor), []).append(
                ExpressionLabel(int(row.tissue_id), float(row.TPM), float(row.FPKM))
            )

    def _label_value(self, lab: ExpressionLabel) -> float:
        return {
            "tpm": lab.tpm,
            "fpkm": lab.fpkm,
            "log1p_tpm": lab.log1p_tpm,
            "log1p_fpkm": lab.log1p_fpkm,
        }[self.label]

    def build_one(self, gene_id: str, donor: str) -> str | None:
        labels = self._labels.get((gene_id, donor))
        if not labels:
            return None
        try:
            sample = self.builders[donor].build(gene_id)
        except (ValueError, KeyError) as exc:
            log.warning("skipping %s/%s: %s", gene_id, donor, exc)
            return None
        path = self.out_dir / f"{gene_id}__{donor}.npz"
        np.savez_compressed(
            path,
            cre_tokens=sample.cre_tokens,
            cre_tok_len=sample.cre_tok_len,
            cre_labels=sample.cre_labels,
            gene_tokens=sample.gene_tokens,
            gene_tok_len=sample.gene_tok_len,
            strand=np.int32(0 if sample.strand == "+" else 1),
            tissue_ids=np.asarray([lab.tissue_id for lab in labels], np.int32),
            targets=np.asarray([self._label_value(lab) for lab in labels], np.float32),
        )
        return str(path)

    def build_all(self, gene_ids, donors, max_workers: int = 8) -> list[str]:
        """Build every (gene, donor) on a thread pool and write the manifest."""
        jobs = [(g, d) for g in gene_ids for d in donors]
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(lambda gd: self.build_one(*gd), jobs))
        written = [r for r in results if r]
        manifest = {
            "label": self.label,
            "count": len(written),
            "files": [str(Path(p).name) for p in written],
        }
        (self.out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
        log.info("wrote %d/%d samples to %s", len(written), len(jobs), self.out_dir)
        return written


def load_shard(path: str) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}
