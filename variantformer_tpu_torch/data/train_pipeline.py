"""Offline training data -> npz shards: the port of
``variantformer_tpu/data/train_pipeline.py``, with the same npz keys, file
names and manifests.

  * ``TrainingShardWriter`` (seq2gene): (gene, donor) samples from the
    port's ``GeneSampleBuilder`` with expression labels, one
    ``{gene_id}__{donor}.npz`` each and a ``manifest.json``. Expression
    table contract: columns (gene_id, donor, tissue, TPM, FPKM).
  * ``Seq2RegShardWriter`` (seq2reg): per-(subject, tissue) cCRE class
    labels joined onto the reference cCRE regions, a per-(region, tissue)
    majority class across subjects, and tokenized chunks of exactly
    ``chunk_size`` windows per (subject, tissue, chromosome) in ``train/``
    or ``test/`` by the held-out chromosome.
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
from variantformer_tpu_torch.utils.constants import IGNORE_CHRS, MAP_CRE_TO_IDX

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


class Seq2RegShardWriter:
    """Seq2reg (window-classifier) training shards.

      * per-(subject, tissue) cCRE label frames are joined onto the
        reference cCRE regions by exact coordinates after the
        ``neighbour_hood`` padding applied to both sides,
      * a per-(region, tissue) majority class is computed across subjects
        (the most frequent label, the smallest on a tie),
      * regions are sharded per (subject, tissue, chromosome) into chunks of
        exactly ``chunk_size`` rows: a short chunk is filled by resampling
        its rows with replacement from ``write``'s generator,
      * chunks land in ``train/`` or ``test/`` by the held-out chromosome.

    Sequences come from ``seq_fn(subject, chrom, start, end)`` (a
    per-subject consensus engine or the plain reference); tokens are BPE
    ids padded to ``max_length``."""

    def __init__(
        self,
        ref_cres: pd.DataFrame,  # columns: chromosome, start, end, cCRE
        tokenizer,
        seq_fn,
        out_dir: str | Path,
        chunk_size: int = 64,
        max_length: int = 200,
        test_chr: str = "chr8",
        neighbour_hood: int = 50,
    ):
        self.ref = ref_cres.reset_index(drop=True)
        self.tokenizer = tokenizer
        self.seq_fn = seq_fn
        self.out_dir = Path(out_dir)
        self.chunk_size = chunk_size
        self.max_length = max_length
        self.test_chr = test_chr
        self.neighbour_hood = neighbour_hood
        self.class_map = MAP_CRE_TO_IDX
        self._labels: dict[tuple[str, str], pd.DataFrame] = {}

    def add_labels(self, subject: str, tissue: str, bed: pd.DataFrame) -> None:
        """Register one subject + tissue label frame (columns: chromosome,
        start, end, tissue_cre)."""
        b = bed.copy()
        b["start"] = b["start"] - self.neighbour_hood
        b["end"] = b["end"] + self.neighbour_hood
        self._labels[(subject, tissue)] = b

    def _majority(self) -> dict[str, pd.DataFrame]:
        """Per-tissue majority class across subjects, keyed by coordinates."""
        out = {}
        key = ["chromosome", "start", "end"]
        for tissue in sorted({t for (_, t) in self._labels}):
            frames = [b[key + ["tissue_cre"]] for (_, t), b in self._labels.items()
                      if t == tissue]
            out[tissue] = (
                pd.concat(frames, ignore_index=True)
                .groupby(key)["tissue_cre"]
                .agg(lambda s: s.mode().iloc[0])
                .reset_index()
                .rename(columns={"tissue_cre": "majority"})
            )
        return out

    def _tokenize(self, subject: str, rows: pd.DataFrame):
        toks = np.zeros((len(rows), self.max_length), np.int32)
        lens = np.zeros((len(rows),), np.int32)
        for i, row in enumerate(rows.itertuples(index=False)):
            seq = self.seq_fn(subject, row.chromosome, int(row.start), int(row.end))
            ids = self.tokenizer.encode_ids(seq)[: self.max_length]
            toks[i, : len(ids)] = ids
            lens[i] = len(ids)
        return toks, lens

    def write(self, rng: np.random.Generator | None = None) -> list[str]:
        """Write every chunk and ``manifest.json``; returns the chunk paths."""
        rng = rng or np.random.default_rng(0)
        majority = self._majority()
        key = ["chromosome", "start", "end"]
        to_idx = lambda s: self.class_map.get(s, 0)
        written = []
        for (subject, tissue), bed in sorted(self._labels.items()):
            merged = self.ref.merge(bed[key + ["tissue_cre"]], on=key, how="inner").merge(
                majority[tissue], on=key, how="left")
            for chrom, sub in merged.groupby("chromosome", sort=True):
                out = self.out_dir / ("test" if chrom == self.test_chr else "train")
                out.mkdir(parents=True, exist_ok=True)
                sub = sub.sort_values("start").reset_index(drop=True)
                for ci, lo in enumerate(range(0, len(sub), self.chunk_size)):
                    chunk = sub.iloc[lo: lo + self.chunk_size]
                    if len(chunk) < self.chunk_size:
                        fill = rng.choice(len(chunk), self.chunk_size - len(chunk), replace=True)
                        chunk = pd.concat([chunk, chunk.iloc[fill]],
                                          ignore_index=True).sort_values("start")
                    toks, lens = self._tokenize(subject, chunk)
                    path = out / f"{subject}_{tissue}_{chrom}_chunk_{ci}.npz"
                    np.savez_compressed(
                        path,
                        subject=np.array(subject),
                        tissue=np.array(tissue),
                        tokens=toks,
                        tok_len=lens,
                        ref_class=chunk["cCRE"].map(to_idx).to_numpy(np.int32),
                        tissue_class=chunk["tissue_cre"].map(to_idx).to_numpy(np.int32),
                        majority_class=chunk["majority"].map(to_idx).to_numpy(np.int32),
                        start=chunk["start"].to_numpy(np.int64),
                        end=chunk["end"].to_numpy(np.int64),
                    )
                    written.append(str(path))
        manifest = {
            "chunk_size": self.chunk_size,
            "test_chr": self.test_chr,
            "count": len(written),
            "files": [str(Path(p).relative_to(self.out_dir)) for p in written],
        }
        self.out_dir.mkdir(parents=True, exist_ok=True)
        (self.out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
        return written
