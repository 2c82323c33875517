"""Host data pipeline: (FASTA, VCF, query) -> static-shape batches.

A copy of ``variantformer_tpu/data/pipeline.py`` on the port's own host
modules (pure-Python consensus and BPE). Sequence semantics:
  * CRE regions are the per-gene CRE map rows +-cre_neighbour_hood bp,
  * minus-strand genes reverse the CRE order and use the reverse-complement
    strand of each CRE (and of the gene window),
  * the gene window is [TSS-1kb, min(gene_end, TSS-1kb+300kb)) on '+' and
    the mirror on '-', consensus-applied then tokenized and cut into
    <=max_chunks windows of max_length tokens,
  * per-window token arrays are padded/truncated to max_length (ids pad with
    the <pad> id; validity carried as a token count).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import pandas as pd

from variantformer_tpu_torch.config import DatasetConfig
from variantformer_tpu_torch.utils.bpe import BPETokenizer
from variantformer_tpu_torch.utils.constants import (
    AUTOSOMES,
    MAP_REF_CRE_TO_IDX,
)
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.sequence import reverse_complement
from variantformer_tpu_torch.utils.vcf import ConsensusEngine, VCFReader

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GeneSample:
    """One (gene, donor-VCF) host sample: tokenized CRE + gene windows."""

    gene_id: str
    strand: str
    cre_tokens: np.ndarray    # [C, L] int32
    cre_tok_len: np.ndarray   # [C] int32
    cre_labels: np.ndarray    # [C] int32
    gene_tokens: np.ndarray   # [G, L] int32
    gene_tok_len: np.ndarray  # [G] int32


def _bucket(n: int, step: int = 64, minimum: int = 64,
            extra: tuple[int, ...] = ()) -> int:
    """Round up to a step multiple, or to an extra candidate (e.g. the
    dataset's max_chunks cap) when that is tighter — most genes hit the
    window cap exactly, and 200 beats a 256 bucket by 28% of that axis."""
    candidates = [max(minimum, -(-n // step) * step)]
    candidates += [e for e in extra if e >= n and e % 8 == 0]
    return min(candidates)


class GeneSampleBuilder:
    def __init__(
        self,
        cfg: DatasetConfig,
        fasta: FastaReader,
        tokenizer: BPETokenizer,
        gencode: pd.DataFrame,
        cre_map_provider,
        vcf: VCFReader | None = None,
        snps_only: bool = False,
    ):
        """cre_map_provider: gene_id -> DataFrame[chromosome, start_cre,
        end_cre, cre_name] (the per-gene CRE map contract)."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.gencode = gencode.set_index("gene_id", drop=False)
        self.cre_map_provider = cre_map_provider
        self.engine = ConsensusEngine(fasta, vcf)
        self.snps_only = snps_only

    # -- gene annotation --------------------------------------------------
    def gene_info(self, gene_id: str) -> dict:
        row = self.gencode.loc[gene_id]
        if isinstance(row, pd.DataFrame):
            row = row.iloc[0]
        info = row.to_dict()
        if info["chromosome"] not in AUTOSOMES:
            raise ValueError(
                f"Chromosome {info['chromosome']} unsupported (autosomes only)"
            )
        return info

    def gene_window(self, info: dict) -> tuple[int, int]:
        """0-based [start, end) of the cis window (reference
        utils/data_process.py:367-401 arithmetic)."""
        start, end = int(info["start"]), int(info["end"])
        up = self.cfg.gene_upstream_neighbour_hood
        down = self.cfg.gene_downstream_neighbour_hood
        if info["strand"] == "-":
            w_start = max(start, end - down)
            w_end = end + up
        else:
            w_start = max(0, start - up)
            w_end = min(end, w_start + down)
        return w_start, w_end

    # -- tokenization helpers ---------------------------------------------
    def _fit_window(self, ids: list[int]) -> tuple[np.ndarray, int]:
        l = self.cfg.max_length
        pad = self.tokenizer.pad_token_id
        n = min(len(ids), l)
        arr = np.full(l, pad, np.int32)
        arr[:n] = ids[:n]
        return arr, n

    # -- sample construction ----------------------------------------------
    def build(self, gene_id: str) -> GeneSample:
        info = self.gene_info(gene_id)
        strand = info["strand"]
        chrom = info["chromosome"]
        nb = self.cfg.cre_neighbour_hood

        cre_map = self.cre_map_provider(gene_id)
        cre_map = cre_map.sort_values("start_cre").reset_index(drop=True)
        rows = list(cre_map.itertuples(index=False))
        if strand == "-":
            rows = rows[::-1]

        cre_seqs, cre_labels = [], []
        for row in rows:
            start = max(0, int(row.start_cre) - nb)
            end = int(row.end_cre) + nb
            seq, _ = self.engine.consensus(chrom, start, end, self.snps_only)
            if not seq:
                continue
            if strand == "-":
                seq = reverse_complement(seq)
            cre_seqs.append(seq)
            cre_labels.append(MAP_REF_CRE_TO_IDX[row.cre_name])
        cre_tokens, cre_lens = [], []
        for ids in self.tokenizer.encode_ids_batch(cre_seqs):
            arr, n = self._fit_window(ids)
            cre_tokens.append(arr)
            cre_lens.append(n)

        w_start, w_end = self.gene_window(info)
        gene_seq, _ = self.engine.consensus(chrom, w_start, w_end, self.snps_only)
        # The reference asserts >1kb (datasets/vcfdataset.py:291-293); scale
        # the floor with the configured upstream so small test genomes work.
        min_len = min(1000, self.cfg.gene_upstream_neighbour_hood)
        if len(gene_seq) <= min_len:
            raise ValueError(f"gene window shorter than {min_len}bp for {gene_id}")
        if strand == "-":
            gene_seq = reverse_complement(gene_seq)
        gene_ids = self.tokenizer.encode_ids(gene_seq)
        l = self.cfg.max_length
        gene_tokens, gene_lens = [], []
        for c in range(0, len(gene_ids), l):
            if len(gene_tokens) >= self.cfg.max_chunks:
                break
            arr, n = self._fit_window(gene_ids[c : c + l])
            gene_tokens.append(arr)
            gene_lens.append(n)

        return GeneSample(
            gene_id=gene_id,
            strand=strand,
            cre_tokens=np.stack(cre_tokens) if cre_tokens else np.zeros((0, l), np.int32),
            cre_tok_len=np.asarray(cre_lens, np.int32),
            cre_labels=np.asarray(cre_labels, np.int32),
            gene_tokens=np.stack(gene_tokens),
            gene_tok_len=np.asarray(gene_lens, np.int32),
        )


def pack_samples(
    samples: list[GeneSample],
    tissue_ids: list[int],
    bucket_step: int = 64,
    gene_cap: int | None = 200,
):
    """Pack host samples into a Seq2GeneBatch with bucketed static shapes.
    ``gene_cap`` (dataset max_chunks) joins the gene-axis bucket ladder since
    most genes hit the cap exactly. CRE windows keep the gene windows' token
    length; suffix padding is exact (ALiBi + masks).

    Leaves are NUMPY arrays; the processor moves them to its device."""
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    d = len(samples)
    length = samples[0].gene_tokens.shape[1]
    c_max = _bucket(max((s.cre_tokens.shape[0] for s in samples), default=1), bucket_step)
    extra = (gene_cap,) if gene_cap else ()
    g_max = _bucket(max(s.gene_tokens.shape[0] for s in samples), bucket_step,
                    extra=extra)

    cre_tokens = np.zeros((d, c_max, length), np.int32)
    cre_tok_len = np.zeros((d, c_max), np.int32)
    cre_labels = np.zeros((d, c_max), np.int32)
    cre_count = np.zeros(d, np.int32)
    gene_tokens = np.zeros((d, g_max, length), np.int32)
    gene_tok_len = np.zeros((d, g_max), np.int32)
    gene_count = np.zeros(d, np.int32)
    for i, s in enumerate(samples):
        c = s.cre_tokens.shape[0]
        g = s.gene_tokens.shape[0]
        cre_tokens[i, :c] = s.cre_tokens
        cre_tok_len[i, :c] = s.cre_tok_len
        cre_labels[i, :c] = s.cre_labels
        cre_count[i] = c
        gene_tokens[i, :g] = s.gene_tokens
        gene_tok_len[i, :g] = s.gene_tok_len
        gene_count[i] = g

    return Seq2GeneBatch(
        cre_tokens=cre_tokens,
        cre_tok_len=cre_tok_len,
        cre_count=cre_count,
        cre_labels=cre_labels,
        gene_tokens=gene_tokens,
        gene_tok_len=gene_tok_len,
        gene_count=gene_count,
        tissue_ids=np.asarray(tissue_ids, np.int32),
    )
