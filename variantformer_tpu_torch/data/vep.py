"""VEP data path: (variant, gene) -> ref/het/hom batches with variant-token
position tracking.

The port's copy of ``variantformer_tpu/data/vep.py``, on the port's host
modules (the C++ consensus and BPE engines by default). Semantics:

  * variants are applied on the forward-strand sequence: het sites become
    IUPAC ambiguity codes, hom sites the alt allele,
  * consensus uses the SNP-only filter when sequences come from a sample VCF,
  * the CRE window overlapping the variant records its window index
    (cre_token_position); the gene stream records the token window covering
    the variant (the token index of ``encode_with_position`` on the
    strand-appropriate sequence over max_length), clamped to max_chunks-1,
  * minus-strand genes reverse CRE order and use reverse-complement strands.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import pandas as pd

from variantformer_tpu_torch.config import DatasetConfig
from variantformer_tpu_torch.data.pipeline import GeneSample, GeneSampleBuilder
from variantformer_tpu_torch.utils.bpe import splice_encode
from variantformer_tpu_torch.utils.constants import MAP_REF_CRE_TO_IDX
from variantformer_tpu_torch.utils.intervals import GeneIntervalIndex
from variantformer_tpu_torch.utils.retry import multi_try_load_npz, multi_try_load_pickle
from variantformer_tpu_torch.utils.sequence import (
    het_iupac_code,
    reverse_complement,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Variant:
    chrom: str
    pos: int               # 1-based
    ref: str
    alt: str
    tissue: list[int]
    gene_id: list[str] = dataclasses.field(default_factory=list)
    consequence: str | None = None
    label: Any = None

    def __post_init__(self):
        if not self.chrom.startswith("chr"):
            self.chrom = "chr" + self.chrom


@dataclasses.dataclass
class VepSample:
    """One (variant, gene, population) item: ref/het/hom GeneSamples."""

    gene_id: str
    variant_type: str
    samples: list[GeneSample]            # [ref, het, hom] or empty
    cre_token_position: float            # nan when variant not in a CRE
    gene_token_positions: list[float]    # per zygosity; nan when not in gene


@dataclasses.dataclass
class _RefGeneEntry:
    """Per-(gene, population) reference state, built once and reused for
    every variant hitting that gene: raw sequences, the tokenized ref
    GeneSample, and the strand-oriented gene token stream with offsets
    (the splice-encode substrate). All fields are treated as immutable."""

    cre_df: pd.DataFrame
    gene: dict
    sample: GeneSample
    gene_seq_strand: str
    gene_ids: np.ndarray
    tok_starts: np.ndarray
    tok_ends: np.ndarray


class VepSampleBuilder:
    """Builds ref/het/hom batches from per-region consensus + variant edits.

    Incremental construction (~30x less host work per variant than
    re-tokenizing every window per zygosity): the ref GeneSample is built ONCE per
    (gene, population) and cached; het/hom re-tokenize only the
    variant-covering CRE window(s) and a ~2 kb neighborhood of the gene
    stream (utils/bpe.splice_encode — exact, self-verifying), reusing every
    other window's arrays. Thread-safe: sweep builders run in worker threads.
    """

    def __init__(self, builder: GeneSampleBuilder, ref_cache_size: int = 64):
        import collections
        import threading

        self.b = builder
        self.cfg: DatasetConfig = builder.cfg
        self.tok = builder.tokenizer
        self._cache_max = ref_cache_size
        self._cache: "collections.OrderedDict[tuple, _RefGeneEntry]" = (
            collections.OrderedDict()
        )
        self._cache_lock = threading.Lock()
        self._key_locks: dict[tuple, Any] = {}
        self._threading = threading

    # -- raw sequences -----------------------------------------------------
    def _cre_sequences(self, gene_id: str, info: dict) -> pd.DataFrame:
        """Forward-strand consensus CRE sequences (SNP-only when VCF-backed),
        ordered by position then reversed for minus-strand genes."""
        nb = self.cfg.cre_neighbour_hood
        chrom = info["chromosome"]
        cre_map = self.b.cre_map_provider(gene_id).sort_values("start_cre")
        rows = []
        for row in cre_map.itertuples(index=False):
            start = max(0, int(row.start_cre) - nb)
            end = int(row.end_cre) + nb
            seq, _ = self.b.engine.consensus(chrom, start, end, snps_only=True)
            if not seq:
                continue
            rows.append(
                {
                    "start_cre": start,
                    "end_cre": end,
                    "sequence": seq,
                    "cCRE": row.cre_name,
                    "strand": info["strand"],
                }
            )
        df = pd.DataFrame(rows)
        if info["strand"] == "-":
            df = df.iloc[::-1].reset_index(drop=True)
        return df

    def _gene_sequence(self, info: dict) -> dict:
        w_start, w_end = self.b.gene_window(info)
        seq, _ = self.b.engine.consensus(
            info["chromosome"], w_start, w_end, snps_only=True
        )
        return {
            "sequence": seq,
            "start": w_start,
            "end": w_end,
            "strand": info["strand"],
        }

    # -- variant application ----------------------------------------------
    @staticmethod
    def _apply(seq: str, pos: int, ref: str, alt: str) -> tuple[str, str]:
        het = seq[:pos] + het_iupac_code(ref, alt) + seq[pos + 1 :]
        hom = seq[:pos] + alt + seq[pos + 1 :]
        return het, hom

    # -- tokenized sample assembly ----------------------------------------
    def _chunk_gene_ids(self, gene_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Split a token stream into <=max_chunks padded windows of max_length."""
        l = self.cfg.max_length
        gene_tokens, gene_lens = [], []
        for c in range(0, len(gene_ids), l):
            if len(gene_tokens) >= self.cfg.max_chunks:
                break
            arr, n = self.b._fit_window(gene_ids[c : c + l])
            gene_tokens.append(arr)
            gene_lens.append(n)
        return np.stack(gene_tokens), np.asarray(gene_lens, np.int32)

    def _fit_cre_rows(self, cre_df: pd.DataFrame, strand: str):
        l = self.cfg.max_length
        cre_tokens, cre_lens, cre_labels = [], [], []
        seqs = [
            reverse_complement(s) if strand == "-" else s
            for s in cre_df["sequence"]
        ]
        for ids, (_, row) in zip(self.tok.encode_ids_batch(seqs), cre_df.iterrows()):
            arr, n = self.b._fit_window(ids)
            cre_tokens.append(arr)
            cre_lens.append(n)
            cre_labels.append(MAP_REF_CRE_TO_IDX.get(row["cCRE"], 0))
        return (
            np.stack(cre_tokens) if cre_tokens else np.zeros((0, l), np.int32),
            np.asarray(cre_lens, np.int32),
            np.asarray(cre_labels, np.int32),
        )

    def _tokenize(self, cre_df: pd.DataFrame, gene: dict, gene_id: str) -> GeneSample:
        """A whole sample from raw sequences (``_cre_sequences`` and
        ``_gene_sequence``), tokenized from scratch: the reference sample of
        ``api/sweeps.saturation_scan``."""
        strand = gene["strand"]
        cre_tokens, cre_lens, cre_labels = self._fit_cre_rows(cre_df, strand)
        gene_seq = gene["sequence"]
        if strand == "-":
            gene_seq = reverse_complement(gene_seq)
        gene_ids = self.tok.encode_ids(gene_seq)
        gene_tokens, gene_lens = self._chunk_gene_ids(gene_ids)
        return GeneSample(
            gene_id=gene_id,
            strand=strand,
            cre_tokens=cre_tokens,
            cre_tok_len=cre_lens,
            cre_labels=cre_labels,
            gene_tokens=gene_tokens,
            gene_tok_len=gene_lens,
        )

    # -- precomputed population sequences (manifest-backed) -----------------
    def _load_precomputed(
        self, gene_info: dict, population: str,
        cre_seq_manifest, gene_seq_manifest,
    ) -> tuple[pd.DataFrame, dict]:
        """Load per-population CRE/gene sequences from the precomputed
        artifacts: a per-chromosome CRE pickle subset to the gene's CRE
        span, and a per-gene npz with the forward,reverse sequence string."""
        gene_id = gene_info["gene_id"]
        chrom = gene_info["chromosome"]
        nb = self.cfg.cre_neighbour_hood

        cre_path = cre_seq_manifest.get_file_path(chrom, population)
        if cre_path is None:
            raise KeyError(f"no precomputed CREs for {chrom}/{population}")
        all_cres = multi_try_load_pickle(cre_path, compression="gzip")
        all_cres = all_cres.rename(columns={"start": "start_cre", "end": "end_cre"})

        cre_map = self.b.cre_map_provider(gene_id).sort_values("start_cre")
        first = int(cre_map.iloc[0]["start_cre"]) - nb
        last = int(cre_map.iloc[-1]["end_cre"]) + nb
        lo = all_cres["start_cre"].searchsorted(first, side="left")
        hi = all_cres["end_cre"].searchsorted(last, side="right") - 1
        df = all_cres.iloc[lo : hi + 1].reset_index(drop=True)
        rename = {}
        for col in df.columns:
            if col.endswith("_sequence"):
                rename[col] = "sequence"
            if col.endswith("cre_name") or col == "cCRE":
                rename[col] = "cCRE"
        df = df.rename(columns=rename)
        rows = []
        for _, row in df.iterrows():
            seq = str(row["sequence"]).split(",")[0]
            rows.append(
                {
                    "start_cre": int(row["start_cre"]),
                    "end_cre": int(row["end_cre"]),
                    "sequence": seq,
                    "cCRE": row.get("cCRE", "PLS"),
                    "strand": gene_info["strand"],
                }
            )
        cre_df = pd.DataFrame(rows)
        if gene_info["strand"] == "-":
            cre_df = cre_df.iloc[::-1].reset_index(drop=True)

        gene_path = gene_seq_manifest.get_file_path(gene_id, population)
        if gene_path is None:
            raise KeyError(f"no precomputed gene sequence for {gene_id}/{population}")
        data = multi_try_load_npz(gene_path, allow_pickle=True)
        gene_dict = {key: str(data[key]) for key in data.files}
        # Window arithmetic of the precomputed artifacts: on '+' the
        # downstream cap is measured from the *original* gene start, unlike
        # the VCF/consensus path (GeneSampleBuilder.gene_window), which
        # measures from the upstream-extended start. The two differ only for
        # genes longer than down-up bp.
        start, end = int(gene_info["start"]), int(gene_info["end"])
        up = self.cfg.gene_upstream_neighbour_hood
        down = self.cfg.gene_downstream_neighbour_hood
        if gene_info["strand"] == "-":
            w_start, w_end = max(start, end - down), end + up
        else:
            w_start, w_end = max(0, start - up), min(end, start + down)
        fwd = gene_dict["sequence"].split(",")[0]
        if len(fwd) != (w_end - w_start):
            raise ValueError(
                f"gene sequence length mismatch: {len(fwd)} != {w_end - w_start}"
            )
        return cre_df, {
            "sequence": fwd,
            "start": w_start,
            "end": w_end,
            "strand": gene_info["strand"],
        }

    # -- reference-state cache ---------------------------------------------
    def _build_ref_entry(self, gene_info: dict, precomputed) -> _RefGeneEntry:
        gene_id = gene_info["gene_id"]
        if precomputed is not None:
            population, cre_m, gene_m = precomputed
            cre_df, gene = self._load_precomputed(gene_info, population, cre_m, gene_m)
        else:
            cre_df = self._cre_sequences(gene_id, gene_info)
            gene = self._gene_sequence(gene_info)
        strand = gene_info["strand"]
        cre_tokens, cre_lens, cre_labels = self._fit_cre_rows(cre_df, strand)
        gene_seq = gene["sequence"]
        if strand == "-":
            gene_seq = reverse_complement(gene_seq)
        gene_ids, tok_starts, tok_ends = self.tok.encode_with_offsets(gene_seq)
        gene_tokens, gene_lens = self._chunk_gene_ids(gene_ids)
        sample = GeneSample(
            gene_id=gene_id, strand=strand,
            cre_tokens=cre_tokens, cre_tok_len=cre_lens, cre_labels=cre_labels,
            gene_tokens=gene_tokens, gene_tok_len=gene_lens,
        )
        return _RefGeneEntry(
            cre_df=cre_df, gene=gene, sample=sample,
            gene_seq_strand=gene_seq, gene_ids=gene_ids,
            tok_starts=tok_starts, tok_ends=tok_ends,
        )

    def _get_ref_entry(self, gene_info: dict, precomputed) -> _RefGeneEntry:
        key = (
            gene_info["gene_id"],
            precomputed[0] if precomputed is not None else "__consensus__",
        )
        with self._cache_lock:
            ent = self._cache.get(key)
            if ent is not None:
                self._cache.move_to_end(key)
                return ent
            lock = self._key_locks.setdefault(key, self._threading.Lock())
        with lock:
            with self._cache_lock:
                ent = self._cache.get(key)
            if ent is None:
                ent = self._build_ref_entry(gene_info, precomputed)
                with self._cache_lock:
                    self._cache[key] = ent
                    while len(self._cache) > self._cache_max:
                        self._cache.popitem(last=False)
                    self._key_locks.pop(key, None)
            return ent

    # -- incremental gene-stream editing ------------------------------------
    def _covering_token(self, ent: _RefGeneEntry, p: int) -> int:
        """Index of the ref token covering strand-coordinate p (ValueError if
        p falls in a non-IUPAC run — encode_with_position's contract)."""
        i = int(np.searchsorted(ent.tok_starts, p, side="right")) - 1
        if i < 0 or ent.tok_ends[i] <= p:
            raise ValueError(
                f"Position {p} points to invalid character "
                f"'{ent.gene_seq_strand[p] if p < len(ent.gene_seq_strand) else ''}'"
            )
        return i

    def _spliced_gene(
        self, ent: _RefGeneEntry, p_fwd: int, repl_fwd: str
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Apply a 1->len(repl) substitution at forward coordinate p_fwd and
        return (gene_tokens, gene_tok_len, gene_token_window) computed by
        token splicing, no full re-encode. The queried position is that of
        ``encode_with_position`` on the edited strand sequence: the
        strand-coordinate of the variant in the EDITED sequence (for '-',
        the last replacement char, the complement of the replacement's
        first base)."""
        strand = ent.gene["strand"]
        n = len(ent.gene_seq_strand)
        if strand == "-":
            p_s = n - 1 - p_fwd
            repl_s = reverse_complement(repl_fwd)
            qpos = p_s + len(repl_s) - 1
        else:
            p_s = p_fwd
            repl_s = repl_fwd
            qpos = p_s
        new_ids, win_tok_start, win_ids, win_starts, win_ends = splice_encode(
            self.tok, ent.gene_seq_strand, ent.gene_ids,
            ent.tok_starts, ent.tok_ends, p_s, repl_s,
        )
        wi = int(np.searchsorted(win_starts, qpos, side="right")) - 1
        if wi < 0 or win_ends[wi] <= qpos:
            # e.g. a non-SNP het replacement ('N') — matches
            # encode_with_position's invalid-character contract
            raise ValueError(f"Position {qpos} points to invalid character")
        token_idx = win_tok_start + wi
        window = min(token_idx // self.cfg.max_length, self.cfg.max_chunks - 1)
        gene_tokens, gene_lens = self._chunk_gene_ids(new_ids)
        return gene_tokens, gene_lens, window

    # -- main entry ---------------------------------------------------------
    def build(
        self,
        variant: Variant,
        gene_info: dict,
        validate_ref: bool = True,
        precomputed: tuple | None = None,  # (population, cre_manifest, gene_manifest)
    ) -> VepSample:
        gene_id = gene_info["gene_id"]
        ent = self._get_ref_entry(gene_info, precomputed)
        cre_df, gene = ent.cre_df, ent.gene
        strand = gene_info["strand"]

        # --- apply to CREs (only the covering rows are re-tokenized) ---
        overlap_cre = False
        cre_token_position = float("nan")
        changed_cres: list[tuple[int, str, str]] = []  # (row, het_fwd, hom_fwd)
        for i, row in cre_df.iterrows():
            if row["start_cre"] > variant.pos and strand == "+":
                break
            if row["end_cre"] < variant.pos and strand == "-":
                break
            if row["start_cre"] < variant.pos <= row["end_cre"]:
                overlap_cre = True
                cre_token_position = i
                pos_on_seq = variant.pos - row["start_cre"] - 1
                seq = row["sequence"]
                if validate_ref and seq[pos_on_seq].upper() != variant.ref.upper():
                    raise ValueError(
                        f"Reference mismatch at {variant.chrom}:{variant.pos}: "
                        f"{seq[pos_on_seq]} != {variant.ref}"
                    )
                het, hom = self._apply(seq, pos_on_seq, variant.ref, variant.alt)
                changed_cres.append((i, het, hom))

        # --- apply to the gene window ---
        overlap_gene = False
        gtp_ref = gtp_het = gtp_hom = float("nan")
        gene_edit = None  # (p_fwd, het_code, alt)
        if gene["start"] < variant.pos <= gene["end"]:
            overlap_gene = True
            pos_on_gene = variant.pos - gene["start"] - 1
            fwd = gene["sequence"]
            if validate_ref and fwd[pos_on_gene].upper() != variant.ref.upper():
                raise ValueError(
                    f"Gene reference mismatch at {variant.chrom}:{variant.pos}"
                )
            het_code = het_iupac_code(variant.ref, variant.alt)
            gene_edit = (pos_on_gene, het_code, variant.alt)
            p_s = (
                pos_on_gene if strand == "+"
                else len(ent.gene_seq_strand) - 1 - pos_on_gene
            )
            gtp_ref = min(
                self._covering_token(ent, p_s) // self.cfg.max_length,
                self.cfg.max_chunks - 1,
            )

        if not overlap_cre and not overlap_gene:
            return VepSample(
                gene_id=gene_id, variant_type="No overlap", samples=[],
                cre_token_position=float("nan"),
                gene_token_positions=[float("nan")] * 3,
            )

        def cre_arrays(zyg: int):
            """zyg: 1=het, 2=hom. Copy+patch only when a CRE changed."""
            if not changed_cres:
                return (ent.sample.cre_tokens, ent.sample.cre_tok_len)
            tokens = ent.sample.cre_tokens.copy()
            lens = ent.sample.cre_tok_len.copy()
            for i, het, hom in changed_cres:
                seq = het if zyg == 1 else hom
                if strand == "-":
                    seq = reverse_complement(seq)
                arr, m = self.b._fit_window(self.tok.encode_ids(seq))
                tokens[i] = arr
                lens[i] = m
            return tokens, lens

        def gene_arrays(zyg: int):
            if gene_edit is None:
                return (
                    ent.sample.gene_tokens, ent.sample.gene_tok_len, float("nan")
                )
            p_fwd, het_code, alt = gene_edit
            repl = het_code if zyg == 1 else alt
            return self._spliced_gene(ent, p_fwd, repl)

        samples = [ent.sample]
        gtps = [gtp_ref]
        for zyg in (1, 2):
            ct, cl = cre_arrays(zyg)
            gt, gl, gtp = gene_arrays(zyg)
            gtps.append(gtp)
            samples.append(
                GeneSample(
                    gene_id=gene_id, strand=strand,
                    cre_tokens=ct, cre_tok_len=cl,
                    cre_labels=ent.sample.cre_labels,
                    gene_tokens=gt, gene_tok_len=gl,
                )
            )

        if overlap_cre and overlap_gene:
            variant_type = "Gene and CRE overlap"
        elif overlap_cre:
            variant_type = "CRE overlap only"
        else:
            variant_type = "Gene overlap only"
        return VepSample(
            gene_id=gene_id,
            variant_type=variant_type,
            samples=samples,
            cre_token_position=cre_token_position,
            gene_token_positions=gtps,
        )


def get_probable_genes(
    gencode: pd.DataFrame,
    variant: Variant,
    window_size: int = 1_000_000,
    index: "GeneIntervalIndex | None" = None,
) -> list[dict]:
    """Genes whose body +-window contains the variant.

    Pass a prebuilt ``GeneIntervalIndex`` when calling per-variant in a
    loop — lookups are then O(log n + hits) instead of an O(genes) scan.
    """
    if index is None:
        index = GeneIntervalIndex(gencode, window_size)
    return index.query(variant.chrom, variant.pos)
