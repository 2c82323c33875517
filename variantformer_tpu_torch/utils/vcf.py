"""VCF reader (scan mode) and diploid IUPAC consensus engine.

A copy of the pure-Python paths of ``variantformer_tpu/utils/vcf.py``:

  * the VCF (.vcf / .vcf.gz, gzip or BGZF) is parsed once into per-chrom
    position-sorted variant arrays; region queries are binary searches,
  * consensus applies sample genotypes to a reference slice: heterozygous
    SNPs become IUPAC ambiguity codes (``bcftools consensus -H I``),
    homozygous-alt SNPs become the alt allele, indels are applied with a
    running offset,
  * symbolic ALTs (<...>) are excluded; ``snps_only`` keeps SNPs alone.

The tabix-indexed reader and the C++ consensus loop are not ported yet.
"""

from __future__ import annotations

import bisect
import dataclasses
import gzip
import logging

from variantformer_tpu_torch.utils.bgzf import BGZFReader, is_bgzf
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.sequence import het_iupac_code

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VcfVariant:
    pos: int          # 1-based POS
    ref: str
    alleles: tuple[str, str]  # the two genotype alleles (diploid), as sequences

    @property
    def is_snp(self) -> bool:
        return len(self.ref) == 1 and all(len(a) == 1 for a in self.alleles)

    @property
    def is_ref_call(self) -> bool:
        return self.alleles[0] == self.ref and self.alleles[1] == self.ref


class VCFReader:
    """Single-sample VCF with region queries, parsed once into per-chromosome
    sorted variant lists."""

    def __init__(self, path: str, sample: str | None = None):
        self.path = path
        self.sample_names: list[str] = []
        self._by_chrom: dict[str, tuple[list[int], list[VcfVariant]]] = {}
        self._parse(sample)

    def _lines(self):
        if self.path.endswith(".gz"):
            if is_bgzf(self.path):
                reader = BGZFReader(self.path)
                try:
                    yield from reader.stream_lines()
                finally:
                    reader.close()
            else:
                with gzip.open(self.path, "rb") as fh:
                    for line in fh:
                        yield line.rstrip(b"\n")
        else:
            with open(self.path, "rb") as fh:
                for line in fh:
                    yield line.rstrip(b"\n")

    @staticmethod
    def _parse_record(fields: list[str], sample_idx: int | None) -> VcfVariant | None:
        if len(fields) < 8:
            return None
        pos, ref, alt_str = int(fields[1]), fields[3], fields[4]
        alts = alt_str.split(",")
        if any(a.startswith("<") for a in alts):
            return None  # symbolic alleles excluded (ALT~"<.*>")
        if sample_idx is not None and len(fields) > sample_idx:
            fmt = fields[8].split(":")
            try:
                gt_idx = fmt.index("GT")
            except ValueError:
                return None
            gt = fields[sample_idx].split(":")[gt_idx]
            sep = "|" if "|" in gt else "/"
            allele_ids = gt.split(sep)
        else:
            allele_ids = ["1", "1"]  # site-only VCF: treat as hom alt
        if len(allele_ids) == 1:
            allele_ids = allele_ids * 2
        try:
            ids = [0 if a == "." else int(a) for a in allele_ids[:2]]
        except ValueError:
            return None
        if ids[0] == 0 and ids[1] == 0:
            return None
        seqs = []
        for i in ids:
            if i == 0:
                seqs.append(ref)
            elif i <= len(alts):
                seqs.append(alts[i - 1])
            else:
                return None
        return VcfVariant(pos=pos, ref=ref, alleles=(seqs[0], seqs[1]))

    def _parse(self, sample: str | None):
        sample_idx = None
        store: dict[str, list[tuple[int, VcfVariant]]] = {}
        for raw in self._lines():
            if not raw:
                continue
            if raw.startswith(b"##"):
                continue
            if raw.startswith(b"#CHROM"):
                header = raw.decode().split("\t")
                self.sample_names = header[9:]
                if sample is not None:
                    sample_idx = 9 + self.sample_names.index(sample)
                else:
                    sample_idx = 9 if len(header) > 9 else None
                continue
            fields = raw.decode().split("\t")
            var = self._parse_record(fields, sample_idx)
            if var is not None:
                store.setdefault(fields[0], []).append((var.pos, var))
        for chrom, items in store.items():
            items.sort(key=lambda pv: pv[0])
            self._by_chrom[chrom] = (
                [p for p, _ in items],
                [v for _, v in items],
            )

    def query(self, chrom: str, start: int, end: int) -> list[VcfVariant]:
        """Variants with 1-based POS in (start, end] — i.e. 0-based [start, end)."""
        if chrom not in self._by_chrom:
            return []
        positions, variants = self._by_chrom[chrom]
        lo = bisect.bisect_right(positions, start)
        hi = bisect.bisect_right(positions, end)
        return variants[lo:hi]


class ConsensusEngine:
    """Applies diploid genotypes to reference slices as IUPAC consensus.

    A record whose REF disagrees with the reference slice is skipped and the
    rest of the region is applied (the JAX package's default ``"skip"``
    policy)."""

    def __init__(self, fasta: FastaReader, vcf: VCFReader | None = None):
        self.fasta = fasta
        self.vcf = vcf

    def consensus(
        self, chrom: str, start: int, end: int, snps_only: bool = False
    ) -> tuple[str, int]:
        """Consensus over 0-based [start, end); returns (sequence, n_applied)."""
        seq = self.fasta.fetch(chrom, start, end)
        if self.vcf is None:
            return seq, 0
        variants = self.vcf.query(chrom, start, end)
        if not variants:
            return seq, 0
        out = []
        cursor = 0  # position within the region slice
        applied = 0
        for var in variants:
            if var.is_ref_call:
                continue
            if snps_only and not var.is_snp:
                continue
            vstart = var.pos - 1 - start
            vend = vstart + len(var.ref)
            if vstart < cursor or vend > len(seq):
                continue  # overlaps a prior edit or runs past the region
            if seq[vstart:vend].upper() != var.ref.upper():
                log.warning(
                    "REF mismatch at %s:%d (%s != %s); skipping",
                    chrom, var.pos, seq[vstart:vend], var.ref,
                )
                continue
            out.append(seq[cursor:vstart])
            a0, a1 = var.alleles
            if a0 == a1:
                out.append(a0)                      # homozygous: apply allele
            elif var.is_snp:
                # IUPAC code of the two GENOTYPE alleles — for 0/1 that is
                # (REF, ALT); for multi-allelic 1/2 hets it is (ALT1, ALT2).
                out.append(het_iupac_code(a0, a1))  # het SNP: IUPAC
            else:
                # heterozygous indel: apply the non-reference allele
                out.append(a0 if a0.upper() != var.ref.upper() else a1)
            cursor = vend
            applied += 1
        out.append(seq[cursor:])
        return "".join(out), applied
