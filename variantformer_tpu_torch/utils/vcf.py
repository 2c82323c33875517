"""VCF readers (tabix-indexed and scan) and the diploid IUPAC consensus engine.

The port's copy of ``variantformer_tpu/utils/vcf.py``:

  * a BGZF VCF with a tabix index (.tbi) beside it is queried by seeking to
    the indexed blocks (no full parse); any other VCF (.vcf / .vcf.gz, gzip
    or BGZF) is parsed once into per-chrom position-sorted variant arrays,
    and region queries are binary searches,
  * ``VCFStream`` iterates the records in file order without holding them,
  * consensus applies sample genotypes to a reference slice: heterozygous
    SNPs become IUPAC ambiguity codes (``bcftools consensus -H I``),
    homozygous-alt SNPs become the alt allele, indels are applied with a
    running offset,
  * symbolic ALTs (<...>) are excluded; ``snps_only`` keeps SNPs alone.

The consensus loop runs in C++ (``native/consensus.cpp``) unless the engine
is made with ``use_native=False``; the Python loop is the plain version.
"""

from __future__ import annotations

import bisect
import dataclasses
import gzip
import logging
import os
import struct
import zlib

from variantformer_tpu_torch.utils.bgzf import BGZFReader, is_bgzf
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.native import get_seq_library, native_consensus
from variantformer_tpu_torch.utils.sequence import het_iupac_code
from variantformer_tpu_torch.utils.tabix import TabixIndex

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
    """Single-sample VCF with region queries.

    Two modes: with a tabix index (.tbi) next to a BGZF VCF, queries seek
    directly to the indexed blocks (no full parse); otherwise the file is
    parsed once into per-chromosome sorted variant lists."""

    def __init__(self, path: str, sample: str | None = None,
                 use_index: bool | None = None):
        self.path = path
        self.sample_names: list[str] = []
        self._by_chrom: dict[str, tuple[list[int], list[VcfVariant]]] = {}
        self._index = None
        self._bgzf = None
        self._sample_idx = None
        indexable = (
            use_index is not False
            and path.endswith(".gz")
            and is_bgzf(path)
            and os.path.exists(path + ".tbi")
        )
        if indexable:
            try:
                self._index = TabixIndex(path + ".tbi")
                self._bgzf = BGZFReader(path)
                self._parse_header(sample)
                return
            except (OSError, ValueError, struct.error, zlib.error) as exc:
                log.warning("tabix index unusable (%s); falling back to scan", exc)
                self._index = None
        self._parse(sample)

    # -- indexed mode ------------------------------------------------------
    def _parse_header(self, sample: str | None):
        for line in self._bgzf.stream_lines():
            if line.startswith(b"##"):
                continue
            if line.startswith(b"#CHROM"):
                header = line.decode().split("\t")
                self.sample_names = header[9:]
                if sample is not None:
                    self._sample_idx = 9 + self.sample_names.index(sample)
                else:
                    self._sample_idx = 9 if len(header) > 9 else None
                return
            break

    def _query_indexed(self, chrom: str, start: int, end: int) -> list[VcfVariant]:
        voff = self._index.min_voffset(chrom, max(start, 0), max(end, 1))
        if voff is None:
            return []
        out = []
        for line in self._bgzf.read_lines_from_voffset(voff):
            if not line or line.startswith(b"#"):
                continue
            fields = line.decode().split("\t")
            if fields[0] != chrom:
                if out:  # left the chromosome: records are chrom-sorted
                    break
                continue
            pos = int(fields[1])
            if pos > end:
                break
            if pos <= start:
                continue
            var = self._parse_record(fields, self._sample_idx)
            if var is not None:
                out.append(var)
        return out

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
        if self._index is not None:
            return self._query_indexed(chrom, start, end)
        if chrom not in self._by_chrom:
            return []
        positions, variants = self._by_chrom[chrom]
        lo = bisect.bisect_right(positions, start)
        hi = bisect.bisect_right(positions, end)
        return variants[lo:hi]


class VCFStream:
    """Single-pass streaming VCF reader: iterate (chrom, VcfVariant) tuples
    in file order WITHOUT materializing the file (the non-indexed VCFReader
    loads everything into per-chrom dicts — prohibitive for multi-million-
    record donor VCFs). Records that project to hom-ref or are unparseable
    are skipped, exactly like VCFReader._parse."""

    def __init__(self, path: str, sample: str | None = None):
        self.path = path
        self.sample_names: list[str] = []
        self._sample = sample
        self._reader = VCFReader.__new__(VCFReader)  # reuse _lines machinery
        self._reader.path = path

    def __iter__(self):
        sample_idx = None
        for raw in self._reader._lines():
            if not raw or raw.startswith(b"##"):
                continue
            if raw.startswith(b"#CHROM"):
                header = raw.decode().split("\t")
                self.sample_names = header[9:]
                if self._sample is not None:
                    sample_idx = 9 + self.sample_names.index(self._sample)
                else:
                    sample_idx = 9 if len(header) > 9 else None
                continue
            fields = raw.decode().split("\t")
            var = VCFReader._parse_record(fields, sample_idx)
            if var is not None:
                yield fields[0], var


class ConsensusEngine:
    """Applies diploid genotypes to reference slices as IUPAC consensus.

    The loop runs in C++ (native/consensus.cpp, built at first use; raises
    when it cannot be) unless ``use_native=False``, which runs the Python
    loop below: the plain version, with the same results."""

    def __init__(self, fasta: FastaReader, vcf: VCFReader | None = None,
                 use_native: bool = True,
                 ref_mismatch: str | None = None):
        """ref_mismatch: what to do when a record's REF column disagrees with
        the fetched reference sequence.

          * "skip" (default): drop only the bad record and apply the rest —
            the standalone-sensible behavior (documented DELIBERATE DEVIATION,
            as in the JAX package).
          * "region_fallback": reproduce the reference pipeline exactly —
            bcftools consensus exits non-zero on the first REF mismatch and
            the reference then uses the RAW reference slice for the whole
            region with 0 applied. Required for gold-parity runs on regions
            containing such records.

        Default resolves from VFX_CONSENSUS_REF_MISMATCH, else "skip"."""
        self.fasta = fasta
        self.vcf = vcf
        self.use_native = use_native
        if use_native:
            get_seq_library()  # build or load now: a failure shows here
        if ref_mismatch is None:
            ref_mismatch = os.environ.get("VFX_CONSENSUS_REF_MISMATCH", "skip")
        if ref_mismatch not in ("skip", "region_fallback"):
            raise ValueError(f"ref_mismatch={ref_mismatch!r}: 'skip' or 'region_fallback'")
        self.ref_mismatch = ref_mismatch

    def _region_has_mismatch(
        self, seq: str, start: int, variants, snps_only: bool
    ) -> bool:
        """Mirror the apply loop's cursor semantics: a record that would be
        skipped for overlap/out-of-range never reaches bcftools' REF check."""
        cursor = 0
        for var in variants:
            if var.is_ref_call or (snps_only and not var.is_snp):
                continue
            vstart = var.pos - 1 - start
            vend = vstart + len(var.ref)
            if vstart < cursor or vend > len(seq):
                continue
            if seq[vstart:vend].upper() != var.ref.upper():
                log.warning(
                    "REF mismatch at %d (%s != %s); region falls back to the "
                    "raw reference (ref_mismatch='region_fallback')",
                    var.pos, seq[vstart:vend], var.ref,
                )
                return True
            cursor = vend
        return False

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
        if self.ref_mismatch == "region_fallback" and self._region_has_mismatch(
            seq, start, variants, snps_only
        ):
            return seq, 0
        if self.use_native:
            return native_consensus(seq, start, variants, snps_only)
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
                # (REF, ALT); for multi-allelic 1/2 hets it is (ALT1, ALT2),
                # e.g. A>C,G GT 1/2 -> S, not M.
                out.append(het_iupac_code(a0, a1))  # het SNP: IUPAC
            else:
                # heterozygous indel: apply the non-reference allele
                out.append(a0 if a0.upper() != var.ref.upper() else a1)
            cursor = vend
            applied += 1
        out.append(seq[cursor:])
        return "".join(out), applied

    def consensus_fixed_length(
        self, chrom: str, start: int, end: int, snps_only: bool = False
    ) -> tuple[str, int]:
        """``consensus`` under the name the JAX package gives its fixed-
        coordinate callers: the sequence keeps the slice's length only with
        ``snps_only=True``."""
        return self.consensus(chrom, start, end, snps_only)
