"""Tabix (.tbi) index reader and writer for BGZF-compressed VCFs.

The port's copy of ``variantformer_tpu/utils/tabix.py``: region queries jump
straight to the right BGZF blocks via the index instead of scanning the whole
file. Implements the tabix format (HTS spec): R-tree binning over 512 Mbp
(bins 0..37449, 5 levels, 16 kb leaves) plus the 16 kb linear index, with
BGZF virtual offsets (coffset << 16 | uoffset).

The writer builds compatible .tbi files from BGZF VCFs, so authored VCFs are
immediately region-queryable — and indexes written by real tabix load
identically.
"""

from __future__ import annotations

import struct
from pathlib import Path

from variantformer_tpu_torch.utils.bgzf import BGZFReader, write_bgzf

TBI_MAGIC = b"TBI\x01"
# tabix VCF preset: seq col 1, begin col 2, end col 2, comment '#'
VCF_PRESET = dict(format=2, col_seq=1, col_beg=2, col_end=2, meta=ord("#"), skip=0)


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (0-based, half-open)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class TabixIndex:
    def __init__(self, path: str | Path):
        raw_reader = BGZFReader(path)  # .tbi files are themselves BGZF
        raw = b"".join(
            raw_reader._read_block(i) for i in range(len(raw_reader._coffs))
        )
        raw_reader.close()
        if raw[:4] != TBI_MAGIC:
            raise ValueError(f"{path}: not a tabix index")
        (n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm) = struct.unpack_from(
            "<8i", raw, 4
        )
        self.preset = dict(format=fmt, col_seq=col_seq, col_beg=col_beg,
                           col_end=col_end, meta=meta, skip=skip)
        off = 36
        names = raw[off : off + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        off += l_nm
        self.bins: list[dict[int, list[tuple[int, int]]]] = []
        self.linear: list[list[int]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _b in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = []
                for _c in range(n_chunk):
                    cbeg, cend = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((cbeg, cend))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            intv = list(struct.unpack_from(f"<{n_intv}Q", raw, off))
            off += 8 * n_intv
            self.bins.append(bins)
            self.linear.append(intv)

    def min_voffset(self, chrom: str, beg: int, end: int) -> int | None:
        """Smallest virtual offset whose chunk may overlap [beg, end)."""
        if chrom not in self.names:
            return None
        rid = self.names.index(chrom)
        lin = self.linear[rid]
        lin_min = lin[beg >> 14] if (beg >> 14) < len(lin) else (lin[-1] if lin else 0)
        best = None
        for b in reg2bins(beg, end):
            for cbeg, cend in self.bins[rid].get(b, ()):
                if cend <= lin_min:
                    continue
                if best is None or cbeg < best:
                    best = cbeg
        return best


def write_tbi(vcf_path: str, out_path: str | None = None) -> str:
    """Build a .tbi for a BGZF VCF (coordinate-sorted per chromosome)."""
    out_path = out_path or vcf_path + ".tbi"
    reader = BGZFReader(vcf_path)
    names: list[str] = []
    per_ref_bins: list[dict[int, list[tuple[int, int]]]] = []
    per_ref_linear: list[list[int]] = []

    def ref_index(name: str) -> int:
        if name not in names:
            names.append(name)
            per_ref_bins.append({})
            per_ref_linear.append([])
        return names.index(name)

    for voff, line in reader.stream_lines_with_voffsets():
        if not line or line.startswith(b"#"):
            continue
        fields = line.split(b"\t", 4)
        chrom = fields[0].decode()
        pos = int(fields[1])
        ref_len = len(fields[3])
        beg, end = pos - 1, pos - 1 + max(ref_len, 1)
        rid = ref_index(chrom)
        b = reg2bin(beg, end)
        # chunk begins are exact; ends are patched to the next chunk begin
        # after the scan (an over-approximation that only bounds reads)
        chunks = per_ref_bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff:
            chunks[-1] = (chunks[-1][0], voff + 1)
        else:
            chunks.append((voff, voff + 1))
        # linear index: 16kb windows -> min voffset
        win = beg >> 14
        lin = per_ref_linear[rid]
        while len(lin) <= win:
            lin.append(0)
        if lin[win] == 0 or voff < lin[win]:
            lin[win] = voff
    reader.close()

    # Close chunks: set each chunk end to the next chunk's begin (or max);
    # simple over-approximation keeps queries correct (ends only bound reads).
    for bins in per_ref_bins:
        all_chunks = sorted(c for lst in bins.values() for c in lst)
        ends = {}
        for i, (cbeg, _) in enumerate(all_chunks):
            ends[cbeg] = (
                all_chunks[i + 1][0] if i + 1 < len(all_chunks) else (cbeg | 0xFFFF) + (1 << 16)
            )
        for b in bins:
            bins[b] = [(cbeg, ends[cbeg]) for cbeg, _ in bins[b]]

    # fill linear-index gaps with the previous value
    for lin in per_ref_linear:
        last = 0
        for i, v in enumerate(lin):
            if v == 0:
                lin[i] = last
            else:
                last = v

    payload = bytearray()
    payload += TBI_MAGIC
    name_blob = b"".join(n.encode() + b"\x00" for n in names)
    payload += struct.pack(
        "<8i", len(names), VCF_PRESET["format"], VCF_PRESET["col_seq"],
        VCF_PRESET["col_beg"], VCF_PRESET["col_end"], VCF_PRESET["meta"],
        VCF_PRESET["skip"], len(name_blob),
    )
    payload += name_blob
    for rid in range(len(names)):
        bins = per_ref_bins[rid]
        payload += struct.pack("<i", len(bins))
        for bin_id in sorted(bins):
            chunks = bins[bin_id]
            payload += struct.pack("<Ii", bin_id, len(chunks))
            for cbeg, cend in chunks:
                payload += struct.pack("<QQ", cbeg, cend)
        lin = per_ref_linear[rid]
        payload += struct.pack("<i", len(lin))
        payload += struct.pack(f"<{len(lin)}Q", *lin)
    write_bgzf(out_path, bytes(payload))
    return out_path
