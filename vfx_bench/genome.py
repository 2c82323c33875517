"""The synthetic genome, donors and training labels of a traffic mix, from the seed.

One chromosome of uniform random bases holds ``genes`` genes whose cis
windows (``window_up`` bp upstream of the TSS + ``window_down`` bp) are all
full, their window starts ``spacing`` bp apart (plus a seeded jitter), so
neighbouring windows overlap as real genes' do; half the genes, seeded,
are on the minus strand. The genes' CRE counts are the quantiles of a
log-normal (median ``cre_median``, sigma ``cre_sigma``) clipped to [cre_min,
cre_max], dealt to the genes in a seeded order, so that every seed has the
same sizes; the CREs are placed on a 400 bp grid inside the window with lengths 150-349 bp and a
reference cCRE class each. Each donor's VCF carries SNVs at ``snv_per_kb``
(``het_share`` heterozygous, the rest homozygous alternate), written as
BGZF with a tabix index, as users' VCFs come. The parameters sit in the
traffic file's ``genome`` group; what they stand for is said there.
"""

from __future__ import annotations

import struct
from statistics import NormalDist
import zlib
from pathlib import Path

import numpy as np

REF_CRES = (
    "CTCF-only,CTCF-bound", "DNase-H3K4me3", "DNase-H3K4me3,CTCF-bound", "PLS",
    "PLS,CTCF-bound", "dELS", "dELS,CTCF-bound", "pELS", "pELS,CTCF-bound",
)
CHROM = "chr1"


# -- BGZF and tabix -----------------------------------------------------------
_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_BLOCK = 65280


def _block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    head = b"\x1f\x8b\x08\x04" + b"\x00" * 6 + struct.pack("<HBBHH", 6, 0x42, 0x43, 2,
                                                             len(data) + 25)
    return head + data + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def write_vcf_bgzf(path: Path, header: list[str], records: list[tuple[int, str]]) -> None:
    """Write ``records`` ((1-based pos, line) on ``CHROM``, sorted) as a BGZF
    VCF, no line split across blocks, and its ``.tbi`` (bins and the 16 kb
    linear index from each record's virtual offset)."""
    blocks, voffs = [], []
    coff, buf = 0, bytearray()

    def flush():
        nonlocal coff, buf
        blk = _block(bytes(buf))
        blocks.append(blk)
        coff += len(blk)
        buf = bytearray()

    for line in header:
        buf += line.encode() + b"\n"
    for _, line in records:
        raw = line.encode() + b"\n"
        if len(buf) + len(raw) > _BLOCK:
            flush()
        voffs.append((coff << 16) | len(buf))
        buf += raw
    end_voff = (coff << 16) | len(buf)
    flush()
    path.write_bytes(b"".join(blocks) + _EOF)

    bins: dict[int, list[list[int]]] = {}
    linear: list[int] = []
    for i, (pos, _) in enumerate(records):
        beg = pos - 1
        nxt = voffs[i + 1] if i + 1 < len(voffs) else end_voff
        chunks = bins.setdefault(_reg2bin(beg, beg + 1), [])
        if chunks and chunks[-1][1] == voffs[i]:
            chunks[-1][1] = nxt
        else:
            chunks.append([voffs[i], nxt])
        win = beg >> 14
        while len(linear) <= win:
            linear.append(0)
        if linear[win] == 0:
            linear[win] = voffs[i]
    last = 0
    for i, v in enumerate(linear):
        linear[i] = v = v or last
        last = v
    name = CHROM.encode() + b"\x00"
    out = bytearray(b"TBI\x01")
    out += struct.pack("<8i", 1, 2, 1, 2, 2, ord("#"), 0, len(name)) + name
    out += struct.pack("<i", len(bins))
    for b in sorted(bins):
        out += struct.pack("<Ii", b, len(bins[b]))
        for cb, ce in bins[b]:
            out += struct.pack("<QQ", cb, ce)
    out += struct.pack("<i", len(linear)) + struct.pack(f"<{len(linear)}Q", *linear)
    Path(str(path) + ".tbi").write_bytes(_block(bytes(out)) + _EOF)


# -- the genome -----------------------------------------------------------------
class Genome:
    """Files under ``root``: ``genome.fa``, ``gencode.csv``, ``tissues.yaml``,
    ``donor<k>.vcf.gz`` (+ ``.tbi``); ``cre_maps`` gene_id -> DataFrame;
    ``genes`` the gene ids in order; ``seq`` the chromosome."""

    def __init__(self, root: Path, params: dict, seed: int, tissues: int):
        import pandas as pd

        p = params
        rng = np.random.default_rng([seed, 1])
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        n, up, down = p["genes"], p["window_up"], p["window_down"]
        span = up + down
        starts = p["margin"] + np.arange(n) * p["spacing"] + rng.integers(0, p["jitter"], n)
        length = int(starts[-1] + span + p["margin"])
        self.seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)].tobytes().decode()
        with open(self.root / "genome.fa", "w") as fh:
            fh.write(f">{CHROM} synthetic\n")
            for i in range(0, length, 60):
                fh.write(self.seq[i:i + 60] + "\n")
        strands = rng.permutation(np.arange(n) % 2 == 0)
        extra = rng.integers(0, p["gene_extra"], n)
        rows, self.cre_maps, self.genes = [], {}, []
        z = np.asarray([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        counts = rng.permutation(np.clip(np.round(p["cre_median"] * np.exp(p["cre_sigma"] * z)),
                                         p["cre_min"], p["cre_max"]).astype(int))
        for i in range(n):
            w0 = int(starts[i])
            gid = f"ENSG{i:08d}.1"
            if strands[i]:   # "+": TSS = start, window [start - up, start - up + down)
                s, e, strand = w0 + up, w0 + up + down + int(extra[i]), "+"
            else:            # "-": TSS = end, window [end - down, end + up)
                s, e, strand = w0 - int(extra[i]), w0 + down, "-"
            rows.append({"gene_id": gid, "gene_name": f"G{i}", "chromosome": CHROM,
                         "start": s, "end": e, "strand": strand})
            grid = np.arange(w0, w0 + span - 400, 400)
            cs = np.sort(rng.choice(grid, counts[i], replace=False))
            lens = rng.integers(150, 350, counts[i])
            names = rng.integers(0, len(REF_CRES), counts[i])
            self.cre_maps[gid] = pd.DataFrame({
                "chromosome": CHROM, "start_cre": cs, "end_cre": cs + lens,
                "cre_name": [REF_CRES[k] for k in names]})
            self.genes.append(gid)
        pd.DataFrame(rows).to_csv(self.root / "gencode.csv", index=False)
        self.tissue_names = [f"tissue{i}" for i in range(tissues)]
        (self.root / "tissues.yaml").write_text(
            "".join(f"{t}: {i}\n" for i, t in enumerate(self.tissue_names)))
        self.vcfs = []
        for k in range(p["donors"]):
            self.vcfs.append(self._donor(k, p, np.random.default_rng([seed, 2, k])))

    def _donor(self, k: int, p: dict, rng) -> str:
        length = len(self.seq)
        n = int(p["genes"] * p["spacing"] * p["snv_per_kb"] / 1000)
        pos = np.sort(rng.choice(np.arange(1, length + 1), n, replace=False))
        shift = rng.integers(1, 4, n)
        het = rng.random(n) < p["het_share"]
        recs = []
        for q, s, h in zip(pos.tolist(), shift.tolist(), het.tolist()):
            ref = self.seq[q - 1]
            alt = "ACGT"[("ACGT".index(ref) + s) % 4]
            recs.append((q, f"{CHROM}\t{q}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t{'0|1' if h else '1|1'}"))
        header = ["##fileformat=VCFv4.2", f"##contig=<ID={CHROM},length={length}>",
                  '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
                  f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDONOR{k}"]
        path = self.root / f"donor{k}.vcf.gz"
        write_vcf_bgzf(path, header, recs)
        return str(path)

    def expression(self, seed: int, donors: list[str]):
        """(gene_id, donor, tissue, TPM, FPKM) rows: every gene x donor x
        tissue, TPM log-normal from the seed."""
        import pandas as pd

        rng = np.random.default_rng([seed, 3])
        rows = []
        for g in self.genes:
            for d in donors:
                tpm = np.exp(rng.normal(1.5, 1.5, len(self.tissue_names)))
                rows += [{"gene_id": g, "donor": d, "tissue": t, "TPM": float(v),
                          "FPKM": float(v)} for t, v in zip(self.tissue_names, tpm)]
        return pd.DataFrame(rows)
