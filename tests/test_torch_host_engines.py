"""The port's host engines against its plain versions and the JAX package.

The same seeded inputs go through the port's C++ engines (``use_native``
default), the port's Python engines (``use_native=False``) and the JAX
package's engines, and must agree exactly: BPE ids, consensus strings and
applied counts (every case of ``tests/test_consensus_fixtures.py``),
``GeneSample``s (``chip_smoke.py``'s genome and a small one, with and without
a VCF), tabix indexes and queries, ``VCFStream``, the BGZF writers and
virtual-offset readers. Concurrent encodes and reads must equal serial ones,
two processes building the libraries at once must each load a whole one,
and ``use_native=True`` must raise when the compiler cannot run.
"""

import ctypes
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from tests.torch_port_helpers import load_jax_native, port_config
from variantformer_tpu.config import DatasetConfig
from variantformer_tpu.data.pipeline import GeneSampleBuilder as JaxBuilder
from variantformer_tpu.utils import bgzf as jax_bgzf
from variantformer_tpu.utils import tabix as jax_tabix
from variantformer_tpu.utils.bpe import BPETokenizer as JaxTokenizer
from variantformer_tpu.utils.fasta import FastaReader as JaxFasta
from variantformer_tpu.utils.vcf import ConsensusEngine as JaxEngine
from variantformer_tpu.utils.vcf import VCFReader as JaxVCF
from variantformer_tpu.utils.vcf import VCFStream as JaxStream
from variantformer_tpu.utils.vcf import VcfVariant as JaxVariant
from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
from variantformer_tpu_torch.utils import native
from variantformer_tpu_torch.utils.assets import resolve_vocab_path
from variantformer_tpu_torch.utils.bgzf import (
    BGZFReader,
    write_bgzf,
    write_bgzf_lines,
)
from variantformer_tpu_torch.utils.bpe import BPETokenizer
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.readahead import warm_page_cache
from variantformer_tpu_torch.utils.sequence import reverse_complement
from variantformer_tpu_torch.utils.tabix import TabixIndex, reg2bin, reg2bins, write_tbi
from variantformer_tpu_torch.utils.vcf import ConsensusEngine, VCFReader, VCFStream, VcfVariant

REPO = Path(__file__).resolve().parent.parent
VOCAB = resolve_vocab_path("bpe_vocabulary_500.json")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    load_jax_native()


@pytest.fixture(scope="module")
def toks():
    """(port native, port Python, JAX) tokenizers over the released vocabulary."""
    return (BPETokenizer.from_file(VOCAB), BPETokenizer.from_file(VOCAB, use_native=False),
            JaxTokenizer.from_file(VOCAB))


def _dna(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


# -- BPE --------------------------------------------------------------------

BPE_CASES = ["random", "iupac", "n_runs", "homopolymers", "lowercase_mixed", "single_chars",
             "empty", "all_n"]


def _bpe_case(name):
    rng = np.random.default_rng(BPE_CASES.index(name))
    return {
        "random": lambda: _dna(rng, 20_000),
        "iupac": lambda: _dna(rng, 5_000, "ACGTRYSWKMBDHV"),
        "n_runs": lambda: "NNN" + _dna(rng, 700) + "N" * 50 + _dna(rng, 900) + "NN-n",
        "homopolymers": lambda: "".join(b * int(k) for b, k in zip(
            rng.choice(list("ACGT"), 60), rng.integers(1, 90, 60))),
        "lowercase_mixed": lambda: _dna(rng, 3_000, "acgtACGTnN"),
        "single_chars": lambda: "A",
        "empty": lambda: "",
        "all_n": lambda: "NNNNNN",
    }[name]()


@pytest.mark.parametrize("case", BPE_CASES)
def test_bpe_ids_equal(toks, case):
    seq = _bpe_case(case)
    nat, py, ref = toks
    assert nat.use_native and not py.use_native
    want = ref.encode_ids(seq)
    np.testing.assert_array_equal(nat.encode_ids(seq), want)
    np.testing.assert_array_equal(py.encode_ids(seq), want)


def test_bpe_batch_is_one_native_call(toks):
    nat, py, ref = toks
    rng = np.random.default_rng(13)
    seqs = ["", "NNN", "ACGTNNNACGT"] + [_dna(rng, int(rng.integers(1, 3000)), "ACGTN")
                                         for _ in range(20)]
    before = dict(native.CALLS)
    got = nat.encode_ids_batch(seqs)
    assert native.CALLS["bpe_encode_batch"] == before["bpe_encode_batch"] + 1
    assert native.CALLS["bpe_encode"] == before["bpe_encode"]
    for g, p, r in zip(got, py.encode_ids_batch(seqs), ref.encode_ids_batch(seqs)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(p, r)


def test_concurrent_encodes_match_serial(toks):
    """NativeBPE handles are shared by threads; the C++ scratch is
    thread_local, so concurrent encodes must equal serial ones, and no
    native call may go uncounted."""
    nat = toks[0]
    rng = np.random.default_rng(11)
    seqs = [_dna(rng, int(rng.integers(500, 20_000)), "ACGTN") for _ in range(16)]
    expected = [nat.encode_ids(s).tolist() for s in seqs]
    words = sum(len(nat.normalize([s])) for s in seqs)
    before = dict(native.CALLS)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(lambda s: nat.encode_ids(s).tolist(), seqs * 4))
            batches = list(pool.map(
                lambda i: [a.tolist() for a in nat.encode_ids_batch(seqs[i:])], range(8)))
    finally:
        sys.setswitchinterval(interval)
    assert got == expected * 4
    assert batches == [expected[i:] for i in range(8)]
    assert native.CALLS["bpe_encode"] - before["bpe_encode"] == 4 * words
    assert native.CALLS["bpe_encode_batch"] - before["bpe_encode_batch"] == 8


# -- consensus --------------------------------------------------------------

# (id, reference slice, [(pos, ref, (allele0, allele1))], expected, applied,
#  snps_only, ref_mismatch): every case of tests/test_consensus_fixtures.py.
CONSENSUS_CASES = [
    *[(f"het_snp_{r}{a}", f"GG{r}GG", [(3, r, (r, a))], f"GG{c}GG", 1, False, "skip")
      for r, a, c in (("A", "G", "R"), ("C", "T", "Y"), ("C", "G", "S"), ("A", "T", "W"),
                      ("G", "T", "K"), ("A", "C", "M"))],
    ("hom_alt_snp", "AAAAA", [(3, "A", ("T", "T"))], "AATAA", 1, False, "skip"),
    ("hom_ref_call", "ACGTA", [(2, "C", ("C", "C"))], "ACGTA", 0, False, "skip"),
    ("multiallelic_het", "TTATT", [(3, "A", ("C", "G"))], "TTSTT", 1, False, "skip"),
    ("hom_insertion_shifts", "ACGTAC", [(2, "C", ("CTT", "CTT")), (5, "A", ("G", "G"))],
     "ACTTGTGC", 2, False, "skip"),
    ("hom_deletion", "ACGTAC", [(2, "CGT", ("C", "C"))], "ACAC", 1, False, "skip"),
    ("het_insertion", "ACGTAC", [(2, "C", ("C", "CTT"))], "ACTTGTAC", 1, False, "skip"),
    ("het_deletion", "ACGTAC", [(2, "CGT", ("CGT", "C"))], "ACAC", 1, False, "skip"),
    ("overlap_skipped", "ACGTAC", [(2, "CGT", ("C", "C")), (3, "G", ("T", "T"))],
     "ACAC", 1, False, "skip"),
    ("past_region_end", "ACGTA", [(4, "TAC", ("T", "T"))], "ACGTA", 0, False, "skip"),
    ("snps_only", "ACGTAC", [(2, "C", ("C", "CTT")), (5, "A", ("A", "G"))],
     "ACGTRC", 1, True, "skip"),
    ("ref_mismatch_skip", "ACGTAC", [(2, "T", ("G", "G")), (5, "A", ("G", "G"))],
     "ACGTGC", 1, False, "skip"),
    ("ref_mismatch_region_fallback", "ACGTAC",
     [(2, "C", ("G", "G")), (4, "G", ("A", "A")), (5, "A", ("G", "G"))],
     "ACGTAC", 0, False, "region_fallback"),
    ("region_fallback_overlap_applies", "ACGTAC",
     [(2, "CGT", ("C", "C")), (3, "X", ("T", "T"))], "ACAC", 1, False, "region_fallback"),
]


class _Fasta:
    def __init__(self, seq: str, offset: int = 0):
        self.seq, self.offset = seq, offset

    def fetch(self, chrom, start, end):
        return self.seq[start - self.offset: end - self.offset]


class _Vcf:
    def __init__(self, variants):
        self.variants = variants

    def query(self, chrom, start, end):
        return [v for v in self.variants if start < v.pos <= end]


def _four_engines(seq, records, snps_only=False, ref_mismatch="skip", start=0):
    """(sequence, applied) of the port's native and Python engines and the
    JAX package's native and Python engines on one region."""
    out = []
    for cls, var, kw in ((ConsensusEngine, VcfVariant, {}),
                         (ConsensusEngine, VcfVariant, {"use_native": False}),
                         (JaxEngine, JaxVariant, {"use_native": True}),
                         (JaxEngine, JaxVariant, {"use_native": False})):
        variants = [var(pos=p, ref=r, alleles=a) for p, r, a in records]
        eng = cls(_Fasta(seq, start), _Vcf(variants), ref_mismatch=ref_mismatch, **kw)
        out.append(eng.consensus("chr1", start, start + len(seq), snps_only=snps_only))
    return out


@pytest.mark.parametrize("case", CONSENSUS_CASES, ids=[c[0] for c in CONSENSUS_CASES])
def test_consensus_fixture(case):
    _, seq, records, expect, applied, snps_only, policy = case
    for result in _four_engines(seq, records, snps_only, policy):
        assert result == (expect, applied)


def test_consensus_region_offset():
    results = _four_engines("AAAAA", [(1003, "A", ("A", "T"))], start=1000)
    assert results == [("AAWAA", 1)] * 4


def test_ref_mismatch_policy_from_environment(monkeypatch):
    monkeypatch.setenv("VFX_CONSENSUS_REF_MISMATCH", "region_fallback")
    eng = ConsensusEngine(_Fasta("ACGTAC"), _Vcf([VcfVariant(4, "G", ("A", "A"))]))
    assert eng.ref_mismatch == "region_fallback"
    assert eng.consensus("chr1", 0, 6) == ("ACGTAC", 0)
    with pytest.raises(ValueError):
        ConsensusEngine(_Fasta("A"), ref_mismatch="abort")


def _variant_soup(rng, seq):
    """Random SNPs and indels, het and hom, some overlapping."""
    records, pos, n = [], 1, len(seq)
    while True:
        pos += int(rng.integers(1, 12))
        if pos + 4 >= n:
            return records
        ref = seq[pos - 1: pos - 1 + int(rng.integers(1, 4))]
        kind = int(rng.integers(0, 4))
        alt = str(rng.choice(list("ACGT")))
        ins = ref[0] + "".join(rng.choice(list("ACGT"), int(rng.integers(0, 3))))
        records.append([
            (pos, ref[0], (ref[0], alt)), (pos, ref[0], (alt, alt)),
            (pos, ref, (ins, ins)), (pos, ref, (ref, ins)),
        ][kind])


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_consensus_random_soups(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        seq = _dna(rng, int(rng.integers(50, 300)))
        records = _variant_soup(rng, seq)
        for snps_only in (False, True):
            results = _four_engines(seq, records, snps_only)
            assert all(r == results[1] for r in results), (seq, records, results)


def test_native_reverse_complement_matches_python():
    lib = native.get_seq_library()
    rng = np.random.default_rng(5)
    seq = _dna(rng, 1000, "ACGTRYSWKMBDHVNacgtryswkmbdhvn-")
    out = ctypes.create_string_buffer(len(seq))
    lib.vfx_reverse_complement(seq.encode(), len(seq), out)
    assert out.raw.decode() == reverse_complement(seq)


# -- GeneSamples ------------------------------------------------------------

FIELDS = ("cre_tokens", "cre_tok_len", "cre_labels", "gene_tokens", "gene_tok_len")


def _samples_equal(a, b):
    assert (a.gene_id, a.strand) == (b.gene_id, b.strand)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _three_builders(dcfg, fasta, gencode, provider, vcf, toks):
    """Port builders on the native and on the Python engines, and the JAX
    package's builder (its default engines)."""
    nat_tok, py_tok, jax_tok = toks
    port_cfg = port_config(dcfg)
    nat = GeneSampleBuilder(port_cfg, FastaReader(fasta), nat_tok, gencode, provider,
                            vcf=VCFReader(vcf) if vcf else None)
    fa, reader = FastaReader(fasta), VCFReader(vcf) if vcf else None
    py = GeneSampleBuilder(port_cfg, fa, py_tok, gencode, provider, vcf=reader)
    py.engine = ConsensusEngine(fa, reader, use_native=False)
    ref = JaxBuilder(dcfg, JaxFasta(fasta), jax_tok, gencode, provider,
                     vcf=JaxVCF(vcf) if vcf else None)
    assert nat.engine.use_native and not py.engine.use_native
    return nat, py, ref


@pytest.fixture(scope="module")
def smoke_genome(tmp_path_factory):
    """``chip_smoke.py``'s genome (4 genes with full 300 kb windows, 384 CREs
    each, a donor VCF of 400 SNPs), its .tbi written by ``tabix_checks``."""
    root = tmp_path_factory.mktemp("smoke_genome")
    cre_maps = chip_smoke.write_genome(root, chip_smoke.SEED)
    chip_smoke.tabix_checks(root, cre_maps)
    assert (root / "donor.vcf.gz.tbi").exists()
    return root, cre_maps


def test_smoke_genome_samples_equal(smoke_genome, toks):
    """The main path's batch: native engines == Python engines == the JAX
    package, sample for sample and leaf for leaf after packing."""
    root, cre_maps = smoke_genome
    builders = _three_builders(DatasetConfig(), str(root / "genome.fa"),
                               pd.read_csv(root / "gencode.csv"), cre_maps.get,
                               str(root / "donor.vcf.gz"), toks)
    assert builders[0].engine.vcf._index is not None, "the .tbi must be used"
    genes = [g for g, *_ in chip_smoke.GENES]
    nat, py, ref = ([b.build(g) for g in genes] for b in builders)
    for a, b, c in zip(nat, py, ref):
        _samples_equal(a, c)
        _samples_equal(b, c)
    assert [s.cre_tokens.shape[0] for s in nat] == [chip_smoke.CRES_PER_GENE] * 4
    pa, pb = pack_samples(nat, list(range(54))), pack_samples(py, list(range(54)))
    for name, leaf in pa._asdict().items():
        other = getattr(pb, name)
        assert (leaf is None) == (other is None)
        if leaf is not None:
            np.testing.assert_array_equal(leaf, other, err_msg=name)


@pytest.fixture(scope="module")
def small_genome(tmp_path_factory):
    """Two genes (one per strand) on a 6 kb chromosome; a BGZF donor VCF
    with SNPs, indels, a multi-allelic het and a REF mismatch in CREs."""
    root = tmp_path_factory.mktemp("small_genome")
    rng = np.random.default_rng(3)
    seq = _dna(rng, 6000)
    with open(root / "genome.fa", "w") as fh:
        fh.write(">chr1 small\n" + "\n".join(seq[i:i + 60] for i in range(0, 6000, 60)) + "\n")
    pd.DataFrame([
        {"gene_id": "GP.1", "gene_name": "GP", "chromosome": "chr1", "start": 900,
         "end": 2900, "strand": "+"},
        {"gene_id": "GM.1", "gene_name": "GM", "chromosome": "chr1", "start": 3200,
         "end": 5200, "strand": "-"},
    ]).to_csv(root / "gencode.csv", index=False)
    cre = lambda rows: pd.DataFrame(  # noqa: E731
        [{"chromosome": "chr1", "start_cre": a, "end_cre": b, "cre_name": n} for a, b, n in rows])
    cre_maps = {"GP.1": cre([(200, 300, "PLS"), (500, 620, "dELS"), (1500, 1580, "pELS")]),
                "GM.1": cre([(3300, 3400, "PLS,CTCF-bound"), (5500, 5600, "dELS")])}
    records = []
    for pos in range(210, 5590, 37):
        ref = seq[pos - 1]
        alt = "ACGT"[("ACGT".index(ref) + 1 + pos % 3) % 4]
        kind = pos % 5
        if kind == 0:
            records.append((pos, ref, alt, "0|1"))
        elif kind == 1:
            records.append((pos, ref, alt + "TT", "1|1"))
        elif kind == 2:
            records.append((pos, seq[pos - 1: pos + 2], ref, "0|1"))
        elif kind == 3:
            alt2 = "ACGT"[("ACGT".index(ref) + 2) % 4]
            records.append((pos, ref, f"{alt},{alt2}", "1|2"))
        else:
            records.append((pos, alt, ref, "1|1"))   # REF disagrees with the FASTA
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]
    lines += [f"chr1\t{p}\t.\t{r}\t{a}\t.\tPASS\t.\tGT\t{gt}" for p, r, a, gt in records]
    write_bgzf(str(root / "donor.vcf.gz"), ("\n".join(lines) + "\n").encode())
    return root, cre_maps


@pytest.mark.parametrize("with_vcf", [True, False], ids=["vcf", "reference"])
def test_small_genome_samples_equal(small_genome, toks, with_vcf):
    root, cre_maps = small_genome
    dcfg = DatasetConfig(max_length=32, max_chunks=16, cre_neighbour_hood=20,
                         gene_upstream_neighbour_hood=200, gene_downstream_neighbour_hood=1500)
    vcf = str(root / "donor.vcf.gz") if with_vcf else None
    builders = _three_builders(dcfg, str(root / "genome.fa"), pd.read_csv(root / "gencode.csv"),
                               cre_maps.get, vcf, toks)
    for g in ("GP.1", "GM.1"):
        nat, py, ref = (b.build(g) for b in builders)
        _samples_equal(nat, ref)
        _samples_equal(py, ref)


def test_concurrent_consensus_and_reads_match_serial(small_genome):
    """One FASTA reader, VCF reader and native engine shared by 8 threads."""
    root, _ = small_genome
    fasta = FastaReader(str(root / "genome.fa"))
    eng = ConsensusEngine(fasta, VCFReader(str(root / "donor.vcf.gz")))
    rng = np.random.default_rng(9)
    regions = [(int(a), int(a) + int(n)) for a, n in zip(rng.integers(0, 5500, 200),
                                                         rng.integers(1, 500, 200))]
    serial = [(fasta.fetch("chr1", a, b), eng.consensus("chr1", a, b)) for a, b in regions]
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(lambda r: (fasta.fetch("chr1", *r), eng.consensus("chr1", *r)),
                            regions * 3))
    assert got == serial * 3


# -- tabix, VCFStream, BGZF ------------------------------------------------

def _vcf_lines(rng, chroms=("chr1", "chr2"), span=200_000):
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1"]
    for chrom in chroms:
        pos = 100
        while pos < span:
            ref, alt = "ACGT"[rng.integers(4)], "ACGT"[rng.integers(4)]
            if ref != alt:
                gt = ["0|1", "1|1", "0|0", "./."][rng.integers(4)]
                lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t{gt}")
            pos += int(rng.integers(50, 2000))
    return lines


@pytest.fixture(scope="module")
def tabix_vcf(tmp_path_factory):
    """A two-chromosome BGZF VCF in small blocks (many block boundaries),
    indexed by the port's write_tbi and, beside it, by the JAX package's."""
    root = tmp_path_factory.mktemp("tabix")
    lines = _vcf_lines(np.random.default_rng(11))
    data = ("\n".join(lines) + "\n").encode()
    port_vcf, jax_vcf = root / "port.vcf.gz", root / "jax.vcf.gz"
    write_bgzf(str(port_vcf), data, block_size=512)
    jax_bgzf.write_bgzf(str(jax_vcf), data, block_size=512)
    assert port_vcf.read_bytes() == jax_vcf.read_bytes()
    assert write_tbi(str(port_vcf)) == str(port_vcf) + ".tbi"
    jax_tabix.write_tbi(str(jax_vcf))
    return port_vcf, jax_vcf, lines


def test_tabix_index_equals_jax(tabix_vcf):
    port_vcf, jax_vcf, _ = tabix_vcf
    assert Path(str(port_vcf) + ".tbi").read_bytes() == Path(str(jax_vcf) + ".tbi").read_bytes()
    idx = TabixIndex(str(port_vcf) + ".tbi")
    ref = jax_tabix.TabixIndex(str(jax_vcf) + ".tbi")
    assert idx.names == ref.names == ["chr1", "chr2"]
    assert idx.bins == ref.bins and idx.linear == ref.linear and idx.preset == ref.preset
    for beg, end in ((0, 1), (16383, 16385), (131071, 131073), (5_000, 1_200_000),
                     (0, 1 << 29)):
        assert reg2bin(beg, end) == jax_tabix.reg2bin(beg, end)
        assert reg2bins(beg, end) == jax_tabix.reg2bins(beg, end)


def _key(variants):
    return [(v.pos, v.ref, v.alleles) for v in variants]


def test_tabix_queries_equal_scan(tabix_vcf):
    """Indexed queries == the scan's == the JAX package's, on random regions,
    on one-record regions at every BGZF block boundary, at the first and
    last record of each contig, and past them."""
    port_vcf, jax_vcf, lines = tabix_vcf
    indexed, scan = VCFReader(str(port_vcf)), VCFReader(str(port_vcf), use_index=False)
    ref = JaxVCF(str(jax_vcf))
    assert indexed._index is not None and scan._index is None and ref._index is not None
    regions = []
    rng = np.random.default_rng(12)
    for _ in range(40):
        a = int(rng.integers(0, 200_000))
        regions.append((["chr1", "chr2"][rng.integers(2)], a, a + int(rng.integers(1, 30_000))))
    reader = BGZFReader(str(port_vcf))
    records = [(v >> 16, line.split(b"\t")) for v, line in reader.stream_lines_with_voffsets()
               if line and not line.startswith(b"#")]
    reader.close()
    # The first record that starts in each block, and the one before it
    # (which runs across the block boundary).
    edges = [i for i in range(1, len(records)) if records[i][0] != records[i - 1][0]]
    assert len(edges) > 10, "the VCF must span many blocks"
    for i in edges:
        for _, f in records[i - 1:i + 1]:
            p = int(f[1])
            regions += [(f[0].decode(), p - 1, p), (f[0].decode(), p - 2, p + 1)]
    for chrom in ("chr1", "chr2"):
        pos = [int(f[1]) for _, f in records if f[0].decode() == chrom]
        regions += [(chrom, pos[0] - 1, pos[0]), (chrom, pos[-1] - 1, pos[-1]),
                    (chrom, 0, pos[0] - 1), (chrom, pos[-1], pos[-1] + 100_000),
                    (chrom, 0, 1 << 28)]
    regions += [("chrX", 0, 1000), ("chr1", 0, 0)]
    for chrom, a, b in regions:
        want = _key(scan.query(chrom, a, b))
        assert _key(indexed.query(chrom, a, b)) == want, (chrom, a, b)
        assert _key(ref.query(chrom, a, b)) == want, (chrom, a, b)
    assert sum(len(scan.query(c, 0, 1 << 28)) for c in ("chr1", "chr2")) == sum(
        1 for line in lines[2:] if not line.endswith(("0|0", "./.")))


@pytest.mark.parametrize("tbi", [b"garbage", b"TBI\x01"], ids=["not_bgzf", "truncated"])
def test_unusable_index_falls_back_to_scan(tabix_vcf, tmp_path, tbi):
    port_vcf, _, _ = tabix_vcf
    vcf = tmp_path / "copy.vcf.gz"
    vcf.write_bytes(port_vcf.read_bytes())
    (tmp_path / "copy.vcf.gz.tbi").write_bytes(tbi if tbi == b"garbage" else
                                                jax_bgzf._compress_block(tbi))
    reader = VCFReader(str(vcf))
    assert reader._index is None
    assert _key(reader.query("chr1", 0, 50_000)) == _key(
        VCFReader(str(port_vcf)).query("chr1", 0, 50_000))


def test_vcf_stream_equals_scan_and_jax(tabix_vcf):
    port_vcf, jax_vcf, _ = tabix_vcf
    got = [(c, v.pos, v.ref, v.alleles) for c, v in VCFStream(str(port_vcf))]
    want = [(c, v.pos, v.ref, v.alleles) for c, v in JaxStream(str(jax_vcf))]
    scan = VCFReader(str(port_vcf), use_index=False)
    assert got == want
    assert [g[1:] for g in got] == [(v.pos, v.ref, v.alleles) for c in ("chr1", "chr2")
                                    for v in scan.query(c, 0, 1 << 28)]
    stream = VCFStream(str(port_vcf), sample="S1")
    assert len(list(stream)) == len(got) and stream.sample_names == ["S1"]


def test_write_bgzf_lines_and_index(tmp_path):
    lines = [f"line {i} " + "x" * (i % 97) for i in range(3000)]
    port, ref = tmp_path / "port.gz", tmp_path / "jax.gz"
    write_bgzf_lines(str(port), (s.encode() if i % 2 else s for i, s in enumerate(lines)),
                     block_size=4096)
    jax_bgzf.write_bgzf_lines(str(ref), lines, block_size=4096)
    assert port.read_bytes() == ref.read_bytes()
    reader = BGZFReader(str(port))
    assert [b.decode() for b in reader.stream_lines()] == lines
    reader.save_index()
    reopened = BGZFReader(str(port))  # from the .gzi
    assert (reopened._coffs, reopened._uoffs) == (reader._coffs, reader._uoffs)
    assert len(reader._coffs) > 10
    text = "\n".join(lines) + "\n"
    assert reopened.read_at(5000, 20000) == text.encode()[5000:25000]


def test_voffset_reads_serial_and_concurrent(tmp_path):
    lines = [f"rec{i}\t" + "ACGT" * (i % 40) for i in range(4000)]
    path = tmp_path / "v.gz"
    write_bgzf_lines(str(path), lines, block_size=3000)
    reader = BGZFReader(str(path))
    pairs = list(reader.stream_lines_with_voffsets())
    ref = jax_bgzf.BGZFReader(str(path))
    assert pairs == list(ref.stream_lines_with_voffsets())
    assert [line.decode() for _, line in pairs] == lines

    def read(i):
        voff, line = pairs[i]
        it = reader.read_lines_from_voffset(voff)
        return [next(it) for _ in range(3)]

    idx = list(range(0, len(pairs) - 3, 37))
    serial = [read(i) for i in idx]
    assert serial == [[line for _, line in pairs[i:i + 3]] for i in idx]
    with ThreadPoolExecutor(max_workers=8) as pool:
        assert list(pool.map(read, idx * 3)) == serial * 3
    with pytest.raises(ValueError):
        next(reader.read_lines_from_voffset((reader._coffs[1] + 1) << 16))


def test_warm_page_cache(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"x" * (1 << 20))
    t = warm_page_cache([str(p), None, str(tmp_path / "missing")], background=True)
    assert t is not None
    t.join(timeout=30)
    assert not t.is_alive()
    assert warm_page_cache([str(p)], background=False) is None


# -- the native build -------------------------------------------------------

def test_two_processes_build_at_once(tmp_path):
    """Two processes build both libraries into an empty build root at once;
    each loads a whole library and encodes correctly, and only the final
    names are left."""
    code = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        from variantformer_tpu_torch.utils import native
        native.BUILD_ROOT = Path({str(tmp_path / "build")!r})
        from variantformer_tpu_torch.utils.bpe import BPETokenizer
        from variantformer_tpu_torch.utils.vcf import ConsensusEngine
        Path(sys.argv[1]).touch()
        while not Path(sys.argv[2]).exists():  # start both builds together
            time.sleep(0.001)
        tok = BPETokenizer.from_file({VOCAB!r})
        ConsensusEngine(None)
        print(tok.encode_ids("ACGTACGTTTGACNNACGT").tolist())
    """)
    flags = [tmp_path / f"ready{i}" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(flags[i]), str(flags[1 - i])],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    want = str(BPETokenizer.from_file(VOCAB, use_native=False)
               .encode_ids("ACGTACGTTTGACNNACGT").tolist())
    assert [o.strip() for o, _ in outs] == [want, want]
    root = tmp_path / "build"
    built = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    name = native.build_dir().name
    assert built == [f"{name}/libvfxbpe.so", f"{name}/libvfxseq.so"]


def test_use_native_raises_when_the_build_cannot_run(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="use_native=False"):
        BPETokenizer.from_file(VOCAB)
    with pytest.raises(RuntimeError, match="use_native=False"):
        ConsensusEngine(_Fasta("ACGT"), _Vcf([]))
    # the plain versions need no build
    assert BPETokenizer.from_file(VOCAB, use_native=False).encode_ids("ACGT").size > 0
    assert ConsensusEngine(_Fasta("ACGT"), _Vcf([]), use_native=False).consensus(
        "chr1", 0, 4) == ("ACGT", 0)
    assert not list((tmp_path / "build").rglob("*.so"))

