"""The port's VEP host path against the JAX package's, exactly.

The same seeded inputs go through both packages: the offset-tracking BPE
encoders (``encode_with_offsets``, ``encode_with_position``,
``splice_encode``) on the port's C++ and Python engines, ``GeneIntervalIndex``,
the eQTL scores (log2fc and Poisson, with and without an allele-frequency
file), ``pack_samples``' ``cre_pad_to``, ``VepSampleBuilder.build`` (the
VCF-backed path on the genome of ``tests/test_api_end_to_end.py``, both
strands and every variant type, and the precomputed-population path on
synthesised artifacts), the window-dedup pools and ``create_vcf_from_variant``
(the BGZF and ``.tbi`` bytes). Ids, offsets, samples, pools and bytes must be
equal; floats within 1e-12.
"""

import numpy as np
import pandas as pd
import pytest

from tests.test_api_end_to_end import fixture_env  # noqa: F401  (the genome fixture)
from tests.torch_port_helpers import load_jax_native, port_config
from variantformer_tpu.api.variantprocessor import VariantProcessor as JaxVariantProcessor
from variantformer_tpu.api.vcfprocessor import VCFProcessor as JaxVCFProcessor
from variantformer_tpu.config import DatasetConfig
from variantformer_tpu.data import pipeline as jax_pipeline
from variantformer_tpu.data import vep as jax_vep
from variantformer_tpu.utils import assets as jax_assets
from variantformer_tpu.utils import bpe as jax_bpe
from variantformer_tpu.utils import scoring as jax_scoring
from variantformer_tpu.utils.fasta import FastaReader as JaxFasta
from variantformer_tpu.utils.intervals import GeneIntervalIndex as JaxIndex
from variantformer_tpu.utils.vcf import VCFReader as JaxVCF
from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
from variantformer_tpu_torch.api.vcfprocessor import DataSources, VCFProcessor
from variantformer_tpu_torch.data import pipeline, vep
from variantformer_tpu_torch.utils import assets, retry, scoring
from variantformer_tpu_torch.utils.assets import resolve_vocab_path
from variantformer_tpu_torch.utils.bgzf import write_bgzf
from variantformer_tpu_torch.utils.bpe import BPETokenizer, splice_encode
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.intervals import GeneIntervalIndex
from variantformer_tpu_torch.utils.sequence import apply_snp
from variantformer_tpu_torch.utils.vcf import VCFReader

VOCAB = resolve_vocab_path("bpe_vocabulary_500.json")
ENGINES = ["native", "python"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    load_jax_native()


@pytest.fixture(autouse=True)
def _no_remote_fetch(monkeypatch):
    """No test reaches a network: a remote fetch of either package fails."""
    def refuse(self, rel, dst):
        raise AssertionError(f"remote fetch of {rel} attempted")

    monkeypatch.setattr(assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setattr(jax_assets.CachedFetcher, "_default_transport", refuse)


@pytest.fixture(scope="module")
def toks():
    """{engine: port tokenizer} and the JAX package's tokenizer."""
    return ({"native": BPETokenizer.from_file(VOCAB),
             "python": BPETokenizer.from_file(VOCAB, use_native=False)},
            jax_bpe.BPETokenizer.from_file(VOCAB))


def _dna(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


def _soup(rng, n):
    """DNA with N runs, IUPAC codes and lower case."""
    seq = list(_dna(rng, n))
    for _ in range(int(rng.integers(1, 4))):
        p = int(rng.integers(0, n - 8))
        seq[p:p + int(rng.integers(1, 6))] = "N" * int(rng.integers(1, 6))
    for p in rng.integers(0, len(seq), 6):
        seq[int(p)] = str(rng.choice(list("RYSWKMBDHVacgt")))
    return "".join(seq)


# -- offset-tracking BPE ------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offsets_and_positions_equal_jax(toks, engine, seed):
    port, ref = toks[0][engine], toks[1]
    rng = np.random.default_rng(seed)
    seq = _soup(rng, int(rng.integers(300, 3000)))
    for got, want in zip(port.encode_with_offsets(seq), ref.encode_with_offsets(seq)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for pos in list(rng.integers(0, len(seq), 25)) + [0, len(seq) - 1]:
        pos = int(pos)
        try:
            want = ref.encode_with_position(seq, pos)
        except ValueError as exc:
            with pytest.raises(ValueError, match="invalid character"):
                port.encode_with_position(seq, pos)
            assert "invalid character" in str(exc)
            continue
        got = port.encode_with_position(seq, pos)
        assert set(got) == set(want)
        for key in want:
            assert got[key] == want[key], (pos, key)
    with pytest.raises(ValueError, match="out of range"):
        port.encode_with_position(seq, len(seq))


def test_native_word_offsets_equal_python(toks):
    nat, py = toks[0]["native"], toks[0]["python"]
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 500):
        word = _dna(rng, n, "ACGTRYKW")
        assert nat._native.encode_word(word) == py._encode_word_py(word)
        ids, starts, ends = nat._native.encode_word_ids_offsets(word)
        assert [ids.tolist(), list(zip(starts.tolist(), ends.tolist()))] == list(
            py._encode_word_py(word))


@pytest.mark.parametrize("engine", ENGINES)
def test_splice_encode_equals_jax_randomized(toks, engine):
    """Edits of random sequences with N runs and IUPAC codes: every output of
    the port's splice_encode equals the JAX package's, and the spliced ids
    equal a full encode of the edited sequence."""
    port, ref = toks[0][engine], toks[1]
    rng = np.random.default_rng(5)
    for trial in range(25):
        seq = _soup(rng, int(rng.integers(200, 6000)))
        ids, st, en = port.encode_with_offsets(seq)
        while True:
            pos = int(rng.integers(0, len(seq)))
            if seq[pos] in "ACGT":
                break
        repl = ["A", "T", "W", "K", "N", "ACGTA"][int(rng.integers(0, 6))]
        got = splice_encode(port, seq, ids, st, en, pos, repl)
        want = jax_bpe.splice_encode(ref, seq, ids, st, en, pos, repl)
        assert got[1] == want[1], trial
        for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            np.testing.assert_array_equal(g, w, err_msg=f"trial={trial}")
        np.testing.assert_array_equal(
            got[0], port.encode_ids(seq[:pos] + repl + seq[pos + 1:]), err_msg=f"trial={trial}")


@pytest.mark.parametrize("engine", ENGINES)
def test_splice_encode_tiny_margin_falls_back_exact(toks, engine):
    """A pathological margin forces the escalation and the full fallback."""
    port, ref = toks[0][engine], toks[1]
    seq = _dna(np.random.default_rng(7), 500)
    ids, st, en = port.encode_with_offsets(seq)
    for pos in (0, 1, 250, 498, 499):
        got = splice_encode(port, seq, ids, st, en, pos, "W", margin=1)
        want = jax_bpe.splice_encode(ref, seq, ids, st, en, pos, "W", margin=1)
        np.testing.assert_array_equal(got[0], port.encode_ids(seq[:pos] + "W" + seq[pos + 1:]))
        for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
            np.testing.assert_array_equal(g, w)
    empty = splice_encode(port, "NNNN", *port.encode_with_offsets("NNNN"), 1, "A")
    np.testing.assert_array_equal(empty[0], port.encode_ids("NANN"))


# -- intervals, scores, packing --------------------------------------------------

def _gencode(rng, n=300):
    starts = rng.integers(0, 5_000_000, n)
    return pd.DataFrame({
        "gene_id": [f"G{i}.1" for i in range(n)],
        "gene_name": [f"G{i}" for i in range(n)],
        "chromosome": rng.choice(["chr1", "chr2", "chr7"], n),
        "start": starts, "end": starts + rng.integers(100, 400_000, n),
        "strand": rng.choice(["+", "-"], n),
    })


def test_gene_interval_index_equals_jax():
    rng = np.random.default_rng(0)
    gencode = _gencode(rng)
    for window in (1_000_000, 5_000):
        port, ref = GeneIntervalIndex(gencode, window), JaxIndex(gencode, window)
        for chrom in ("chr1", "chr2", "chr7", "chrX"):
            for pos in rng.integers(0, 6_000_000, 40):
                assert port.query(chrom, int(pos)) == ref.query(chrom, int(pos))
    variant = vep.Variant(chrom="1", pos=2_000_000, ref="A", alt="C", tissue=[0])
    jvariant = jax_vep.Variant(chrom="1", pos=2_000_000, ref="A", alt="C", tissue=[0])
    assert vep.get_probable_genes(gencode, variant) == jax_vep.get_probable_genes(
        gencode, jvariant)


def _score_frame(rng, pops, n=12):
    df = pd.DataFrame({
        "variant_id": [f"chr1_{100 + i}_A_C" for i in range(n)],
        "genes": rng.choice(["G1.1", "G2.1"], n), "tissues": "tissue0",
        "chr": ["chr1"] * (n // 2) + ["chr2"] * (n - n // 2),
        "pos": np.arange(100, 100 + n), "ref": "A", "alt": "C",
        "REF_HG38-0-exp": rng.random(n) * 5,
    })
    for pop in pops:
        for zyg in ("1", "2"):
            df[f"{pop}-{zyg}-exp"] = rng.random(n) * 5
    df.loc[3, "EUR-2-exp" if "EUR" in pops else "SAMPLE-2-exp"] = np.nan
    return df


@pytest.mark.parametrize("score", ["log2fc", "poisson"])
@pytest.mark.parametrize("mode", ["six_populations_af", "six_populations", "sample"])
def test_scores_equal_jax(tmp_path, score, mode):
    rng = np.random.default_rng(1)
    pops = ("REF_HG38", "SAMPLE") if mode == "sample" else (
        "REF_HG38", "EAS", "EUR", "AFR", "SAS", "AMR")
    df = _score_frame(rng, pops)
    af_path = None
    if mode == "six_populations_af":
        af_path = str(tmp_path)
        for chrom in ("chr1", "chr2"):
            sub = df[df["chr"] == chrom]
            af = pd.DataFrame({"chr": chrom, "pos": sub["pos"], "ref": "A", "alt": "C"})
            for pop in scoring.POPULATIONS:
                af[f"AF_{pop}"] = rng.random(len(sub)).round(4).astype(str)
            af.iloc[0, 4] = "."  # a missing frequency
            af.to_csv(tmp_path / f"1KG_hg38_af_{chrom}.tsv", sep="\t", index=False)
    fn = {"log2fc": "generate_log2fc_score", "poisson": "generate_poisson_score"}[score]
    got = getattr(scoring, fn)(df, af_path)
    want = getattr(jax_scoring, fn)(df, af_path)
    pd.testing.assert_frame_equal(got, want, rtol=1e-12, atol=1e-12)
    if mode == "six_populations_af":
        assert f"VF-agg-{'Poisson' if score == 'poisson' else 'log2fc'}-weighted" in got


def _samples(rng, module, n, length=16):
    out = []
    for i in range(n):
        c, g = int(rng.integers(0, 9)), int(rng.integers(1, 6))
        cre_len = rng.integers(0, length + 1, c).astype(np.int32)
        out.append(module.GeneSample(
            gene_id=f"G{i}", strand="+",
            cre_tokens=rng.integers(4, 500, (c, length)).astype(np.int32),
            cre_tok_len=cre_len, cre_labels=rng.integers(0, 9, c).astype(np.int32),
            gene_tokens=rng.integers(4, 500, (g, length)).astype(np.int32),
            gene_tok_len=rng.integers(1, length + 1, g).astype(np.int32),
        ))
    return out


@pytest.mark.parametrize("options", [
    {}, {"cre_pad_to": 1}, {"cre_pad_to": 64}, {"cre_pad_to": 65},
    {"cre_pad_to": 96}, {"cre_pad_to": 3, "bucket_step": 8, "gene_cap": None},
    {"cre_pad_to": 70, "gene_cap": 8},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "defaults")
def test_pack_samples_options_equal_jax(options):
    rng = np.random.default_rng(len(options))
    port_samples = _samples(rng, pipeline, 5)
    jax_samples = [jax_pipeline.GeneSample(**vars(s)) for s in port_samples]
    got = pipeline.pack_samples(port_samples, [2, 0, 5], **options)
    want = jax_pipeline.pack_samples(jax_samples, [2, 0, 5], **options)
    for name, leaf in got._asdict().items():
        other = getattr(want, name)
        assert (leaf is None) == (other is None), name
        if leaf is not None:
            assert leaf.dtype == np.asarray(other).dtype, name
            np.testing.assert_array_equal(leaf, np.asarray(other), err_msg=name)


def test_apply_snp_and_retry_loaders(tmp_path):
    assert apply_snp("ACGTA", 1, "C", "T", "het") == "AYGTA"
    assert apply_snp("ACGTA", 1, "C", "T", "hom") == "ATGTA"
    with pytest.raises(ValueError):
        apply_snp("ACGTA", 1, "C", "T", "ref")
    frame = pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})
    frame.to_csv(tmp_path / "f.csv", index=False)
    frame.to_pickle(tmp_path / "f.pkl.gz", compression="gzip")
    np.savez(tmp_path / "f.npz", sequence="ACGT,ACGT")
    pd.testing.assert_frame_equal(retry.multi_try_load_csv(tmp_path / "f.csv"), frame)
    pd.testing.assert_frame_equal(
        retry.multi_try_load_pickle(tmp_path / "f.pkl.gz", compression="gzip"), frame)
    assert str(retry.multi_try_load_npz(tmp_path / "f.npz")["sequence"]) == "ACGT,ACGT"


# -- VepSampleBuilder -------------------------------------------------------------

CFG = DatasetConfig(max_length=16, max_chunks=8, cre_neighbour_hood=5,
                    gene_upstream_neighbour_hood=20, gene_downstream_neighbour_hood=400)
# An extra CRE inside GENEMINUS's gene window [2100, 2520), so that the minus
# strand has "Gene and CRE overlap" variants too.
EXTRA_MINUS_CRE = {"chromosome": "chr1", "start_cre": 2200, "end_cre": 2270, "cre_name": "pELS"}


def _cre_maps(env):
    provider = env["sources"].cre_map_provider
    maps = {g: provider(g) for g in ("GENEPLUS.1", "GENEMINUS.1")}
    maps["GENEMINUS.1"] = pd.concat([maps["GENEMINUS.1"], pd.DataFrame([EXTRA_MINUS_CRE])],
                                    ignore_index=True)
    return maps


def _vep_builders(env, vcf=None):
    src = env["sources"]
    gencode = pd.read_csv(src.gencode_path)
    maps = _cre_maps(env)
    port = vep.VepSampleBuilder(pipeline.GeneSampleBuilder(
        port_config(CFG), FastaReader(src.fasta_path), BPETokenizer.from_file(VOCAB), gencode,
        maps.__getitem__, vcf=VCFReader(vcf) if vcf else None, snps_only=True))
    ref = jax_vep.VepSampleBuilder(jax_pipeline.GeneSampleBuilder(
        CFG, JaxFasta(src.fasta_path), jax_bpe.BPETokenizer.from_file(VOCAB), gencode,
        maps.__getitem__, vcf=JaxVCF(vcf) if vcf else None, snps_only=True))
    return port, ref


# (1-based position, alt) -> variant types over the two genes: 721 gene+CRE
# (+), 2230 gene+CRE (-), 321/130 CRE only (+), 1750 CRE only (-), 600 gene
# only (+), 2400 gene only (-), 50 no overlap; 2410 an insertion in a gene
# window (its het code is "N": an invalid character in both packages).
VARIANTS = [(721, None), (2230, None), (321, None), (130, None), (1750, None), (600, None),
            (2400, None), (50, None), (2410, "ins")]


def _variant(module, seq, pos, kind):
    ref = seq[pos - 1]
    alt = {"A": "G", "C": "T", "G": "A", "T": "C"}[ref]
    if kind == "ins":
        alt += "GT"
    return module.Variant(chrom="chr1", pos=pos, ref=ref, alt=alt, tissue=[0, 2])


def _assert_vep_samples_equal(got, want, ctx):
    assert (got.gene_id, got.variant_type) == (want.gene_id, want.variant_type), ctx
    assert len(got.samples) == len(want.samples), ctx
    for a, b in ((got.cre_token_position, want.cre_token_position),
                 *zip(got.gene_token_positions, want.gene_token_positions)):
        assert a == b or (np.isnan(a) and np.isnan(b)), (ctx, a, b)
    for zyg, (a, b) in enumerate(zip(got.samples, want.samples)):
        assert (a.gene_id, a.strand) == (b.gene_id, b.strand), ctx
        for field in ("cre_tokens", "cre_tok_len", "cre_labels", "gene_tokens", "gene_tok_len"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                          err_msg=f"{ctx} zyg={zyg} {field}")


@pytest.mark.parametrize("with_vcf", [False, True], ids=["hg38", "vcf"])
def test_vep_builder_equals_jax(fixture_env, with_vcf):
    port, ref = _vep_builders(fixture_env, fixture_env["vcf"] if with_vcf else None)
    seq = fixture_env["seq"]
    types = set()
    for gene_id in ("GENEPLUS.1", "GENEMINUS.1"):
        info = port.b.gene_info(gene_id)
        for pos, kind in VARIANTS:
            ctx = f"{gene_id} pos={pos} {kind or 'snp'}"
            try:
                want = ref.build(_variant(jax_vep, seq, pos, kind), info,
                                 validate_ref=not with_vcf)
            except ValueError as exc:
                with pytest.raises(ValueError) as got_exc:
                    port.build(_variant(vep, seq, pos, kind), info, validate_ref=not with_vcf)
                assert str(got_exc.value) == str(exc), ctx
                continue
            got = port.build(_variant(vep, seq, pos, kind), info, validate_ref=not with_vcf)
            _assert_vep_samples_equal(got, want, ctx)
            types.add((info["strand"], got.variant_type))
    assert types >= {(s, t) for s in "+-" for t in (
        "Gene and CRE overlap", "CRE overlap only", "Gene overlap only", "No overlap")}


def test_vep_builder_ref_entry_shared(fixture_env):
    port, _ = _vep_builders(fixture_env)
    info = port.b.gene_info("GENEPLUS.1")
    seq = fixture_env["seq"]
    first = port.build(_variant(vep, seq, 721, None), info)
    second = port.build(_variant(vep, seq, 600, None), info)
    assert first.samples[0] is second.samples[0]
    assert len(port._cache) <= port._cache_max


def test_concurrent_builds_match_serial(fixture_env, toks):
    """VariantProcessor builds samples on worker threads over one
    VepSampleBuilder (its ref-entry cache and per-key locks) and one native
    tokenizer (the C++ scratch is thread_local): concurrent builds and
    offset encodes must equal serial ones."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    port, _ = _vep_builders(fixture_env, fixture_env["vcf"])
    seq = fixture_env["seq"]
    jobs = [(g, pos) for g in ("GENEPLUS.1", "GENEMINUS.1") for pos, kind in VARIANTS
            if kind is None]
    infos = {g: port.b.gene_info(g) for g in ("GENEPLUS.1", "GENEMINUS.1")}
    serial_builder, _ = _vep_builders(fixture_env, fixture_env["vcf"])
    want = [serial_builder.build(_variant(vep, seq, pos, None), infos[g], validate_ref=False)
            for g, pos in jobs]
    nat = toks[0]["native"]
    rng = np.random.default_rng(13)
    seqs = [_soup(rng, int(rng.integers(500, 5000))) for _ in range(8)]
    want_offsets = [nat.encode_with_offsets(x) for x in seqs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = list(pool.map(
                lambda job: port.build(_variant(vep, seq, job[1], None), infos[job[0]],
                                       validate_ref=False),
                jobs * 3))
            offsets = list(pool.map(nat.encode_with_offsets, seqs * 4))
    finally:
        sys.setswitchinterval(interval)
    for i, sample in enumerate(got):
        _assert_vep_samples_equal(sample, want[i % len(jobs)], f"job {i}")
    for i, triple in enumerate(offsets):
        for g, w in zip(triple, want_offsets[i % len(seqs)]):
            np.testing.assert_array_equal(g, w)
    assert len(port._cache) == 2 and not port._key_locks


def _write_artifacts(root, seq, maps, populations):
    """Per-chromosome CRE pickles and per-gene npz files (with EUR carrying
    a background allele at 710), and their parquet manifests."""
    geno = root / "model" / "common" / "reference_genomes"
    geno.mkdir(parents=True)
    genes = {"GENEPLUS.1": ("+", 500, 1400), "GENEMINUS.1": ("-", 1600, 2500)}
    bg_pos = 710
    bg_alt = {"A": "C", "C": "G", "G": "T", "T": "A"}[seq[bg_pos - 1]]

    def pop_seq(pop, lo, hi):
        s = seq[lo:hi]
        if pop == "EUR" and lo < bg_pos <= hi:
            i = bg_pos - lo - 1
            s = s[:i] + bg_alt + s[i + 1:]
        return s

    cre_rows, gene_rows = [], []
    for pop in populations:
        name = "hg38" if pop == "REF_HG38" else pop
        rows = []
        for gid in genes:
            for r in maps[gid].itertuples(index=False):
                nb = CFG.cre_neighbour_hood
                lo, hi = int(r.start_cre) - nb, int(r.end_cre) + nb
                rows.append({"start": lo, "end": hi, "cre_name": r.cre_name,
                             f"{name}_sequence": f"{pop_seq(pop, lo, hi)},unused"})
        pkl = geno / f"chr1_{pop}.pkl.gz"
        pd.DataFrame(rows).sort_values("start").to_pickle(pkl, compression="gzip")
        cre_rows.append({"chromosome": "chr1", "population": pop, "file_path": str(pkl)})
        for gid, (strand, gs, ge) in genes.items():
            up, down = CFG.gene_upstream_neighbour_hood, CFG.gene_downstream_neighbour_hood
            w0, w1 = (max(gs, ge - down), ge + up) if strand == "-" else (
                max(0, gs - up), min(ge, gs + down))
            npz = geno / f"{gid}_{pop}.npz"
            np.savez(npz, sequence=f"{pop_seq(pop, w0, w1)},unused")
            gene_rows.append({"gene_id": gid, "population": pop, "file_path": str(npz)})
    pd.DataFrame(cre_rows).to_parquet(geno / "cres_seqs_manifest.parquet")
    pd.DataFrame(gene_rows).to_parquet(geno / "genes_seqs_manifest.parquet")


def test_vep_builder_precomputed_equals_jax(fixture_env, tmp_path, monkeypatch):
    monkeypatch.setenv("VFX_ARTIFACTS_DIR", str(tmp_path))
    seq = fixture_env["seq"]
    _write_artifacts(tmp_path, seq, _cre_maps(fixture_env), ("REF_HG38", "EUR", "AFR"))
    port, ref = _vep_builders(fixture_env)
    manifests = (assets.cre_sequences_manifest(), assets.gene_sequences_manifest())
    jax_manifests = (jax_assets.cre_sequences_manifest(), jax_assets.gene_sequences_manifest())
    eur_moved = False
    for pop in ("REF_HG38", "EUR", "AFR"):
        for gene_id in ("GENEPLUS.1", "GENEMINUS.1"):
            info = port.b.gene_info(gene_id)
            for pos, kind in VARIANTS[:-1]:
                ctx = f"{pop} {gene_id} pos={pos}"
                want = ref.build(_variant(jax_vep, seq, pos, kind), info,
                                 validate_ref=pop == "REF_HG38",
                                 precomputed=(pop, *jax_manifests))
                got = port.build(_variant(vep, seq, pos, kind), info,
                                 validate_ref=pop == "REF_HG38", precomputed=(pop, *manifests))
                _assert_vep_samples_equal(got, want, ctx)
                if pop == "EUR" and got.samples and gene_id == "GENEPLUS.1":
                    hg38 = port.build(_variant(vep, seq, pos, kind), info,
                                      precomputed=("REF_HG38", *manifests))
                    eur_moved |= not np.array_equal(got.samples[0].cre_tokens,
                                                    hg38.samples[0].cre_tokens)
    assert eur_moved, "EUR's background allele never reached its tokens"
    with pytest.raises(KeyError):
        port.build(_variant(vep, seq, 721, None), port.b.gene_info("GENEPLUS.1"),
                   precomputed=("SAS", *manifests))


# -- window-dedup pools ---------------------------------------------------------------

def _vep_batch(rng, d, c, g, length, shared=True):
    base_c = rng.integers(4, 30, (c, length)).astype(np.int32)
    base_g = rng.integers(4, 30, (g, length)).astype(np.int32)
    cre = np.tile(base_c, (d, 1, 1)) if shared else rng.integers(4, 30, (d, c, length))
    gene = np.tile(base_g, (d, 1, 1))
    for i in range(1, d):  # a few edited windows
        cre[i, int(rng.integers(0, c))] = rng.integers(4, 30, length)
        gene[i, int(rng.integers(0, g))] = rng.integers(4, 30, length)
    cre_len = np.tile(rng.integers(0, length + 1, c).astype(np.int32), (d, 1))
    gene_len = np.tile(rng.integers(1, length + 1, g).astype(np.int32), (d, 1))
    cre_len[:, -2:] = 0  # padding window slots
    return dict(
        cre_tokens=cre.astype(np.int32), cre_tok_len=cre_len,
        cre_count=np.full(d, c - 2, np.int32), cre_labels=np.zeros((d, c), np.int32),
        gene_tokens=gene, gene_tok_len=gene_len, gene_count=np.full(d, g, np.int32),
        tissue_ids=np.arange(3, dtype=np.int32),
    )


@pytest.mark.parametrize("case", ["triple", "six_rows", "overflow", "disabled"])
def test_dedup_windows_equal_jax(case, monkeypatch):
    from variantformer_tpu.models.seq2gene import Seq2GeneBatch as JaxBatch
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    if case == "disabled":
        monkeypatch.setenv("VFX_VEP_DEDUP", "0")
    rng = np.random.default_rng(["triple", "six_rows", "overflow", "disabled"].index(case))
    d = {"triple": 3, "six_rows": 6, "overflow": 3, "disabled": 3}[case]
    leaves = _vep_batch(rng, d, 12, 5, 8, shared=case != "overflow")
    slack = 4 if case == "overflow" else 64
    got = VariantProcessor._dedup_windows(Seq2GeneBatch(**leaves), slack=slack)
    want = JaxVariantProcessor._dedup_windows(JaxBatch(**leaves), slack=slack)
    for name, leaf in got._asdict().items():
        other = getattr(want, name)
        assert (leaf is None) == (other is None), name
        if leaf is not None:
            assert leaf.dtype == np.asarray(other).dtype, name
            np.testing.assert_array_equal(leaf, np.asarray(other), err_msg=name)
    if got.cre_pool_tokens is not None:
        np.testing.assert_array_equal(got.cre_pool_tokens[got.cre_gather], leaves["cre_tokens"])
        np.testing.assert_array_equal(got.gene_pool_len[got.gene_gather],
                                      leaves["gene_tok_len"])
    assert (got.cre_pool_tokens is None) == (case in ("overflow", "disabled"))


# -- create_vcf_from_variant ----------------------------------------------------------

def _port_sources(env):
    src = env["sources"]
    return DataSources(fasta_path=src.fasta_path, gencode_path=src.gencode_path,
                       bpe_vocab_path=src.bpe_vocab_path,
                       tissue_vocab_path=src.tissue_vocab_path,
                       cre_map_provider=src.cre_map_provider)


@pytest.mark.parametrize("merge", [False, True], ids=["new", "merged"])
def test_create_vcf_bytes_equal_jax(fixture_env, tmp_path, merge):
    seq = fixture_env["seq"]

    def alt(p):
        return {"A": "G", "C": "T", "G": "A", "T": "C"}[seq[p - 1]]

    donor = None
    if merge:
        donor = tmp_path / "donor.vcf.gz"
        lines = ["##fileformat=VCFv4.2", "##contig=<ID=chr1>",
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDONOR7"]
        lines += [f"chr1\t{p}\t.\t{seq[p - 1]}\t{alt(p)}\t.\tPASS\t.\tGT\t{gt}"
                  for p, gt in ((100, "0|1"), (200, "1|1"), (300, "1|0"), (2900, "0|1"))]
        write_bgzf(str(donor), ("\n".join(lines) + "\n").encode())
        donor = str(donor)
    def other(p):  # neither the reference base nor alt(p)
        return next(b for b in "ACGT" if b not in (seq[p - 1], alt(p)))

    # 150 twice (the last wins), 200 replaces the donor's record, 2950
    # follows the donor's last one
    new = pd.DataFrame({"chrom": "chr1", "pos": [150, 200, 2950, 150],
                        "ref": [seq[149], seq[199], seq[2949], seq[149]],
                        "alt": [alt(150), other(200), alt(2950), other(150)],
                        "GT": ["0|1", "0|1", "1|1", "1|1"]})
    port = VCFProcessor(sources=_port_sources(fixture_env), device="cpu")
    ref = JaxVCFProcessor(sources=fixture_env["sources"])
    got = port.create_vcf_from_variant(new, str(tmp_path / "port" / "out"), vcf_path=donor)
    want = ref.create_vcf_from_variant(new, str(tmp_path / "jax" / "out.vcf.gz"),
                                       vcf_path=donor)
    assert got.endswith("out.vcf.gz")
    for suffix in ("", ".tbi"):
        with open(got + suffix, "rb") as a, open(want + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    reader = VCFReader(got)
    positions = [v.pos for v in reader.query("chr1", 0, 3000)]
    assert positions == ([100, 150, 200, 300, 2900, 2950] if merge else [150, 200, 2950])
    assert reader.query("chr1", 0, 3000) == VCFReader(got, use_index=False).query("chr1", 0, 3000)
    with pytest.raises(ValueError, match="Reference mismatch"):
        port.create_vcf_from_variant(new.assign(ref="N"), str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="GT column"):
        port.create_vcf_from_variant(new.drop(columns="GT"), str(tmp_path / "bad"))
    if merge:  # a donor VCF out of coordinate order is refused
        unsorted = tmp_path / "unsorted.vcf.gz"
        write_bgzf(str(unsorted), ("\n".join(lines[:3] + [lines[5], lines[3]]) + "\n").encode())
        with pytest.raises(ValueError, match="not coordinate-sorted"):
            port.create_vcf_from_variant(new, str(tmp_path / "bad"), vcf_path=str(unsorted))
