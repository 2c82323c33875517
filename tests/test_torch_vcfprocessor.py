"""The port's vcf2exp path against the JAX package's, on a synthetic genome.

The genome is that of ``tests/test_api_end_to_end.py`` (FASTA, bgzf VCF with
a het and a hom SNP, gencode with one gene on each strand, CRE maps). The
host pipelines of the two packages must agree exactly (tokens, lengths,
labels, packed batch leaves); ``predict`` at float32 within 1e-4, with the
same ``init_seq2gene`` weights brought across by the weight bridge.
"""

import jax
import numpy as np
import pandas as pd
import pytest

from tests.torch_port_helpers import port_config
from variantformer_tpu.api.vcfprocessor import DataSources as JaxSources
from variantformer_tpu.api.vcfprocessor import VCFProcessor as JaxProcessor
from variantformer_tpu.config import (
    DatasetConfig,
    ModelConfig,
    PrecisionPolicy,
    Seq2GeneConfig,
    WindowEncoderConfig,
)
from variantformer_tpu.data.pipeline import GeneSampleBuilder as JaxBuilder
from variantformer_tpu.data.pipeline import pack_samples as jax_pack
from variantformer_tpu.models.init import init_seq2gene
from variantformer_tpu.utils.bpe import BPETokenizer as JaxTokenizer
from variantformer_tpu.utils.fasta import FastaReader as JaxFasta
from variantformer_tpu.utils.vcf import VCFReader as JaxVCF
from variantformer_tpu_torch.api.vcfprocessor import DataSources, VCFProcessor
from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
from variantformer_tpu_torch.utils.bgzf import write_bgzf
from variantformer_tpu_torch.utils.bpe import BPETokenizer
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.vcf import VCFReader

GENES = ["GENEPLUS.1", "GENEMINUS.1"]


def _cfg() -> ModelConfig:
    return ModelConfig(
        window_encoder=WindowEncoderConfig(
            vocab_size=500, embedding_dim=16, num_heads=2, num_layers=2,
            ffn_hidden_dim=32, token_length=16,
        ),
        seq2gene=Seq2GeneConfig(
            emb_dim=24, gene_emb_dim=16, token_dim=16, num_heads=4,
            num_layers=2, ffn_hidden_dim=48,
        ),
        dataset=DatasetConfig(
            max_length=16, max_chunks=8, cre_neighbour_hood=5,
            gene_upstream_neighbour_hood=20, gene_downstream_neighbour_hood=400,
        ),
        precision=PrecisionPolicy(compute_dtype="float32"),
    )


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_genome")
    rng = np.random.default_rng(0)
    chr_len = 3000
    seq = "".join(rng.choice(list("ACGT"), chr_len))
    with open(root / "genome.fa", "w") as fh:
        fh.write(">chr1 synthetic\n")
        for i in range(0, chr_len, 60):
            fh.write(seq[i:i + 60] + "\n")
    pd.DataFrame([
        {"gene_id": "GENEPLUS.1", "gene_name": "PLUS", "chromosome": "chr1",
         "start": 500, "end": 1400, "strand": "+"},
        {"gene_id": "GENEMINUS.1", "gene_name": "MINUS", "chromosome": "chr1",
         "start": 1600, "end": 2500, "strand": "-"},
    ]).to_csv(root / "gencode.csv", index=False)
    cre_maps = {
        "GENEPLUS.1": pd.DataFrame([
            {"chromosome": "chr1", "start_cre": 100, "end_cre": 160, "cre_name": "PLS"},
            {"chromosome": "chr1", "start_cre": 300, "end_cre": 380, "cre_name": "dELS"},
            {"chromosome": "chr1", "start_cre": 700, "end_cre": 760, "cre_name": "pELS"},
        ]),
        "GENEMINUS.1": pd.DataFrame([
            {"chromosome": "chr1", "start_cre": 1700, "end_cre": 1780,
             "cre_name": "PLS,CTCF-bound"},
            {"chromosome": "chr1", "start_cre": 2600, "end_cre": 2660, "cre_name": "dELS"},
        ]),
    }
    ref1, ref2 = seq[320], seq[900]
    alt1 = {"A": "G", "C": "T", "G": "A", "T": "C"}[ref1]
    alt2 = {"A": "C", "C": "A", "G": "T", "T": "G"}[ref2]
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1",
        f"chr1\t321\t.\t{ref1}\t{alt1}\t.\tPASS\t.\tGT\t0|1",
        f"chr1\t901\t.\t{ref2}\t{alt2}\t.\tPASS\t.\tGT\t1|1",
        f"chr1\t1750\t.\t{seq[1749]}\t{'A' if seq[1749] != 'A' else 'C'}\t.\tPASS\t.\tGT\t0|1",
    ]
    write_bgzf(str(root / "donor.vcf.gz"), ("\n".join(lines) + "\n").encode())
    (root / "tissues.yaml").write_text("".join(f"tissue{i}: {i}\n" for i in range(8)))
    return {"root": root, "cre_maps": cre_maps, "vcf": str(root / "donor.vcf.gz")}


def _sources(genome, cls):
    root = genome["root"]
    return cls(
        fasta_path=str(root / "genome.fa"), gencode_path=str(root / "gencode.csv"),
        tissue_vocab_path=str(root / "tissues.yaml"),
        cre_map_provider=genome["cre_maps"].__getitem__,
    ).resolve_defaults()


def _builders(genome, vcf):
    cfg = _cfg().dataset
    sources = _sources(genome, DataSources)
    gencode = pd.read_csv(sources.gencode_path)
    port = GeneSampleBuilder(
        cfg=port_config(cfg), fasta=FastaReader(sources.fasta_path),
        tokenizer=BPETokenizer.from_file(sources.bpe_vocab_path), gencode=gencode,
        cre_map_provider=sources.cre_map_provider, vcf=VCFReader(vcf) if vcf else None,
    )
    ref = JaxBuilder(
        cfg=cfg, fasta=JaxFasta(sources.fasta_path),
        tokenizer=JaxTokenizer.from_file(sources.bpe_vocab_path), gencode=gencode,
        cre_map_provider=sources.cre_map_provider, vcf=JaxVCF(vcf) if vcf else None,
    )
    return port, ref


@pytest.mark.parametrize("with_vcf", [True, False], ids=["vcf", "reference"])
def test_host_pipeline_matches_exactly(genome, with_vcf):
    port, ref = _builders(genome, genome["vcf"] if with_vcf else None)
    ours = [port.build(g) for g in GENES]
    theirs = [ref.build(g) for g in GENES]
    for a, b in zip(ours, theirs):
        assert (a.gene_id, a.strand) == (b.gene_id, b.strand)
        for field in ("cre_tokens", "cre_tok_len", "cre_labels", "gene_tokens", "gene_tok_len"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    tissues = [0, 3, 5]
    pa = pack_samples(ours, tissues)
    pb = jax_pack(theirs, tissues)
    for name, leaf in pa._asdict().items():
        other = getattr(pb, name)
        if leaf is None:
            assert other is None, name
            continue
        assert leaf.dtype == np.asarray(other).dtype, name
        np.testing.assert_array_equal(leaf, np.asarray(other), err_msg=name)


def test_predict_matches_jax_f32(genome):
    cfg = _cfg()
    params = jax.tree.map(np.asarray, init_seq2gene(jax.random.key(0), cfg))
    query = pd.DataFrame({"gene_id": GENES, "tissues": ["tissue0,tissue3", "tissue0,tissue3"]})

    jax_proc = JaxProcessor(sources=_sources(genome, JaxSources), config=cfg, impl="xla")
    jax_proc.set_params(jax.tree.map(np.asarray, params))
    ref = jax_proc.predict(genome["vcf"], query)

    proc = VCFProcessor(sources=_sources(genome, DataSources), config=port_config(cfg),
                        device="cpu")
    proc.set_params(params)
    out = proc.predict(genome["vcf"], query)

    assert list(out["gene_id"]) == list(ref["gene_id"])
    for col in ("predicted_expression", "embeddings"):
        got, want = np.stack(out[col].to_list()), np.stack(ref[col].to_list())
        assert got.shape == want.shape, col
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=col)
    assert np.stack(out["predicted_expression"].to_list()).shape == (2, 2)


def test_variant_changes_prediction(genome):
    cfg = port_config(_cfg())
    proc = VCFProcessor(sources=_sources(genome, DataSources), config=cfg, device="cpu")
    from variantformer_tpu_torch.models.init import init_seq2gene as port_init

    proc.set_params(port_init(cfg, seed=1, device="cpu"))
    query = pd.DataFrame({"gene_id": ["GENEPLUS.1"], "tissues": ["tissue1"]})
    with_vcf = proc.predict(genome["vcf"], query)["predicted_expression"][0]
    without = proc.predict(None, query)["predicted_expression"][0]
    assert np.isfinite(with_vcf).all() and (with_vcf >= 0).all()
    assert not np.allclose(with_vcf, without), "a variant inside a CRE must change the prediction"


def test_validate_query_filters_unknown(genome):
    proc = VCFProcessor(sources=_sources(genome, DataSources),
                        config=port_config(_cfg()), device="cpu")
    query = pd.DataFrame({"gene_id": ["GENEPLUS.1", "NOPE.1"],
                          "tissues": ["tissue0,badtissue", "tissue0"]})
    validated = proc.validate_query(query)
    assert len(validated) == 1
    assert validated.iloc[0]["tissues"] == [0]
    with pytest.raises(ValueError):
        proc.validate_query(pd.DataFrame({"gene_id": ["NOPE.1"], "tissues": ["tissue0"]}))


def test_predict_needs_params(genome):
    proc = VCFProcessor(sources=_sources(genome, DataSources),
                        config=port_config(_cfg()), device="cpu")
    with pytest.raises(RuntimeError):
        proc.predict(None, pd.DataFrame({"gene_id": GENES[:1], "tissues": ["tissue0"]}))
