"""Shared helpers of the example flows: the released artifacts when they
are present, otherwise a self-contained synthetic genome with a tiny model
from a seed, so that every flow runs anywhere.

The port of ``examples/_common.py``. ``synthetic_env`` writes the same files,
byte for byte, with the same config; the real mode names the files that the
artifact downloader writes (``v4_pcg_epoch11_checkpoint.pth``,
``v4_ag_epoch9_checkpoint.pth``), and ``write_artifacts`` lays out such a
directory from a genome and a parameter tree.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd

from variantformer_tpu_torch.api.vcfprocessor import DataSources
from variantformer_tpu_torch.config import (
    DatasetConfig,
    ModelConfig,
    Seq2GeneConfig,
    WindowEncoderConfig,
)
from variantformer_tpu_torch.utils.assets import artifacts_dir, resolve_vocab_path

SEED = 0
FASTA = "GRCh38_no_alt_analysis_set_GCA_000001405.15.fasta.gz"
# The downloader's local names (data/download_artifacts.py ARTIFACTS).
CHECKPOINTS = {"v4_pcg": "v4_pcg_epoch11_checkpoint.pth",
               "v4_ag": "v4_ag_epoch9_checkpoint.pth"}
GENCODE = {"v4_pcg": "all_genes_v1_pcg_gencodeV24.csv",
           "v4_ag": "all_genes_ag_gencodeV24.csv"}
TOKENIZER_CHECKPOINT = "pretrained_tokenizers_checkpoint.pth"
DONOR_VCF = "HG00096.vcf.gz"


def artifacts_present() -> bool:
    base = artifacts_dir()
    return (base / CHECKPOINTS["v4_pcg"]).exists() and (base / FASTA).exists()


def real_sources(model_class: str = "v4_pcg") -> tuple[DataSources, ModelConfig]:
    base = artifacts_dir()
    sources = DataSources(
        fasta_path=str(base / FASTA),
        gencode_path=str(base / GENCODE[model_class]),
        checkpoint_path=str(base / CHECKPOINTS[model_class]),
        tokenizer_checkpoint_path=str(base / TOKENIZER_CHECKPOINT),
        af_path=str(base / "1KG_af_hg38_tables"),
    )
    return sources, ModelConfig(model_class=model_class)


def _write(path: Path, data: bytes | None = None, bgzf: bool = False) -> None:
    """Write through a per-process temporary name, then rename: processes
    that lay out the same environment never read a half-written file."""
    from variantformer_tpu_torch.utils.bgzf import write_bgzf

    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    if bgzf:
        write_bgzf(str(tmp), data)
    else:
        tmp.write_bytes(data)
    os.replace(tmp, path)


def synthetic_env(root: str | Path):
    """A 3 kb synthetic genome, a donor VCF and a tiny model config:
    ``(sources, cfg, extras)``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    chr_len = 3000
    seq = "".join(rng.choice(list("ACGT"), chr_len))
    fasta = root / "genome.fa"
    _write(fasta, (">chr1 synthetic\n" + "".join(
        seq[i:i + 60] + "\n" for i in range(0, chr_len, 60))).encode())
    gencode = root / "gencode.csv"
    _write(gencode, pd.DataFrame(
        [
            {"gene_id": "GENE1.1", "gene_name": "GENE1", "chromosome": "chr1",
             "start": 500, "end": 1400, "strand": "+"},
            {"gene_id": "GENE2.1", "gene_name": "GENE2", "chromosome": "chr1",
             "start": 1600, "end": 2500, "strand": "-"},
        ]
    ).to_csv(index=False).encode())
    cre_maps = {
        "GENE1.1": pd.DataFrame(
            [{"chromosome": "chr1", "start_cre": 300, "end_cre": 380, "cre_name": "dELS"},
             {"chromosome": "chr1", "start_cre": 700, "end_cre": 760, "cre_name": "pELS"}]
        ),
        "GENE2.1": pd.DataFrame(
            [{"chromosome": "chr1", "start_cre": 1700, "end_cre": 1780,
              "cre_name": "PLS,CTCF-bound"}]
        ),
    }
    ref = seq[320]
    alt = {"A": "G", "C": "T", "G": "A", "T": "C"}[ref]
    vcf = root / "donor.vcf.gz"
    _write(vcf, ("##fileformat=VCFv4.2\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
                 f"chr1\t321\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t0|1\n").encode(), bgzf=True)
    tissue_vocab = root / "tissues.yaml"
    _write(tissue_vocab, "".join(f"tissue{i}: {i}\n" for i in range(8)).encode())
    cfg = ModelConfig(
        window_encoder=WindowEncoderConfig(
            vocab_size=500, embedding_dim=32, num_heads=4, num_layers=2,
            ffn_hidden_dim=64, token_length=16,
        ),
        seq2gene=Seq2GeneConfig(
            emb_dim=32, gene_emb_dim=32, token_dim=32, num_heads=4,
            num_layers=2, ffn_hidden_dim=64,
        ),
        dataset=DatasetConfig(
            max_length=16, max_chunks=8, cre_neighbour_hood=5,
            gene_upstream_neighbour_hood=20, gene_downstream_neighbour_hood=400,
        ),
    )
    sources = DataSources(
        fasta_path=str(fasta),
        gencode_path=str(gencode),
        bpe_vocab_path=resolve_vocab_path("bpe_vocabulary_500.json"),
        tissue_vocab_path=str(tissue_vocab),
        cre_map_provider=lambda g: cre_maps[g],
    )
    return sources, cfg, {"vcf": str(vcf), "variant": ("chr1", 321, ref, alt)}


def synthetic_params(cfg: ModelConfig, device: str = "cuda") -> dict:
    """The synthetic model's weights: ``models/init.init_seq2gene`` from
    ``SEED`` on ``device``."""
    from variantformer_tpu_torch.models.init import init_seq2gene

    return init_seq2gene(cfg, SEED, device=device)


def write_artifacts(dest: Path, genome_fa: Path, gencode_csv: Path, cre_maps: dict,
                    params: dict, cfg) -> Path:
    """An artifacts directory under the names the artifact downloader writes
    (the ones ``real_sources`` reads), for a real-mode run on one's own
    genome and weights: the genome as a BGZF ``.fasta.gz`` (indexed here,
    before any process reads it), the gencode CSV, ``params`` as a
    reference-layout ``v4_pcg_epoch11_checkpoint.pth``, a tokenizer
    checkpoint with the CRE tokenizer's keys, and the CRE maps as per-gene
    CSVs behind ``model/common/cres_all_genes_manifest.parquet``."""
    import shutil

    import torch

    from variantformer_tpu_torch.models.convert import to_reference_state_dict
    from variantformer_tpu_torch.utils.bgzf import write_bgzf
    from variantformer_tpu_torch.utils.fasta import FastaReader

    dest.mkdir(parents=True, exist_ok=True)
    fasta = dest / FASTA
    write_bgzf(str(fasta), Path(genome_fa).read_bytes())
    FastaReader(str(fasta))
    shutil.copyfile(gencode_csv, dest / GENCODE["v4_pcg"])
    sd = to_reference_state_dict(params, cfg)
    hyper = {k: getattr(cfg.seq2gene, k) for k in (
        "emb_dim", "gene_emb_dim", "num_heads", "num_layers", "use_alibi", "use_context",
        "gene_pooling", "num_tissues", "token_dim", "only_cross_attention", "use_bigger_head")}
    torch.save({"state_dict": sd, "hyper_parameters": hyper},
               dest / CHECKPOINTS["v4_pcg"])
    tok_hyper = {k: getattr(cfg.window_encoder, k) for k in (
        "vocab_size", "embedding_dim", "num_heads", "num_layers", "num_tissues", "num_classes",
        "use_context", "positional_encoding", "seq_pool", "strand_agg")}
    torch.save({"state_dict": {k: v for k, v in sd.items() if k.startswith("cre_tokenizer.")},
                "hyper_parameters": tok_hyper}, dest / TOKENIZER_CHECKPOINT)
    (dest / "cre_maps").mkdir(exist_ok=True)
    rows = []
    for gene, cre in cre_maps.items():
        csv = dest / "cre_maps" / f"{gene}.csv"
        cre.to_csv(csv, index=False)
        rows.append({"gene_id": gene, "file_path": str(csv)})
    manifest = dest / "model" / "common" / "cres_all_genes_manifest.parquet"
    manifest.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows).to_parquet(manifest)
    return dest


def build_processor(synthetic_root: str | Path | None = None, device: str = "cuda"):
    """``(processor, extras)``: the released artifacts when present, else the
    synthetic environment under ``synthetic_root`` (``vfx_example`` under the
    temporary directory by default) with ``synthetic_params``.
    The processor runs on ``device`` (the card unless the caller asks for the
    CPU)."""
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor

    if artifacts_present():
        sources, cfg = real_sources()
        proc = VCFProcessor(sources=sources, config=cfg, device=device)
        proc.load_model()
        return proc, {"vcf": str(artifacts_dir() / DONOR_VCF)}
    sources, cfg, extras = synthetic_env(
        synthetic_root or Path(tempfile.gettempdir()) / "vfx_example")
    proc = VCFProcessor(sources=sources, config=cfg, device=device)
    proc.set_params(synthetic_params(cfg, device))
    print("[synthetic mode: released artifacts not found; using a tiny "
          "random model on a 3kb genome]")
    return proc, extras


def flow_args(description: str, argv=None, **extra) -> argparse.Namespace:
    """The flags every flow takes: ``--device`` (default ``cuda``) and
    ``--root`` (the work directory), plus ``extra`` as ``{flag: kwargs}``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--root", default=None, help="work directory (default: under TMPDIR)")
    for flag, kw in extra.items():
        ap.add_argument(flag, **kw)
    return ap.parse_args(argv)
