"""Artifact downloader: fetch the released model and data artifacts from the
public bucket into the local artifacts directory.

The port's copy of ``variantformer_tpu/data/download_artifacts.py``, built on
the port's process-safe cached fetcher (``utils/assets.py``): files already
present are skipped, and concurrent invocations converge on one download.
The local names below are the ones the example flows and the launchers read
in real mode (``examples/_common.py``). Fetching needs network access, and
``fsspec`` with ``s3fs`` for the bucket; the two transports import them when
they run, so importing this module, ``--list`` and ``validate`` need neither.

Usage:
    python -m variantformer_tpu_torch.data.download_artifacts [--only SUBSTR] [--list]
        [--dest DIR] [--prefixes] [--no-gold-locus]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import shutil

from variantformer_tpu_torch.utils import assets
from variantformer_tpu_torch.utils.assets import CachedFetcher, artifacts_dir

log = logging.getLogger(__name__)

BUCKET = "czi-variantformer"


@dataclasses.dataclass(frozen=True)
class Artifact:
    remote_key: str   # bucket-relative S3 key, or a full http(s) URL
    local_path: str   # path under the artifacts dir

    @property
    def is_url(self) -> bool:
        return self.remote_key.startswith("http")


# The local names that real mode reads (examples/_common.py).
FASTA = "GRCh38_no_alt_analysis_set_GCA_000001405.15.fasta.gz"
CHECKPOINTS = {"v4_pcg": "v4_pcg_epoch11_checkpoint.pth",
               "v4_ag": "v4_ag_epoch9_checkpoint.pth"}
GENCODE = {"v4_pcg": "all_genes_v1_pcg_gencodeV24.csv",
           "v4_ag": "all_genes_ag_gencodeV24.csv"}
TOKENIZER_CHECKPOINT = "pretrained_tokenizers_checkpoint.pth"
DONOR_VCF = "HG00096.vcf.gz"

# Vocabulary/config data files ship in the reference's git repo (not the S3
# bucket); fetch them from raw.githubusercontent for standalone deployments.
_REF_RAW = "https://raw.githubusercontent.com/czi-ai/variantformer/main"
VOCAB_ARTIFACTS = [
    Artifact(f"{_REF_RAW}/vocabs/bpe_vocabulary_500.json",
             "vocabs/bpe_vocabulary_500.json"),
    Artifact(f"{_REF_RAW}/vocabs/bpe_vocabulary_500_using_huggingface.json",
             "vocabs/bpe_vocabulary_500_using_huggingface.json"),
    Artifact(f"{_REF_RAW}/vocabs/tissue_vocab.yaml", "vocabs/tissue_vocab.yaml"),
    Artifact(f"{_REF_RAW}/vocabs/tissue_prob.yaml", "vocabs/tissue_prob.yaml"),
    Artifact(f"{_REF_RAW}/vocabs/dataset_vocab.yaml", "vocabs/dataset_vocab.yaml"),
]


def _af_tables():
    chroms = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]
    return [
        Artifact(
            f"data/1KG_af_hg38_tables/1KG_hg38_af_{c}.tsv",
            f"1KG_af_hg38_tables/1KG_hg38_af_{c}.tsv",
        )
        for c in chroms
    ]


ARTIFACTS: list[Artifact] = [
    # gene annotations + tokenizer/model checkpoints
    Artifact("model/v4_ag/all_genes_gencodeV24.csv", GENCODE["v4_ag"]),
    Artifact("model/v4_pcg/all_genes_gencodeV24.csv", GENCODE["v4_pcg"]),
    Artifact("model/v4_pcg/tokenizer_checkpoint.pth", TOKENIZER_CHECKPOINT),
    Artifact("model/v4_ag/checkpoint.pth", CHECKPOINTS["v4_ag"]),
    Artifact("model/v4_pcg/checkpoint.pth", CHECKPOINTS["v4_pcg"]),
    # reference genome + example donor VCF + cCRE bed
    Artifact(f"data/{FASTA}", FASTA),
    Artifact(f"data/{DONOR_VCF}", DONOR_VCF),
    Artifact(f"data/{DONOR_VCF}.tbi", f"{DONOR_VCF}.tbi"),
    Artifact("model/common/ENCFF234XEZ.bed.gz", "ENCFF234XEZ.bed.gz"),
    # gold regression artifacts
    Artifact("gold_data/f9bbc0ba.pq", "f9bbc0ba.pq"),
    Artifact("gold_data/a0063c48.pq", "a0063c48.pq"),
    Artifact("gold_data/9a83db58.pq", "9a83db58.pq"),
    Artifact("gold_data/924979a7.pq", "924979a7.pq"),
    Artifact("gold_data/befd2388.npz", "befd2388.npz"),
    Artifact("gold_data/be73e19a.pq", "be73e19a.pq"),
    Artifact("gold_data/b23c9b69.pq", "b23c9b69.pq"),
    # parquet manifests addressing the per-population precomputed sequences
    # and the per-(gene, tissue) AD predictors (utils/assets.py)
    Artifact("model/common/cres_all_genes_manifest.parquet",
             "model/common/cres_all_genes_manifest.parquet"),
    Artifact("model/common/reference_genomes/genes_seqs_manifest.parquet",
             "model/common/reference_genomes/genes_seqs_manifest.parquet"),
    Artifact("model/common/reference_genomes/cres_seqs_manifest.parquet",
             "model/common/reference_genomes/cres_seqs_manifest.parquet"),
    Artifact("alzheimer_disease/v4_pcg/manifest.parquet",
             "alzheimer_disease/v4_pcg/manifest.parquet"),
    Artifact("alzheimer_disease/v4_ag/manifest.parquet",
             "alzheimer_disease/v4_ag/manifest.parquet"),
    # example precomputed population sequences (APOE locus)
    Artifact(
        "model/common/reference_genomes/data_split/hg38/cres/data_split/hg38_chr19.pkl.gz",
        "reference_genomes/data_split/hg38/cres/data_split/hg38_chr19.pkl.gz",
    ),
    Artifact(
        "model/common/reference_genomes/data/hg38/genes/data/ENSG00000130203.9_hg38.npz",
        "reference_genomes/data/hg38/genes/data/ENSG00000130203.9_hg38.npz",
    ),
    *_af_tables(),
    *VOCAB_ARTIFACTS,
]

# Bulk per-population mirrors (tens of GB each), fetched only with
# --prefixes. A trailing "/" marks a prefix: every object under it is
# downloaded.
PREFIX_ARTIFACTS: list[Artifact] = [
    Artifact("model/common/reference_genomes/data_split/",
             "reference_genomes/data_split/"),
    Artifact("model/common/reference_genomes/data/",
             "reference_genomes/data/"),
    Artifact("alzheimer_disease/v4_pcg/", "alzheimer_disease/v4_pcg/"),
    Artifact("alzheimer_disease/v4_ag/", "alzheimer_disease/v4_ag/"),
]

# Loci of the gold-parity checks: every (gene|chrom) x population
# combination present in the manifests is resolved through the downloaded
# manifests, with no guessing of file names.
GOLD_GENES = ["ENSG00000185989.10", "ENSG00000130203.9"]
GOLD_CHROMS = ["chr13", "chr19"]
GOLD_AD_PREDICTORS = [("ENSG00000130203.9", 7)]


def download_gold_locus_data(dest: str | None = None) -> list[str]:
    """Stage 2: resolve the gold loci through the (already downloaded)
    parquet manifests under ``dest`` (default: the artifacts directory) and
    fetch every per-population file they address."""
    fetcher = CachedFetcher(bucket=BUCKET, tmp_dir=dest) if dest else None
    fetched: list[str] = []

    def _fetch_all(lookup, keys_per_population):
        try:
            populations = lookup.get_unique("population")
        except Exception:
            populations = [None]
        for key_head in keys_per_population:
            for pop in populations:
                key = (key_head,) if pop is None else (key_head, pop)
                try:
                    path = lookup.get_file_path(*key)
                except Exception as exc:  # file absent in bucket: record, go on
                    log.warning("gold locus fetch failed %s: %s", key, exc)
                    continue
                if path:
                    fetched.append(path)
                    log.info("ok %s", path)

    _fetch_all(assets.gene_sequences_manifest(fetcher), GOLD_GENES)
    _fetch_all(assets.cre_sequences_manifest(fetcher), GOLD_CHROMS)
    # gene -> CRE-map CSVs (single-key manifest)
    gm = assets.gene_cre_manifest(fetcher)
    for gene in GOLD_GENES:
        path = gm.get_file_path(gene)
        if path:
            fetched.append(path)
            log.info("ok %s", path)
    for model_class in ("v4_pcg", "v4_ag"):
        tm = assets.gene_tissue_manifest(model_class, fetcher)
        for gene, tissue in GOLD_AD_PREDICTORS:
            try:
                path = tm.get_file_path(gene, tissue)
            except Exception as exc:
                log.warning("AD predictor fetch failed (%s,%s): %s", gene, tissue, exc)
                continue
            if path:
                fetched.append(path)
                log.info("ok %s", path)
    return fetched


def validate(include_prefixes: bool = True) -> None:
    """Offline sanity: no two artifacts may share a local path, and prefixes
    and only prefixes end with '/'. Raises ValueError on violation."""
    arts = ARTIFACTS + (PREFIX_ARTIFACTS if include_prefixes else [])
    seen: dict[str, str] = {}
    for art in arts:
        if art.local_path in seen:
            raise ValueError(
                f"duplicate local path {art.local_path!r}: "
                f"{seen[art.local_path]!r} and {art.remote_key!r}"
            )
        seen[art.local_path] = art.remote_key
        if art in PREFIX_ARTIFACTS:
            if not (art.remote_key.endswith("/") and art.local_path.endswith("/")):
                raise ValueError(f"prefix artifact must end with '/': {art}")
        elif art.remote_key.endswith("/"):
            raise ValueError(f"non-prefix artifact ends with '/': {art}")


def _fetch_s3(key: str, dst: str) -> None:
    """Anonymous S3 read of ``key`` in the bucket into ``dst``."""
    import fsspec

    with fsspec.open(f"s3://{BUCKET}/{key}", "rb", anon=True) as src, open(dst, "wb") as out:
        shutil.copyfileobj(src, out)


def _fetch_url(url: str, dst: str) -> None:
    import urllib.request

    with urllib.request.urlopen(url) as src, open(dst, "wb") as out:
        shutil.copyfileobj(src, out)


def _expand_prefix(art: Artifact) -> list[Artifact]:
    """List every object under a trailing-'/' prefix as single-file artifacts."""
    import fsspec

    fs = fsspec.filesystem("s3", anon=True)
    out = []
    for key in fs.find(f"{BUCKET}/{art.remote_key}"):
        rel = key.removeprefix(f"{BUCKET}/")
        sub = rel.removeprefix(art.remote_key)
        if not sub or sub.endswith("/"):
            continue
        out.append(Artifact(rel, art.local_path + sub))
    return out


def download(
    only: str | None = None,
    dest: str | None = None,
    prefixes: bool = False,
    gold_locus: bool = True,
) -> list[str]:
    """Fetch every artifact (``only``: those whose key or local path holds
    that substring) into ``dest`` (default: the artifacts directory); with
    ``prefixes`` the bulk mirrors too, and unless ``only`` is given or
    ``gold_locus`` is false, the gold loci the manifests address. Returns
    the local paths."""
    validate()
    worklist = list(ARTIFACTS)
    if prefixes:
        for art in PREFIX_ARTIFACTS:
            worklist.extend(_expand_prefix(art))
    by_local = {art.local_path: art for art in worklist}

    def transport(rel: str, dst_tmp: str) -> None:
        art = by_local[rel]
        (_fetch_url if art.is_url else _fetch_s3)(art.remote_key, dst_tmp)

    fetcher = CachedFetcher(bucket=BUCKET, tmp_dir=dest or artifacts_dir(), transport=transport)
    done = []
    for art in worklist:
        if only and only not in art.remote_key and only not in art.local_path:
            continue
        path = fetcher.get(art.local_path)
        log.info("ok %s", path)
        done.append(path)
    if gold_locus and not only:
        done.extend(download_gold_locus_data(dest))
    return done


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", help="substring filter on artifact paths")
    ap.add_argument("--dest", help="artifacts directory (default: _artifacts, or "
                                   "VFX_ARTIFACTS_DIR)")
    ap.add_argument("--list", action="store_true", help="list artifacts and exit")
    ap.add_argument("--prefixes", action="store_true",
                    help="also mirror the bulk per-population/AD prefixes (tens of GB)")
    ap.add_argument("--no-gold-locus", action="store_true",
                    help="skip the manifest-resolved gold-locus stage")
    args = ap.parse_args(argv)
    if args.list:
        validate()
        for art in ARTIFACTS + PREFIX_ARTIFACTS:
            print(f"{art.remote_key} -> {art.local_path}")
        return
    download(args.only, args.dest, prefixes=args.prefixes,
             gold_locus=not args.no_gold_locus)


if __name__ == "__main__":
    main()
