"""Asset resolution, cached fetching, and parquet-manifest lookups.

The port's copy of ``variantformer_tpu/utils/assets.py``: manifests are
parquet files loaded with pyarrow into plain dict indexes, and remote objects
are fetched through a process-safe cached fetcher (FileLock + double-check +
atomic hardlink publish). ``filelock``, ``pyarrow`` and ``fsspec`` are
imported where they are used, so nothing here needs them until a manifest is
read or an object fetched.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
from pathlib import Path

from variantformer_tpu_torch.utils.retry import retry_with_backoff

log = logging.getLogger(__name__)

DEFAULT_BUCKET = "czi-variantformer"
REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def artifacts_dir() -> Path:
    return Path(os.environ.get("VFX_ARTIFACTS_DIR", REPO_ROOT / "_artifacts"))


# The released vocabularies ship with the repository (vocabs/).
_VOCAB_SEARCH_PATHS = (
    lambda: os.environ.get("VFX_VOCAB_DIR"),
    lambda: REPO_ROOT / "vocabs",
    lambda: artifacts_dir() / "vocabs",
)


def resolve_vocab_path(name: str) -> str:
    for candidate in _VOCAB_SEARCH_PATHS:
        base = candidate()
        if base is None:
            continue
        path = Path(base) / name
        if path.exists():
            return str(path)
    raise FileNotFoundError(
        f"Vocabulary {name!r} not found; set VFX_VOCAB_DIR to its directory."
    )


class CachedFetcher:
    """Thread/process-safe download-once cache for remote or local objects.

    ``get`` maps a bucket-relative path to a local file under ``tmp_dir``,
    downloading on first access. Concurrent callers serialize on a file lock
    and publish via atomic hardlink, so exactly one download happens and every
    caller sees a complete file.
    """

    def __init__(self, bucket: str = DEFAULT_BUCKET, tmp_dir: str | Path | None = None,
                 transport=None):
        self.bucket = bucket
        self.tmp_dir = Path(tmp_dir or artifacts_dir())
        self.tmp_dir.mkdir(parents=True, exist_ok=True)
        self._transport = transport  # callable(remote_rel_path, local_tmp_path)

    def _default_transport(self, rel: str, dst_tmp: str):
        """Anonymous-S3 fetch via fsspec (requires network + s3fs)."""
        import fsspec

        with fsspec.open(f"s3://{self.bucket}/{rel}", "rb", anon=True) as src, open(
            dst_tmp, "wb"
        ) as out:
            shutil.copyfileobj(src, out)

    def get(self, path: str) -> str:
        rel = os.path.normpath(path).lstrip(os.sep)
        dst = os.path.realpath(self.tmp_dir / rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.exists(dst):
            return dst
        from filelock import FileLock

        lock_path = dst + ".lock"
        with FileLock(lock_path, timeout=600):
            if os.path.exists(dst):  # double-check after acquiring the lock
                return dst
            staging = dst + ".partial"
            transport = self._transport or self._default_transport

            def _attempt():
                if os.path.exists(staging):
                    os.unlink(staging)  # drop partial output of a failed try
                transport(rel, staging)

            # Transient store/network failures retry with backoff.
            retry_with_backoff(
                _attempt,
                timeout=float(os.environ.get("VFX_FETCH_RETRY_TIMEOUT", "120")),
                describe=f"fetch {rel}",
            )
            try:
                os.link(staging, dst)  # atomic publish on the same filesystem
            except FileExistsError:
                pass
            finally:
                if os.path.exists(staging):
                    os.unlink(staging)
        return dst


@dataclasses.dataclass
class ManifestRecord:
    file_path: str
    key: tuple


class ManifestLookup:
    """Exact-match lookup over a parquet manifest (pyarrow + dict index).

    Schema contract: the manifest has the ``index_columns`` plus a
    ``file_path`` column (same as the reference's manifests).
    """

    def __init__(
        self,
        manifest_path: str,
        index_columns: tuple[str, ...],
        fetcher: CachedFetcher | None = None,
    ):
        self.index_columns = index_columns
        self.fetcher = fetcher
        self._manifest_path = manifest_path
        self._index: dict[tuple, str] | None = None

    def _load(self):
        if self._index is not None:
            return
        import pyarrow.parquet as pq

        path = self._manifest_path
        if self.fetcher is not None and not os.path.exists(path):
            path = self.fetcher.get(path)
        table = pq.read_table(path, columns=[*self.index_columns, "file_path"])
        cols = [table.column(c).to_pylist() for c in self.index_columns]
        paths = table.column("file_path").to_pylist()
        self._index = {tuple(key): fp for *key, fp in zip(*cols, paths)}

    def get_record(self, *key) -> ManifestRecord | None:
        self._load()
        fp = self._index.get(tuple(key))
        return ManifestRecord(file_path=fp, key=tuple(key)) if fp else None

    def exists(self, *key) -> bool:
        self._load()
        return tuple(key) in self._index

    def get_unique(self, column: str) -> list:
        self._load()
        idx = self.index_columns.index(column)
        return sorted({k[idx] for k in self._index})

    def get_file_path(self, *key) -> str | None:
        record = self.get_record(*key)
        if record is None:
            return None
        fp = record.file_path
        if os.path.exists(fp):
            return fp
        if self.fetcher is not None:
            return self.fetcher.get(fp)
        return None


def _manifest(path_rel: str, cols: tuple[str, ...],
              fetcher: CachedFetcher | None = None) -> ManifestLookup:
    return ManifestLookup(path_rel, cols, fetcher=fetcher or CachedFetcher())


# Each manifest reads through ``fetcher`` (default: a ``CachedFetcher`` on
# the artifacts directory).

def gene_cre_manifest(fetcher: CachedFetcher | None = None) -> ManifestLookup:
    """gene_id -> per-gene CRE map CSV."""
    return _manifest("model/common/cres_all_genes_manifest.parquet", ("gene_id",), fetcher)


def gene_sequences_manifest(fetcher: CachedFetcher | None = None) -> ManifestLookup:
    """(gene_id, population) -> precomputed gene-sequence npz."""
    return _manifest(
        "model/common/reference_genomes/genes_seqs_manifest.parquet",
        ("gene_id", "population"), fetcher,
    )


def cre_sequences_manifest(fetcher: CachedFetcher | None = None) -> ManifestLookup:
    """(chromosome, population) -> precomputed per-chromosome CRE pickle."""
    return _manifest(
        "model/common/reference_genomes/cres_seqs_manifest.parquet",
        ("chromosome", "population"), fetcher,
    )


def gene_tissue_manifest(model_class: str = "v4_pcg",
                         fetcher: CachedFetcher | None = None) -> ManifestLookup:
    """(gene_id, tissue_id) -> serialized AD-risk GBT predictor."""
    return _manifest(
        f"alzheimer_disease/{model_class}/manifest.parquet",
        ("gene_id", "tissue_id"), fetcher,
    )
