"""Location of the vocabularies shipped with the repository (``vocabs/``).

The port's part of ``variantformer_tpu/utils/assets.py``: the manifests and
the cached fetcher of remote artifacts are not ported yet.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def resolve_vocab_path(name: str) -> str:
    """Path of vocabulary file ``name``: ``$VFX_VOCAB_DIR``, then the
    repository's ``vocabs/``, then ``$VFX_ARTIFACTS_DIR/vocabs``."""
    candidates = [
        os.environ.get("VFX_VOCAB_DIR"),
        REPO_ROOT / "vocabs",
        Path(os.environ.get("VFX_ARTIFACTS_DIR", REPO_ROOT / "_artifacts")) / "vocabs",
    ]
    for base in candidates:
        if base is None:
            continue
        path = Path(base) / name
        if path.exists():
            return str(path)
    raise FileNotFoundError(
        f"Vocabulary {name!r} not found; set VFX_VOCAB_DIR to its directory."
    )
