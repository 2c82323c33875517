"""vcf2embed — gene-tissue embedding extraction, clustering, 2D projection.

The port of ``examples/vcf2embed.py``: collect pooled gene-tissue embeddings
across genes x tissues, cluster them, project them to 2D (UMAP when
installed, PCA otherwise) and write an interactive HTML scatter with hover
tooltips and a reactive explorer.

    python -m variantformer_tpu_torch.examples.vcf2embed [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd

from variantformer_tpu_torch.examples import _common


def project_2d(embeddings: np.ndarray) -> np.ndarray:
    if len(embeddings) >= 4:  # UMAP needs n_neighbors >= 2 points of context
        try:
            import umap  # type: ignore

            return umap.UMAP(
                n_components=2, n_neighbors=min(30, len(embeddings) - 1),
                min_dist=0.05,
            ).fit_transform(embeddings)
        except ImportError:
            pass
    centered = embeddings - embeddings.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:2].T


def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """A small k-means: unsupervised clusters stand in for the GO
    categories of an annotation artifact that is not shipped."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    assign = np.zeros(len(x), np.int32)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new = d.argmin(1).astype(np.int32)
        if (new == assign).all():
            break
        assign = new
        for j in range(k):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return assign


def main(root=None, device: str = "cuda"):
    root = Path(root or tempfile.mkdtemp(prefix="vfx_vcf2embed_"))
    proc, extras = _common.build_processor(root / "env", device)
    if _common.artifacts_present():
        genes = ["ENSG00000130203.9", "ENSG00000000457.13"]
        tissues = "brain - cortex,liver,whole blood,thyroid"
    else:
        genes = ["GENE1.1", "GENE2.1"]
        tissues = "tissue0,tissue1,tissue2,tissue3"
    query = pd.DataFrame({"gene_id": genes, "tissues": [tissues] * len(genes)})
    out = proc.predict(extras["vcf"], query)

    rows, embs = [], []
    for _, row in out.iterrows():
        for name, emb, val in zip(
            row["tissue_names"], row["embeddings"], row["predicted_expression"]
        ):
            rows.append({
                "gene_id": row["gene_id"], "tissue": name,
                "predicted_expression": round(float(val), 4),
            })
            embs.append(np.asarray(emb, np.float32))
    embs = np.stack(embs)
    coords = project_2d(embs)
    df = pd.DataFrame(rows)
    df["x"], df["y"] = coords[:, 0], coords[:, 1]
    df["cluster"] = [
        f"cluster {c}" for c in kmeans(embs, k=min(4, len(embs)))
    ]
    print(df.to_string())
    print(f"\nembedding matrix: {embs.shape}, projected to 2D")

    from variantformer_tpu_torch.api.visualization import scatter_html
    from variantformer_tpu_torch.api.webapp import vcf2embed_app

    page = scatter_html(
        df, root / "vcf2embed_scatter.html", color="cluster",
        hover=["gene_id", "tissue", "predicted_expression"],
        title="Gene-tissue embeddings (2D projection)",
    )
    print(f"interactive scatter: {page}")
    app = vcf2embed_app(df, root / "vcf2embed_app.html")
    print(f"reactive embedding explorer: {app}")
    return df


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
