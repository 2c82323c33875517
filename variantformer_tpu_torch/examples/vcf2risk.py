"""vcf2risk — Alzheimer's-disease risk from a donor VCF.

The port of ``examples/vcf2risk.py``: run vcf2exp for the gene-tissue
embeddings, then apply the per-(gene, tissue) gradient-boosted tree
predictors. Without the released predictors a demo GBT (scikit-learn) is
fitted on the spot so that the flow runs end to end.

    python -m variantformer_tpu_torch.examples.vcf2risk [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

from variantformer_tpu_torch.examples import _common


def demo_predictor(emb_dim: int, path: Path) -> str:
    """Fit a small GBT over ``emb_dim`` features and save it to ``path``."""
    from sklearn.ensemble import GradientBoostingClassifier

    from variantformer_tpu_torch.api.ad_risk import TreeEnsemble

    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, emb_dim)).astype(np.float32)
    y = (x[:, 0] > 0).astype(int)
    ens = TreeEnsemble.from_sklearn_gbm(
        GradientBoostingClassifier(n_estimators=10, max_depth=3, random_state=0).fit(x, y)
    )
    ens.save(str(path))
    return str(path)


class DemoManifest:
    """One predictor file for every (gene, tissue)."""

    def __init__(self, path: str):
        self.path = path

    def get_file_path(self, gene_id, tissue_id):
        return self.path


def main(root=None, device: str = "cuda"):
    from variantformer_tpu_torch.api.ad_risk import ADriskFromVCF

    root = Path(root or tempfile.mkdtemp(prefix="vfx_vcf2risk_"))
    proc, extras = _common.build_processor(root / "env", device)
    if _common.artifacts_present():
        ad = ADriskFromVCF(proc)
        out = ad(extras["vcf"], ["ENSG00000130203.9"], [7])
    else:
        path = demo_predictor(proc.config.seq2gene.emb_dim, root / "demo_gbt.npz")
        ad = ADriskFromVCF(proc, manifest=DemoManifest(path))
        out = ad(extras["vcf"], ["GENE1.1"], [0])
        print("[synthetic mode: demo GBT predictor]")
    print(out[["gene_id", "tissue_name", "ad_risk"]].to_string())

    from variantformer_tpu_torch.api.webapp import vcf2risk_app

    app = vcf2risk_app(out, root / "vcf2risk_app.html")
    print(f"interactive risk explorer: {app}")
    return out


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
