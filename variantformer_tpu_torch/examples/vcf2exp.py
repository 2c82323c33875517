"""vcf2exp — predict tissue-specific gene expression from a donor VCF.

The port of ``examples/vcf2exp.py``: query rows of (gene_id, comma-separated
tissues) against a VCF produce per-tissue expression predictions and
gene-tissue embeddings, and a single-file explorer page.

    python -m variantformer_tpu_torch.examples.vcf2exp [--device cpu] [--root DIR]
"""

import sys
import tempfile
import time
from pathlib import Path

import pandas as pd

from variantformer_tpu_torch.examples import _common


def main(root=None, device: str = "cuda"):
    root = Path(root or tempfile.mkdtemp(prefix="vfx_vcf2exp_"))
    proc, extras = _common.build_processor(root / "env", device)
    if _common.artifacts_present():
        query = pd.DataFrame(
            {
                "gene_id": ["ENSG00000130203.9"],  # APOE
                "tissues": ["brain - cortex,liver,whole blood"],
            }
        )
    else:
        query = pd.DataFrame(
            {"gene_id": ["GENE1.1", "GENE2.1"], "tissues": ["tissue0,tissue3"] * 2}
        )
    print("query:\n", query, "\n")
    t0 = time.time()
    out = proc.predict(extras["vcf"], query)
    print(f"predictions completed in {time.time() - t0:.1f}s\n")
    for _, row in out.iterrows():
        for name, value in zip(row["tissue_names"], row["predicted_expression"]):
            print(f"  {row['gene_id']:16s} {name:24s} {value:.4f}")

    # Reactive single-file explorer: gene selector + anatomagram + sortable
    # tissue table, all client-side.
    from variantformer_tpu_torch.api.webapp import vcf2exp_app

    app = vcf2exp_app(out, root / "vcf2exp_app.html")
    print(f"\ninteractive explorer: {app}")
    return out


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
