"""variant2risk — in-silico mutation effect on Alzheimer's-disease risk.

The port of ``examples/variant2risk.py``: run the VariantProcessor with a
donor VCF so that the in-silico edit sits in the sample's genotype context,
take the per-(gene, tissue) embeddings at zygosity 0 (no edit) and 2
(homozygous edit), and score both with the per-(gene, tissue) GBT AD-risk
predictors: the risk delta is the in-silico mutation effect.

    python -m variantformer_tpu_torch.examples.variant2risk [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd

from variantformer_tpu_torch.examples import _common
from variantformer_tpu_torch.examples.variant2exp import variant_processor
from variantformer_tpu_torch.examples.vcf2risk import demo_predictor


def main(root=None, device: str = "cuda"):
    from variantformer_tpu_torch.api.ad_risk import ADrisk, load_predictor

    root = Path(root or tempfile.mkdtemp(prefix="vfx_variant2risk_"))
    vp, extras = variant_processor(root / "env", device)
    if not extras:
        var_df = pd.DataFrame(
            {"chrom": ["chr19"], "pos": [44908684], "ref": ["T"], "alt": ["C"],
             "tissue": ["brain - cortex"], "gene_id": ["ENSG00000130203"]}
        )
        from variantformer_tpu_torch.utils.assets import artifacts_dir

        vcf, sample = str(artifacts_dir() / _common.DONOR_VCF), "HG00096"
        predictor_path = None  # resolved per (gene, tissue) via the manifest
    else:
        chrom, pos, ref, alt = extras["variant"]
        var_df = pd.DataFrame(
            {"chrom": [chrom], "pos": [pos], "ref": [ref], "alt": [alt],
             "tissue": ["tissue0,tissue2"]}
        )
        vcf, sample = extras["vcf"], "S1"
        predictor_path = demo_predictor(vp.config.seq2gene.emb_dim, root / "demo_gbt.npz")
        print("[synthetic mode: demo GBT predictor]")

    preds = vp.predict(var_df, str(root / "vep"), vcf_path=vcf, sample_name=sample)

    # zygosity 0 = sample context without the edit; 2 = homozygous edit.
    baseline = preds[(preds["zygosity"] == "0") & (preds["sample_name"] == sample)]
    edited = preds[(preds["zygosity"] == "2") & (preds["sample_name"] == sample)]

    def risk_for(row):
        emb = np.asarray(row.gene_emb).reshape(1, -1)
        if predictor_path is None:
            return float(ADrisk(row.genes, vp.tissue_vocab[row.tissues])(emb)[0])
        return float(load_predictor(predictor_path)(emb)[0])

    rows = []
    for (_, b), (_, e) in zip(baseline.iterrows(), edited.iterrows()):
        assert b.genes == e.genes and b.tissues == e.tissues
        r0, r2 = risk_for(b), risk_for(e)
        rows.append(
            {"gene": b.genes, "tissue": b.tissues,
             "risk_no_edit": r0, "risk_hom_edit": r2, "delta": r2 - r0}
        )
    out = pd.DataFrame(rows)
    print("\nin-silico AD-risk effect:\n", out.to_string(index=False))
    return out


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
