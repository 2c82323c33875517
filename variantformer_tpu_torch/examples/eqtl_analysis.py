"""eqtl_analysis — per-tissue Spearman correlation of VariantFormer
aggregated log2fc scores against eQTL-catalog effect sizes.

The port of ``examples/eqtl_analysis.py``: given a dataframe of eQTL
associations (variant, gene, tissue, slope), score each variant with the
model and report per-tissue Spearman r between the model's log2fc and the
catalog slopes.

    python -m variantformer_tpu_torch.examples.eqtl_analysis [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd

from variantformer_tpu_torch.examples import _common
from variantformer_tpu_torch.examples.variant2exp import variant_processor


def spearman_by_tissue(scored: pd.DataFrame, slope_col: str, score_col: str):
    from scipy import stats

    out = []
    for tissue, group in scored.groupby("tissues"):
        if len(group) >= 3:
            r, p = stats.spearmanr(group[score_col], group[slope_col])
            out.append({"tissue": tissue, "spearman_r": r, "p": p, "n": len(group)})
    return pd.DataFrame(out)


def main(root=None, device: str = "cuda"):
    root = Path(root or tempfile.mkdtemp(prefix="vfx_eqtl_"))
    vp, extras = variant_processor(root / "env", device)
    if not extras:
        catalog = pd.read_parquet(
            vp.sources.af_path.replace("1KG_af_hg38_tables", "eqtl_catalog.parquet")
        )
        score_col = "VF-agg-log2fc-weighted"
        kwargs = {}
    else:
        # A multi-association catalog (SNVs spread across GENE1.1's cis
        # span), so that the per-tissue Spearman statistic has n >= 3.
        from variantformer_tpu_torch.utils.fasta import FastaReader

        fa = FastaReader(vp.sources.fasta_path)
        flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
        rows = []
        rng = np.random.default_rng(7)
        for pos in (260, 340, 520, 740, 900, 1200):
            ref = fa.fetch("chr1", pos - 1, pos).upper()
            if ref not in "ACGT":
                continue
            rows.append(
                {"chrom": "chr1", "pos": pos, "ref": ref, "alt": flip[ref],
                 "tissue": "tissue0,tissue2",
                 "slope": float(rng.normal(0.0, 0.5))}
            )
        catalog = pd.DataFrame(rows)
        score_col = "VF-SAMPLE-2-exp-log2fc"
        kwargs = {"vcf_path": extras["vcf"], "sample_name": "S1"}
        print(f"[synthetic mode: demo catalog of {len(catalog)} associations]")

    var_df = catalog[["chrom", "pos", "ref", "alt", "tissue"]]
    long_df = vp.predict(var_df, str(root / "vep"), **kwargs)
    # log2fc columns come from eqtl_scores in both modes; SAMPLE mode needs
    # no AF table.
    scores = vp.eqtl_scores(vp.format_scores(long_df))
    scored = scores.merge(
        catalog.assign(
            variant_id=catalog[["chrom", "pos", "ref", "alt"]].astype(str).agg("_".join, axis=1)
        )[["variant_id", "slope"]],
        on="variant_id",
    )
    result = spearman_by_tissue(scored, "slope", score_col)
    print(result.to_string() if len(result) else scored.to_string())
    return scored


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
