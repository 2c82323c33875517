"""variant2exp — variant-effect prediction (VEP) and eQTL scoring.

The port of ``examples/variant2exp.py``: each variant is scored as
ref/het/hom against nearby genes, pivoted into {POP}-{zyg}-exp columns, and
reduced to log2 fold-change eQTL scores.

    python -m variantformer_tpu_torch.examples.variant2exp [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import pandas as pd

from variantformer_tpu_torch.examples import _common


def variant_processor(root: Path, device: str):
    """``(VariantProcessor, extras)``: the released artifacts when present
    (``extras`` empty), else the synthetic environment under ``root``."""
    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor

    if _common.artifacts_present():
        sources, cfg = _common.real_sources()
        vp = VariantProcessor(sources=sources, config=cfg, device=device)
        vp.load_model()
        return vp, {}
    sources, cfg, extras = _common.synthetic_env(root)
    vp = VariantProcessor(sources=sources, config=cfg, device=device)
    vp.set_params(_common.synthetic_params(cfg, device))
    return vp, extras


def main(root=None, device: str = "cuda"):
    root = Path(root or tempfile.mkdtemp(prefix="vfx_variant2exp_"))
    vp, extras = variant_processor(root / "env", device)
    if not extras:
        var_df = pd.DataFrame(
            {
                "chrom": ["chr19"], "pos": [44908684], "ref": ["T"], "alt": ["C"],
                "tissue": ["brain - cortex,liver"],
                "gene_id": ["ENSG00000130203"],
            }
        )
        vcf, sample = None, None
    else:
        chrom, pos, ref, alt = extras["variant"]
        var_df = pd.DataFrame(
            {"chrom": [chrom], "pos": [pos], "ref": [ref], "alt": [alt],
             "tissue": ["tissue0,tissue2"]}
        )
        vcf, sample = extras["vcf"], "S1"
        print("[synthetic mode]")

    long_df = vp.predict(var_df, str(root / "vep"), vcf_path=vcf, sample_name=sample)
    scores = vp.format_scores(long_df)
    print("\npivoted scores:\n", scores.head().to_string())
    eqtl = vp.eqtl_scores(scores)
    print("\neQTL log2fc columns:", [c for c in eqtl.columns if "log2fc" in c])
    print(eqtl.head().to_string())
    return eqtl


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
