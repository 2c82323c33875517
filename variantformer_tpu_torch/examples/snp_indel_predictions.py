"""snp_indel_predictions — VCF authoring + SNP/indel expression effects.

The port of ``examples/snp_indel_predictions.py``: author a VCF from a
variant dataframe (SNPs, an insertion, a deletion), merge a second variant
set into it, predict expression with the merged VCF and with the plain
reference genome, and report the per-(gene, tissue) deltas.

    python -m variantformer_tpu_torch.examples.snp_indel_predictions [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import pandas as pd

from variantformer_tpu_torch.examples import _common


def _variant_sets(proc):
    """(set1 with SNPs+indels, set2 to merge, query_df) for either mode."""
    from variantformer_tpu_torch.utils.fasta import FastaReader

    fasta = FastaReader(proc.sources.fasta_path)
    if _common.artifacts_present():
        # APOE-adjacent variants.
        def ref_at(pos, n=1):
            return fasta.fetch("chr19", pos - 1, pos - 1 + n)

        set1 = pd.DataFrame(
            [
                {"chrom": "chr19", "pos": 44900754, "ref": ref_at(44900754),
                 "alt": "G", "GT": "0/1"},
                {"chrom": "chr19", "pos": 44906754, "ref": ref_at(44906754),
                 "alt": "T", "GT": "1/1"},
                {"chrom": "chr19", "pos": 44908684, "ref": ref_at(44908684),
                 "alt": "C", "GT": "0/1"},
                # insertion + deletion
                {"chrom": "chr19", "pos": 44905000, "ref": ref_at(44905000),
                 "alt": ref_at(44905000) + "AG", "GT": "0/1"},
                {"chrom": "chr19", "pos": 44907000, "ref": ref_at(44907000, 3),
                 "alt": ref_at(44907000), "GT": "1/1"},
            ]
        )
        set2 = pd.DataFrame(
            [{"chrom": "chr19", "pos": 44910754, "ref": ref_at(44910754),
              "alt": "A" if ref_at(44910754) != "A" else "C", "GT": "0/1"}]
        )
        query = pd.DataFrame(
            {"gene_id": ["ENSG00000130203.9"],
             "tissues": ["whole blood,liver"]}
        )
        return set1, set2, query

    def ref_at(pos, n=1):
        return fasta.fetch("chr1", pos - 1, pos - 1 + n)

    def snp_alt(base):
        return {"A": "G", "C": "T", "G": "A", "T": "C"}[base.upper()]

    # Variants inside GENE1's CRE/window neighbourhood on the 3kb genome.
    set1 = pd.DataFrame(
        [
            {"chrom": "chr1", "pos": 350, "ref": ref_at(350),
             "alt": snp_alt(ref_at(350)), "GT": "0/1"},          # het SNP
            {"chrom": "chr1", "pos": 720, "ref": ref_at(720),
             "alt": snp_alt(ref_at(720)), "GT": "1/1"},          # hom SNP
            {"chrom": "chr1", "pos": 600, "ref": ref_at(600),
             "alt": ref_at(600) + "AG", "GT": "0/1"},            # insertion
            {"chrom": "chr1", "pos": 900, "ref": ref_at(900, 3),
             "alt": ref_at(900), "GT": "1/1"},                   # deletion
        ]
    )
    set2 = pd.DataFrame(
        [{"chrom": "chr1", "pos": 1000, "ref": ref_at(1000),
          "alt": snp_alt(ref_at(1000)), "GT": "0/1"}]
    )
    query = pd.DataFrame({"gene_id": ["GENE1.1"], "tissues": ["tissue0,tissue3"]})
    return set1, set2, query


def main(root=None, device: str = "cuda"):
    root = Path(root or tempfile.mkdtemp(prefix="vfx_snp_indel_"))
    proc, _ = _common.build_processor(root / "env", device)

    set1, set2, query = _variant_sets(proc)
    print(f"variant set 1 ({len(set1)} records: SNPs + indels):")
    print(set1.to_string(index=False))

    vcf1 = proc.create_vcf_from_variant(set1, str(root / "set1.vcf.gz"))
    print(f"\nwrote {vcf1}")
    vcf_merged = proc.create_vcf_from_variant(
        set2, str(root / "merged.vcf.gz"), vcf_path=vcf1
    )
    from variantformer_tpu_torch.utils.vcf import VCFReader

    n1 = sum(len(v[1]) for v in VCFReader(vcf1, use_index=False)._by_chrom.values())
    n2 = sum(
        len(v[1]) for v in VCFReader(vcf_merged, use_index=False)._by_chrom.values()
    )
    print(f"merged {vcf_merged}: {n1} -> {n2} records")
    assert n2 == n1 + len(set2)

    pred_var = proc.predict(str(vcf_merged), query)
    pred_ref = proc.predict(None, query)
    rows = []
    for (_, rv), (_, rr) in zip(pred_var.iterrows(), pred_ref.iterrows()):
        for i, name in enumerate(rv["tissue_names"]):
            v, r = float(rv["predicted_expression"][i]), float(
                rr["predicted_expression"][i]
            )
            rows.append(
                {"gene_id": rv["gene_id"], "tissue": name,
                 "with_variants": v, "reference": r, "delta": v - r}
            )
    deltas = pd.DataFrame(rows)
    print("\nvariant-vs-reference expression:\n", deltas.to_string(index=False))
    return deltas


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
