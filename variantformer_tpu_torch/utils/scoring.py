"""VEP / eQTL scoring math: log2 fold-change, Poisson CDF scores, and
population-allele-frequency-weighted aggregation.

The port's copy of ``variantformer_tpu/utils/scoring.py``: scores are
computed per population column against the REF_HG38 zygosity-0 expression,
then averaged across populations weighted by 1000-Genomes allele
frequencies.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

POPULATIONS = ("AFR", "AMR", "EAS", "EUR", "SAS")
_EPS = 1e-10


def merge_pop_stat(df: pd.DataFrame, af_path: str) -> pd.DataFrame:
    """Join per-chromosome 1KG allele-frequency TSVs onto variant rows."""
    merged = []
    for chrom in df["chr"].unique():
        af_file = os.path.join(af_path, f"1KG_hg38_af_{chrom}.tsv")
        af_df = pd.read_csv(af_file, sep="\t")
        chr_df = df[df["chr"] == chrom].copy()
        merged.append(
            chr_df.merge(af_df, on=["chr", "pos", "ref", "alt"], how="left")
            .reset_index(drop=True)
        )
    out = pd.concat(merged, ignore_index=True)
    for pop in POPULATIONS:
        col = f"AF_{pop}"
        if col in out.columns:
            out[col] = pd.to_numeric(out[col].replace(".", np.nan), errors="coerce")
    return out


def _pop_exp_columns(df: pd.DataFrame) -> list[str]:
    prefixes = tuple(f"{p}-2" for p in POPULATIONS) + ("REF_HG38-2", "SAMPLE-2")
    return [c for c in df.columns if c.startswith(prefixes)]


def gene_pop_agg_score(
    df: pd.DataFrame, score_cols: list[str], score_type: str = "log2fc"
) -> pd.DataFrame:
    """AF-weighted average of per-population scores -> VF-agg-<type>-weighted."""
    if f"VF-REF_HG38-2-exp-{score_type}" in score_cols:
        score_cols = [c for c in score_cols if "REF_HG38-2" not in c]
    pop_af_cols = [
        "AF_" + c.split("-")[1]
        for c in score_cols
        if any(c.startswith(f"VF-{p}-2") for p in POPULATIONS)
    ]
    agg = []
    for _, row in df.iterrows():
        scores = row[score_cols].to_numpy(dtype=float)
        afs = row[pop_af_cols].to_numpy(dtype=float)
        valid = ~np.isnan(scores)
        if valid.sum() == 0:
            agg.append(np.nan)
            continue
        vs, va = scores[valid], afs[valid]
        va = va / va.sum() if va.sum() != 0 else va
        if va.sum() > 0:
            agg.append(float(np.average(vs, weights=va)))
        else:
            agg.append(float(np.mean(vs)))
    df = df.copy()
    df[f"VF-agg-{score_type}-weighted"] = agg
    return df


def _score_frame(df: pd.DataFrame, score_fn, suffix: str, af_path: str | None):
    ref_col = "REF_HG38-0-exp"
    pop_columns = _pop_exp_columns(df)
    keep = [ref_col, *pop_columns,
            "variant_id", "genes", "tissues", "ref", "alt", "chr", "pos"]
    df = df[keep].reset_index(drop=True)
    score_cols = []
    ref = df[ref_col].to_numpy(dtype=float)
    for col in pop_columns:
        score = score_fn(df[col].to_numpy(dtype=float), ref)
        name = f"VF-{col}-{suffix}"
        df[name] = score.astype(float)
        score_cols.append(name)
    sample_cols = [c for c in pop_columns if c.startswith("SAMPLE-2")]
    base = ["variant_id", "genes", "tissues", "ref", "alt", "chr", "pos"]
    if not sample_cols and af_path is not None:
        df = gene_pop_agg_score(merge_pop_stat(df, af_path), score_cols, suffix)
        return df[base + [f"VF-agg-{suffix}-weighted"] + score_cols]
    return df[base + score_cols]


def generate_log2fc_score(df: pd.DataFrame, af_path: str | None) -> pd.DataFrame:
    return _score_frame(
        df, lambda pop, ref: np.log2((pop + _EPS) / (ref + _EPS)), "log2fc", af_path
    )


def generate_poisson_score(df: pd.DataFrame, af_path: str | None) -> pd.DataFrame:
    from scipy import stats

    return _score_frame(
        df, lambda pop, ref: stats.poisson.cdf(pop, ref), "Poisson", af_path
    )
