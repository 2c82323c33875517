"""Generate ``variantformer_tpu_torch/notebooks/``: the port's notebook layer.

The port of ``scripts/make_notebooks.py``. The four flagship flows (vcf2exp,
variant2exp, vcf2risk, eqtl_analysis) are narrative notebooks: parameters
live in cells, intermediate dataframes render inline, charts and the
interactive anatomagram display in the page, and prose explains each stage.
The other flows wrap their ``variantformer_tpu_torch.examples`` module
(the same behaviour, a thinner document).

Every notebook runs anywhere: on the released artifacts when they are
present (``python -m variantformer_tpu_torch.data.download_artifacts``),
otherwise on the self-contained synthetic genome with a tiny model from a
seed. Each opens with a cell tagged ``parameters`` (papermill's convention)
that holds ``DEVICE = "cuda"`` and ``ROOT``, the work directory; a run on
the CPU writes ``DEVICE = "cpu"`` there. Committed notebooks carry no
outputs and fixed cell ids, so regenerating gives the same bytes:

    python -m variantformer_tpu_torch.scripts.make_notebooks [--out DIR]
"""

from __future__ import annotations

import argparse
from pathlib import Path

NOTEBOOKS_DIR = Path(__file__).resolve().parent.parent / "notebooks"

# ---------------------------------------------------------------------------
# Shared cells
# ---------------------------------------------------------------------------

PARAMETERS = """\
DEVICE = "cuda"  # the card; write "cpu" here to run on the CPU
ROOT = None  # the work directory; None: a new one under the temporary directory
"""

SETUP = """\
import sys
import tempfile
import time
from pathlib import Path

# The repository checkout above the notebook's directory, unless the
# package is installed.
HERE = Path().resolve()
REPO = next((p for p in (HERE, *HERE.parents)
             if (p / "variantformer_tpu_torch").is_dir()), None)
if REPO is not None and str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np
import pandas as pd
from IPython.display import HTML, display

from variantformer_tpu_torch.examples import _common

ROOT = Path(ROOT) if ROOT is not None else Path(tempfile.mkdtemp(prefix="vfx_nb_{name}_"))
ROOT.mkdir(parents=True, exist_ok=True)
SYNTHETIC = not _common.artifacts_present()
if SYNTHETIC:
    print(f"mode: SYNTHETIC demo (released artifacts not found) on {DEVICE} -- a tiny "
          "random model on a 3 kb genome; every stage below is the port's production "
          "code path, only the weights and the genome are toy")
else:
    print(f"mode: REAL artifacts under {_common.artifacts_dir()} on {DEVICE} -- the "
          "v4_pcg checkpoint")
print(f"work directory: {ROOT}")
"""

# Chart style: single-hue data ink (categorical slot 1 blue; slot 2 orange
# reserved for the comparison series), neutral text ink, recessive grid.
# Every plot cell starts with it, so no later cell needs a plot cell's names.
PLOT_STYLE = """\
import matplotlib.pyplot as plt

BLUE, ORANGE, INK, MUTED = "#2a78d6", "#eb6834", "#333333", "#757575"


def style_axis(ax):
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color("#cccccc")
    ax.tick_params(colors=MUTED, labelsize=9)
    ax.xaxis.label.set_color(INK)
    ax.yaxis.label.set_color(INK)
    ax.title.set_color(INK)
    ax.grid(axis="x", color="#e6e6e6", linewidth=0.6)
    ax.set_axisbelow(True)
"""

RUN = """\
from variantformer_tpu_torch.examples import {flow}

{result} = {flow}.main(ROOT / "{flow}", device=DEVICE)
"""

# ---------------------------------------------------------------------------
# vcf2exp — flagship narrative notebook
# ---------------------------------------------------------------------------

VCF2EXP_PARAMETERS = PARAMETERS + """\
# The query. None: APOE at three tissues with the downloader's HG00096.vcf.gz
# when the released artifacts are present, else the synthetic genes and donor.
GENES = None  # gene ids
TISSUES = None  # comma-separated tissue names
VCF_PATH = None  # the donor VCF
"""

VCF2EXP = [
    ("md", """\
# vcf2exp — tissue-specific gene expression from a personal genome

VariantFormer predicts **per-tissue gene expression from a donor's diploid
genome**: a phased VCF is applied to the reference FASTA as an IUPAC
consensus, the personalized sequence is BPE-tokenized into 200-token
windows, and a hierarchical transformer — a window encoder feeding 25
interleaved CRE↔gene cross-attention layers — produces one expression value
per (gene, tissue) plus a 1536-d gene–tissue embedding.

This notebook walks the full path end to end with the PyTorch port
(`variantformer_tpu_torch`):

1. assemble the inputs (FASTA + VCF + gene annotations + CRE maps),
2. build a query and inspect what the host pipeline hands the model,
3. run prediction on `DEVICE` and read the outputs,
4. visualize per-tissue expression (chart + interactive anatomagram),
5. compare the donor against the plain reference genome (log2 fold change).

With the released artifacts this runs the full 1.2B-parameter model; on the
card its two window encoders and its 25-layer gene stack run in the port's
hand-written Hopper kernels. Without the artifacts the *same code path* runs
a tiny random model on a bundled synthetic genome, so every cell below
executes anywhere. The next cell holds the parameters: the device, the work
directory and the query."""),
    ("params", VCF2EXP_PARAMETERS),
    ("setup", None),
    ("md", """\
## 1. Inputs

Four data pieces feed the pipeline:

| Input | Role |
|---|---|
| reference FASTA (+ `.fai`) | base sequence; random access per region |
| donor VCF (bgzip + `.tbi`) | phased genotypes to personalize the sequence |
| gencode CSV | gene → (chromosome, strand, TSS) annotations |
| per-gene CRE maps | candidate cis-regulatory elements near each gene |

`_common.build_processor()` wires the released artifacts when present (the
set `python -m variantformer_tpu_torch.data.download_artifacts` fetches from
the public S3 bucket) and otherwise builds the synthetic environment under
`ROOT`. Everything downstream is identical."""),
    ("code", """\
t0 = time.time()
proc, extras = _common.build_processor(ROOT / "env", DEVICE)
print(f"processor ready on {proc.device} in {time.time() - t0:.1f}s")
vcf_path = VCF_PATH or extras["vcf"]

cfg = proc.config
geometry = pd.DataFrame(
    [
        ("model embedding dim", cfg.seq2gene.emb_dim),
        ("attention heads", cfg.seq2gene.num_heads),
        ("CRE/gene layer pairs", cfg.seq2gene.num_layers),
        ("window encoder dim", cfg.window_encoder.embedding_dim),
        ("window encoder layers", cfg.window_encoder.num_layers),
        ("tokens per window", cfg.dataset.max_length),
        ("max gene windows", cfg.dataset.max_chunks),
        ("tissue heads", cfg.seq2gene.num_tissues),
    ],
    columns=["hyperparameter", "value"],
)
geometry"""),
    ("md", """\
## 2. The query

A query is a dataframe with one row per gene: `gene_id` (gencode id) and
`tissues` (comma-separated names from the tissue vocabulary). The processor
validates both against the gencode table and the vocabulary before any
compute is spent."""),
    ("code", """\
all_tissues = list(proc.get_tissues())
print(f"{len(all_tissues)} tissues in the vocabulary; first 8: "
      f"{all_tissues[:8]}")

genes_df = proc.get_genes()
display(genes_df.head(3))

if GENES is None:
    GENES = ["GENE1.1", "GENE2.1"] if SYNTHETIC else ["ENSG00000130203.9"]  # APOE
if TISSUES is None:
    TISSUES = "tissue0,tissue3" if SYNTHETIC else "brain - cortex,liver,whole blood"
query = pd.DataFrame({"gene_id": list(GENES), "tissues": [TISSUES] * len(GENES)})
query"""),
    ("md", """\
## 3. What the model actually sees

Before predicting, look at the host pipeline's product for the first query
gene. The stages (all in-process — no samtools/bcftools subprocesses; the
consensus and the BPE run in the port's C++ host engines):

1. **diploid consensus** — VCF records apply onto the FASTA slice;
   heterozygous sites become IUPAC ambiguity codes (e.g. A/G → R),
   homozygous-alt sites become the alt allele;
2. **BPE tokenization** — the 500-token DNA vocabulary, strand-aware
   (minus-strand genes use the reverse complement and reversed CRE order);
3. **windowing** — each CRE becomes one ≤200-token window; the gene's cis
   window (1 kb upstream + 300 kb downstream at production scale) is
   chunked into up to 200 windows of 200 tokens.

The batch is padded and carries each sample's valid counts (tokens per
window, gene windows, CREs); the kernels read those counts and mask the
padding, so a padded slot never changes an answer."""),
    ("code", """\
from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.vcf import VCFReader

builder = GeneSampleBuilder(
    cfg=proc.config.dataset,
    fasta=FastaReader(proc.sources.fasta_path),
    tokenizer=proc.tokenizer,
    gencode=proc.get_genes(),
    cre_map_provider=(proc.sources.cre_map_provider
                      or proc.sources.default_cre_map_provider()),
    vcf=VCFReader(vcf_path) if vcf_path else None,
)
sample = builder.build(query["gene_id"][0])
print(f"gene {sample.gene_id} (strand {sample.strand})")
print(f"  CRE windows:  {sample.cre_tokens.shape}  "
      f"(count x tokens; real lengths {sample.cre_tok_len.tolist()[:6]}...)")
print(f"  gene windows: {sample.gene_tokens.shape}")
first = sample.cre_tokens[0][: sample.cre_tok_len[0]]
print(f"  first CRE window, first 12 BPE token ids: {first[:12].tolist()}")
print(f"  ...decoded back to sequence: "
      f"{proc.tokenizer.decode(first[:12].tolist())}")"""),
    ("md", """\
## 4. Predict

`VCFProcessor.predict` groups query rows that share a tissue list into
device batches, builds samples on host threads, and runs the forward on
`DEVICE`. On the card, both window encoders run in the hand-written kernel
`fused_window_encoder` and the gene stack in `fused_gene_modulator`
(`variantformer_tpu_torch/csrc/`); on the CPU the same wrappers run their
plain PyTorch versions. The output appends two list-valued columns to the
validated query — `predicted_expression` (one value per tissue) and
`embeddings` (one 1536-d vector per tissue), the same schema the reference's
processor returns."""),
    ("code", """\
t0 = time.time()
out = proc.predict(vcf_path, query)
wall = time.time() - t0
print(f"{len(out)} gene(s) predicted in {wall:.1f}s")

long_df = out.explode(["tissue_names", "predicted_expression"])[
    ["gene_id", "tissue_names", "predicted_expression"]
].reset_index(drop=True)
long_df["predicted_expression"] = long_df["predicted_expression"].astype(float)
long_df"""),
    ("md", """\
## 5. Per-tissue expression

One gene, one magnitude per tissue — a bar chart (values share a single
hue; the axis carries the scale). Expression is the model's log1p-TPM-scale
output, directly comparable across tissues for the same gene."""),
    ("code", PLOT_STYLE + """\

g0 = long_df[long_df["gene_id"] == long_df["gene_id"].iloc[0]]
fig, ax = plt.subplots(figsize=(7, 0.5 + 0.45 * len(g0)))
ax.barh(g0["tissue_names"], g0["predicted_expression"],
        color=BLUE, height=0.55)
ax.set_xlabel("predicted expression")
ax.set_title(f"{g0['gene_id'].iloc[0]} — predicted expression by tissue")
ax.invert_yaxis()
style_axis(ax)
plt.tight_layout()
plt.show()"""),
    ("md", """\
## 6. Anatomagram

The interactive anatomagram paints the predictions onto UBERON-mapped
body/brain views (male/female/brain tabs; hover a region for the
contributing tissues and values) — self-contained HTML, no widget
dependencies."""),
    ("code", """\
from variantformer_tpu_torch.api.anatomagram import anatomagram_from_prediction_df

page = anatomagram_from_prediction_df(out, ROOT / "anatomagram_vcf2exp.html")
display(HTML(Path(page).read_text()))"""),
    ("md", """\
## 7. Donor vs reference genome

How much do this donor's variants move expression? Re-run the same query
with **no VCF** (plain reference sequence) and compare: the log2 fold
change per tissue is the donor's personal regulatory effect — the same
contrast the reference's vcf2exp notebook reports."""),
    ("code", """\
ref_out = proc.predict(None, query)

ref_long = ref_out.explode(["tissue_names", "predicted_expression"])[
    ["gene_id", "tissue_names", "predicted_expression"]
].rename(columns={"predicted_expression": "reference"})
cmp = long_df.rename(columns={"predicted_expression": "donor"}).merge(
    ref_long, on=["gene_id", "tissue_names"]
)
cmp["reference"] = cmp["reference"].astype(float)
cmp["log2fc"] = np.log2((cmp["donor"] + 1e-6) / (cmp["reference"] + 1e-6))
cmp"""),
    ("code", PLOT_STYLE + """\

labels = cmp["gene_id"].str.cat(cmp["tissue_names"], sep=" / ")
y = np.arange(len(cmp))
fig, ax = plt.subplots(figsize=(7, 0.7 + 0.55 * len(cmp)))
ax.barh(y - 0.18, cmp["donor"], height=0.32, color=BLUE, label="donor")
ax.barh(y + 0.18, cmp["reference"], height=0.32, color=ORANGE,
        label="reference")
ax.set_yticks(y, labels)
ax.set_xlabel("predicted expression")
ax.set_title("donor vs reference genome", loc="left")
ax.invert_yaxis()
ax.legend(frameon=False, labelcolor=INK, ncols=2, loc="lower right",
          bbox_to_anchor=(1, 1.02))  # above the axes, clear of the bars
style_axis(ax)
plt.tight_layout()
plt.show()"""),
    ("md", """\
## Where to next

* `variant2exp.ipynb` — score individual variants (ref/het/hom VEP triples,
  population context, eQTL log2fc effect sizes).
* `vcf2risk.ipynb` — Alzheimer's-disease risk from the same embeddings.
* `variantformer_tpu_torch/examples/` — every flow as a plain module
  (`python -m variantformer_tpu_torch.examples.vcf2exp`);
  `variantformer_tpu_torch/parallel/` and `scripts/` — several cards and
  several hosts, each card running the same kernels.
"""),
]

# ---------------------------------------------------------------------------
# variant2exp — flagship narrative notebook
# ---------------------------------------------------------------------------

VARIANT2EXP = [
    ("md", """\
# variant2exp — variant effect prediction (VEP) and eQTL scoring

Given a variant (chrom, pos, ref, alt), what does it do to nearby genes'
expression, tissue by tissue? The VEP path answers by contrasting three
versions of the same personalized sequence:

| zygosity | sequence at the site |
|---|---|
| 0 (ref) | the reference/sample base |
| 1 (het) | the IUPAC ambiguity code for ref/alt (e.g. T/C → Y) |
| 2 (hom) | the alt allele |

All three run through the full model as one batch; per-tissue log2 fold
changes between zygosities are the variant's effect sizes. With the
released artifacts, variants are scored in the genomic context of six
populations (REF_HG38, EAS, EUR, AFR, SAS, AMR — precomputed 1KG consensus
sequences) or of a specific sample VCF; the synthetic demo uses a sample
VCF so the flow is identical. The next cell holds the parameters."""),
    ("params", PARAMETERS),
    ("setup", None),
    ("md", """\
## 1. The variant table

One row per variant: coordinates, alleles, and the tissues to score.
`gene_id` is optional — without it, the processor scans gencode for genes
whose cis window lies within ±1 Mb of the variant and scores every pair."""),
    ("code", """\
from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
from variantformer_tpu_torch.models.init import init_seq2gene

if SYNTHETIC:
    sources, cfg, extras = _common.synthetic_env(ROOT / "env")
    vp = VariantProcessor(sources=sources, config=cfg, device=DEVICE)
    vp.set_params(init_seq2gene(cfg, _common.SEED, device=DEVICE))
    chrom, pos, ref, alt = extras["variant"]
    var_df = pd.DataFrame(
        {"chrom": [chrom], "pos": [pos], "ref": [ref], "alt": [alt],
         "tissue": ["tissue0,tissue2"]}
    )
    vcf_arg, sample_arg = extras["vcf"], "S1"
else:
    sources, cfg = _common.real_sources()
    vp = VariantProcessor(sources=sources, config=cfg, device=DEVICE)
    vp.load_model()
    var_df = pd.DataFrame(
        {"chrom": ["chr19"], "pos": [44908684], "ref": ["T"], "alt": ["C"],
         "tissue": ["brain - cortex,liver"],
         "gene_id": ["ENSG00000130203"]}  # APOE; drop to auto-scan +/-1Mb
    )
    vcf_arg, sample_arg = None, None  # 6-population precomputed mode
var_df"""),
    ("md", """\
## 2. How a variant becomes three model inputs

For each (variant, gene) pair the builder:

1. fetches the personalized gene window and every CRE window (diploid
   consensus, as in vcf2exp);
2. substitutes the variant site three ways (ref / IUPAC-het / hom-alt) on
   both strands — minus-strand genes see the complementary alleles;
3. re-tokenizes and records **which BPE token and which gene window
   contain the variant** (`encode_with_position` semantics — N-runs split
   sequences, so token boundaries shift and the position must be tracked
   through normalization);
4. packs the three samples as one batch so they share a device dispatch.

The tracked positions let the model return token-level embeddings at the
variant site alongside the pooled gene–tissue embeddings."""),
    ("code", """\
from variantformer_tpu_torch.utils.constants import IUPAC_CODES

pair = frozenset((var_df["ref"][0], var_df["alt"][0]))
het = next(c for c, bases in IUPAC_CODES.items()
           if frozenset(bases) == pair and len(bases) == 2)
print(f"variant {var_df['chrom'][0]}:{var_df['pos'][0]} "
      f"{var_df['ref'][0]}>{var_df['alt'][0]}")
print(f"  zygosity 0 sequence keeps:    {var_df['ref'][0]}")
print(f"  zygosity 1 (het) writes IUPAC: {het}  "
      f"({'/'.join(sorted(pair))})")
print(f"  zygosity 2 (hom) writes:      {var_df['alt'][0]}")"""),
    ("md", """\
## 3. Score

`predict` builds every (variant, gene, population) triple, groups
compatible shapes into shared device dispatches (`variants_per_dispatch`
batches k triples per dispatch), and writes per-chunk parquets so long
sweeps resume. The long-form result has one row per (variant, gene,
population, tissue, zygosity)."""),
    ("code", """\
out_dir = tempfile.mkdtemp(prefix="vep_", dir=ROOT)
t0 = time.time()
long_df = vp.predict(var_df, out_dir, vcf_path=vcf_arg,
                     sample_name=sample_arg)
print(f"{len(long_df)} rows in {time.time() - t0:.1f}s")
long_df.head(12)"""),
    ("md", """\
## 4. Pivot to effect columns

`format_scores` pivots zygosities into the reference's column contract —
`{POP}-{zygosity}-exp` — one row per (variant, gene, tissue)."""),
    ("code", """\
scores = vp.format_scores(long_df)
scores.head()"""),
    ("md", """\
## 5. eQTL effect sizes

`eqtl_scores` reduces the pivot to log2 fold changes (het/ref and hom/ref
per population). With allele-frequency tables present, the per-population
scores also aggregate into one AF-weighted effect per variant — the
quantity compared against eQTL-catalog slopes in the reference's
evaluation."""),
    ("code", """\
eqtl = vp.eqtl_scores(scores)
fc_cols = [c for c in eqtl.columns if "log2fc" in c]
print("log2fc columns:", fc_cols)
eqtl.head()"""),
    ("code", PLOT_STYLE + """\

# Effect sizes have polarity (up/down vs ref): diverge around zero with
# the warm/cool pair, neutral ink elsewhere.
col = fc_cols[0]
per_tissue = eqtl[["tissues", col]].dropna().groupby("tissues")[col].mean()
colors = [BLUE if v >= 0 else ORANGE for v in per_tissue.values]
fig, ax = plt.subplots(figsize=(7, 0.6 + 0.45 * len(per_tissue)))
ax.barh(per_tissue.index, per_tissue.values, color=colors, height=0.55)
ax.axvline(0, color="#999999", linewidth=0.8)
ax.set_xlabel(col)
ax.set_title("variant effect by tissue (blue up, orange down)")
ax.invert_yaxis()
style_axis(ax)
plt.tight_layout()
plt.show()"""),
    ("md", """\
## Notes for real sweeps

* **Populations**: omit `vcf_path` to score against all six 1KG population
  backgrounds; pass a VCF + `sample_name` to use one donor's context.
* **Scale**: `variants_per_dispatch=k` batches k triples per device
  dispatch; `chunks`/`chunk_id` partition a sweep across workers and every
  chunk's parquet is a resume point.
* `eqtl_analysis.ipynb` joins these scores against eQTL-catalog slopes and
  computes per-tissue Spearman correlations."""),
]

# ---------------------------------------------------------------------------
# vcf2risk — flagship narrative notebook
# ---------------------------------------------------------------------------

VCF2RISK = [
    ("md", """\
# vcf2risk — Alzheimer's-disease risk from a donor VCF

AD risk is a **second-stage head over the expression model's embeddings**:
vcf2exp produces a 1536-d embedding per (gene, tissue); a per-(gene,
tissue) gradient-boosted-tree classifier maps that embedding to P(AD).
The released predictor set covers ~16,400 genes × 45 tissues.

The GBT engine is the port's own (flat-array ensembles evaluated in numpy on
the host, or on the card for cohort-scale scoring — no treelite runtime);
released treelite predictors and sklearn models both convert via
`api.ad_risk.TreeEnsemble`. Without the released artifacts this notebook
fits a small demo GBT in-cell (with scikit-learn) so the full flow still
executes. The next cell holds the parameters."""),
    ("params", PARAMETERS),
    ("setup", None),
    ("md", """\
## 1. Build the two stages

Stage 1 is the familiar expression processor. Stage 2 resolves one GBT per
(gene, tissue) — from the released manifest when artifacts are present,
here from a demo predictor we fit on the spot (visible below, nothing
hidden)."""),
    ("code", """\
from variantformer_tpu_torch.api.ad_risk import ADriskFromVCF, TreeEnsemble

proc, extras = _common.build_processor(ROOT / "env", DEVICE)
vcf_path = extras["vcf"]

if SYNTHETIC:
    from sklearn.ensemble import GradientBoostingClassifier

    emb_dim = proc.config.seq2gene.emb_dim
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, emb_dim)).astype(np.float32)
    y = (x[:, 0] > 0).astype(int)
    gbm = GradientBoostingClassifier(
        n_estimators=10, max_depth=3, random_state=0
    ).fit(x, y)
    ens = TreeEnsemble.from_sklearn_gbm(gbm)
    demo_path = str(ROOT / "demo_gbt.npz")
    ens.save(demo_path)
    print(f"demo GBT: {len(ens.tree_offsets)} trees over "
          f"{emb_dim}-d embeddings")

    class DemoManifest:
        def get_file_path(self, gene_id, tissue_id):
            return demo_path

    ad = ADriskFromVCF(proc, manifest=DemoManifest())
    # one (gene, tissue) pair per row — lists are parallel
    gene_ids, tissue_ids = ["GENE1.1", "GENE1.1"], [0, 3]
else:
    ad = ADriskFromVCF(proc)
    gene_ids, tissue_ids = ["ENSG00000130203.9"], [7]  # APOE
print("predictor stage ready")"""),
    ("md", """\
## 2. Score the donor

One call runs the whole chain: consensus → tokenize → expression model →
per-tissue embeddings → GBT inference. The output is one row per
(gene, tissue) with the embedding-derived `ad_risk` probability."""),
    ("code", """\
t0 = time.time()
risk = ad(vcf_path, gene_ids, tissue_ids)
print(f"scored in {time.time() - t0:.1f}s")
risk[["gene_id", "tissue_name", "ad_risk"]]"""),
    ("md", """\
## 3. Read the number

`ad_risk` is the classifier's P(AD | embedding) for that gene–tissue
context — a relative signal for ranking genes/tissues/donors, not a
calibrated clinical probability. The reference's regression gate pins
APOE/tissue-7 at ≈0.668 on the released predictors; the demo GBT's
absolute values are arbitrary but the flow and schema are identical."""),
    ("code", PLOT_STYLE + """\

fig, ax = plt.subplots(figsize=(6, 0.6 + 0.5 * len(risk)))
ax.barh(risk["tissue_name"].astype(str), risk["ad_risk"],
        color=BLUE, height=0.5)
ax.set_xlim(0, 1)
ax.set_xlabel("P(AD)")
ax.set_title(f"{risk['gene_id'].iloc[0]} — AD risk by tissue")
ax.invert_yaxis()
style_axis(ax)
plt.tight_layout()
plt.show()"""),
    ("md", """\
## 4. Risk anatomagram

Same interactive body/brain views as vcf2exp, painted with risk instead of
expression (tissues sharing a region aggregate by mean)."""),
    ("code", """\
from variantformer_tpu_torch.api.anatomagram import anatomagram_from_risk_df

page = anatomagram_from_risk_df(risk, ROOT / "anatomagram_risk.html")
display(HTML(Path(page).read_text()))"""),
    ("md", """\
## 5. In-silico edit → risk delta

Because risk is a function of the embeddings, an in-silico variant's risk
effect falls out of the VEP path: embed the gene at zygosity 0 (no edit)
and zygosity 2 (homozygous edit), score both embeddings with the same GBT,
and difference. This is the variant2risk flow — run inline here for one
edit."""),
    ("code", """\
from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
from variantformer_tpu_torch.models.init import init_seq2gene

if SYNTHETIC:
    sources, cfg, sextras = _common.synthetic_env(ROOT / "env")
    vp = VariantProcessor(sources=sources, config=cfg, device=DEVICE)
    vp.set_params(init_seq2gene(cfg, _common.SEED, device=DEVICE))
    chrom, pos, vref, valt = sextras["variant"]
    edit_df = pd.DataFrame(
        {"chrom": [chrom], "pos": [pos], "ref": [vref], "alt": [valt],
         "tissue": ["tissue0"]}
    )
    vcf_arg, sample_arg = sextras["vcf"], "S1"
else:
    sources, cfg = _common.real_sources()
    vp = VariantProcessor(sources=sources, config=cfg, device=DEVICE)
    vp.load_model()
    edit_df = pd.DataFrame(
        {"chrom": ["chr19"], "pos": [44908684], "ref": ["T"], "alt": ["C"],
         "tissue": ["brain - cortex"], "gene_id": ["ENSG00000130203"]}
    )
    vcf_arg, sample_arg = str(_common.artifacts_dir() / _common.DONOR_VCF), "HG00096"

vep_long = vp.predict(
    edit_df, tempfile.mkdtemp(prefix="v2r_", dir=ROOT),
    vcf_path=vcf_arg, sample_name=sample_arg,
)
# zygosity 0 = donor context without the edit; 2 = homozygous edit.
baseline = vep_long[(vep_long["zygosity"] == "0")
                    & (vep_long["sample_name"] == sample_arg)]
edited = vep_long[(vep_long["zygosity"] == "2")
                  & (vep_long["sample_name"] == sample_arg)]


def risk_for(row):
    emb = np.asarray(row.gene_emb, np.float32).reshape(1, -1)
    if SYNTHETIC:
        return float(TreeEnsemble.load(demo_path)(emb)[0])
    from variantformer_tpu_torch.api.ad_risk import ADrisk

    return float(ADrisk(row.genes, vp.tissue_vocab[row.tissues])(emb)[0])


rows = []
for (_, b), (_, e) in zip(baseline.iterrows(), edited.iterrows()):
    assert b.genes == e.genes and b.tissues == e.tissues
    r0, r2 = risk_for(b), risk_for(e)
    rows.append({"gene_id": b.genes, "tissue": b.tissues,
                 "risk_no_edit": r0, "risk_hom_edit": r2,
                 "delta": r2 - r0})
pd.DataFrame(rows)"""),
    ("md", """\
## Where to next

* `variant2risk.ipynb` — the edit→risk-delta flow as its own document.
* `variant2exp.ipynb` — the underlying VEP scoring in full.
* The risk head's engine and converters live in
  `variantformer_tpu_torch/api/ad_risk.py` (sklearn and treelite both
  convert to the native flat-array format)."""),
]

# ---------------------------------------------------------------------------
# eqtl_analysis — flagship narrative notebook
# ---------------------------------------------------------------------------

EQTL = [
    ("md", """\
# eqtl_analysis — model scores vs eQTL-catalog effect sizes

How well do the model's variant effect scores track *measured* genetics?
eQTL catalogs record, per (variant, gene, tissue), the regression slope of
expression on genotype across a population cohort. This notebook scores
each catalog variant with the model's VEP path and reports the per-tissue
**Spearman rank correlation** between the model's log2 fold changes and the
catalog slopes — the quality benchmark the reference compares against
AlphaGenome.

With the released artifacts this runs the real eQTL-catalog table and the
1.2B checkpoint; the synthetic demo synthesizes a small catalog (>= 3
associations per tissue, so the statistic genuinely computes) against the
tiny random model — same code path, toy numbers. The next cell holds the
parameters."""),
    ("params", PARAMETERS),
    ("setup", None),
    ("md", """\
## 1. The catalog

One row per association: variant coordinates, alleles, the tissues it was
mapped in, and the catalog slope (effect size, sign = direction of the alt
allele's effect)."""),
    ("code", """\
from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
from variantformer_tpu_torch.models.init import init_seq2gene
from variantformer_tpu_torch.utils.fasta import FastaReader

if SYNTHETIC:
    sources, cfg, extras = _common.synthetic_env(ROOT / "env")
    vp = VariantProcessor(sources=sources, config=cfg, device=DEVICE)
    vp.set_params(init_seq2gene(cfg, _common.SEED, device=DEVICE))
    fa = FastaReader(sources.fasta_path)
    flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
    rng = np.random.default_rng(7)
    catalog = pd.DataFrame(
        [
            {"chrom": "chr1", "pos": p,
             "ref": (r := fa.fetch("chr1", p - 1, p).upper()),
             "alt": flip[r], "tissue": "tissue0,tissue2",
             "slope": float(rng.normal(0.0, 0.5))}
            for p in (260, 340, 520, 740, 900, 1200)
        ]
    )
    score_col = "VF-SAMPLE-2-exp-log2fc"
    vcf_arg, sample_arg = extras["vcf"], "S1"
else:
    sources, cfg = _common.real_sources()
    vp = VariantProcessor(sources=sources, config=cfg, device=DEVICE)
    vp.load_model()
    catalog = pd.read_parquet(
        sources.af_path.replace("1KG_af_hg38_tables", "eqtl_catalog.parquet")
    )
    score_col = "VF-agg-log2fc-weighted"
    vcf_arg, sample_arg = None, None  # 6-population precomputed mode
catalog"""),
    ("md", """\
## 2. Score every association

Each variant runs the VEP triple forward (ref / IUPAC-het / hom-alt share
one device batch — `variant2exp.ipynb` walks that machinery), the long
frame pivots to `{POP}-{zygosity}-exp` columns, and `eqtl_scores` reduces
them to log2 fold changes. In 6-population mode the per-population scores
are additionally aggregated with 1000-Genomes allele-frequency weights
(`VF-agg-log2fc-weighted`); the sample-VCF demo scores one genome, so the
hom/ref contrast (`VF-SAMPLE-2-exp-log2fc`) is the comparable score."""),
    ("code", """\
long_df = vp.predict(
    catalog[["chrom", "pos", "ref", "alt", "tissue"]],
    tempfile.mkdtemp(prefix="vep_", dir=ROOT),
    **({"vcf_path": vcf_arg, "sample_name": sample_arg} if SYNTHETIC else {}),
)
scores = vp.eqtl_scores(vp.format_scores(long_df))
scores.head()"""),
    ("md", """\
## 3. Per-tissue Spearman

Join scores to catalog slopes on the variant id and rank-correlate within
each tissue. Spearman (not Pearson) is the convention here: eQTL slopes
and model fold changes live on different scales, and the benchmark asks
whether the model *orders* variants by effect like the cohort data does."""),
    ("code", """\
from scipy import stats


def spearman_by_tissue(scored, slope_col, score_col):
    out = []
    for tissue, group in scored.groupby("tissues"):
        if len(group) >= 3:
            r, p = stats.spearmanr(group[score_col], group[slope_col])
            out.append({"tissue": tissue, "spearman_r": r, "p": p,
                        "n": len(group)})
    return pd.DataFrame(out)


scored = scores.merge(
    catalog.assign(
        variant_id=catalog[["chrom", "pos", "ref", "alt"]]
        .astype(str).agg("_".join, axis=1)
    )[["variant_id", "slope"]],
    on="variant_id",
)
result = spearman_by_tissue(scored, "slope", score_col)
result"""),
    ("md", """\
## 4. Score vs slope

Each point is one (variant, gene, tissue) association. A positive
correlation means variants the cohort data calls up-regulating are ones
the model also scores as up-regulating. (The synthetic demo's random model
carries no signal — the point of the demo is that the statistic and the
plumbing run; the artifact run is the benchmark.)"""),
    ("code", PLOT_STYLE + """\

fig, ax = plt.subplots(figsize=(5.4, 4))
for tissue, group in scored.groupby("tissues"):
    ax.scatter(group["slope"], group[score_col], s=28, alpha=0.85,
               label=str(tissue))
ax.axhline(0, color=MUTED, lw=0.8, zorder=0)
ax.axvline(0, color=MUTED, lw=0.8, zorder=0)
ax.set_xlabel("eQTL catalog slope")
ax.set_ylabel(score_col)
ax.legend(frameon=False, fontsize=8)
style_axis(ax)
plt.tight_layout()
plt.show()"""),
    ("md", """\
## Where to go next

* `variant2exp.ipynb` — the VEP scoring machinery this notebook drives,
  cell by cell (triple construction, token position tracking, chunked
  genome-wide sweeps).
* With artifacts, `vp.eqtl_scores(scores, score="poisson")` swaps the
  log2fc reduction for the Poisson-CDF score (reference
  utils/functions.py:304-354), and `gene_pop_agg_score` controls the
  AF-weighted population aggregation."""),
]

# ---------------------------------------------------------------------------
# Remaining flows: thin wrappers over the example modules
# ---------------------------------------------------------------------------

NOTEBOOKS = {
    "vcf2exp": VCF2EXP,
    "variant2exp": VARIANT2EXP,
    "vcf2risk": VCF2RISK,
    "eqtl_analysis": EQTL,
    "snp_indel_predictions": [
        ("md", "# snp_indel_predictions — author VCFs from variant tables\n\n"
               "Creates VCFs from in-memory variant specs (SNPs + indels), "
               "merges variant sets into one bgzf+tabix VCF, and compares "
               "variant-carrying vs reference-genome expression. The next "
               "cell holds the parameters."),
        ("params", PARAMETERS),
        ("setup", None),
        ("code", RUN.format(flow="snp_indel_predictions", result="deltas") + "deltas"),
    ],
    "variant2risk": [
        ("md", "# variant2risk — in-silico edits → AD-risk deltas\n\n"
               "Applies in-silico variants near a gene, recomputes gene–"
               "tissue embeddings under each zygosity, and runs the AD-risk "
               "heads to estimate per-variant risk shifts (the synthetic demo "
               "fits its predictor with scikit-learn). The final cell "
               "of `vcf2risk.ipynb` walks this flow with commentary. The next "
               "cell holds the parameters."),
        ("params", PARAMETERS),
        ("setup", None),
        ("code", RUN.format(flow="variant2risk", result="out") + "out"),
    ],
    "vcf2embed": [
        ("md", "# vcf2embed — embedding clustering and 2D projection\n\n"
               "Collects the model's pooled gene–tissue embeddings across "
               "genes × tissues, clusters them, and projects to 2D (UMAP "
               "when installed, PCA otherwise) — the reference's vcf2embed "
               "clustering flow. The scatter below is interactive: hover a "
               "point for its gene, tissue, predicted expression and "
               "cluster. The next cell holds the parameters."),
        ("params", PARAMETERS),
        ("setup", None),
        ("code", RUN.format(flow="vcf2embed", result="df") + "df"),
        ("md", "## Interactive scatter"),
        ("code", "display(HTML((ROOT / \"vcf2embed\" / \"vcf2embed_scatter.html\")"
                 ".read_text()))"),
    ],
    "finetune_seq2gene": [
        ("md", "# finetune_seq2gene — train the expression model on your own labels\n\n"
               "The reference release defines the Seq2Gene losses but ships no "
               "training entry point; the port carries the full loop. The flow:\n\n"
               "1. **Shards** — `data/train_pipeline.TrainingShardWriter` builds "
               "per-(gene, donor) npz samples through the *same* diploid-consensus "
               "+ BPE sample builder inference uses (train/serve parity).\n"
               "2. **Fit** — `train/loop.fit`: Poisson NLL on expression, "
               "`torch.optim.Adam` with the reference's decay/no-decay split, the "
               "plateau LR scale, gradient accumulation, the port's own "
               "checkpoint format with resume, early stop. "
               "`freeze_tokenizers=True` (the reference's own training "
               "configuration) never builds the tokenizers' backward; on the card "
               "the gene stack's forward and backward run in the port's "
               "hand-written kernels.\n"
               "3. **Predict** — the fine-tuned parameters drop into the same "
               "`VCFProcessor` used everywhere else.\n\n"
               "The next cell holds the parameters."),
        ("params", PARAMETERS),
        ("setup", None),
        ("md", "## Run the end-to-end flow\n\nShards → fit (6 epochs) → "
               "checkpoint → reload → predict."),
        ("code", RUN.format(flow="finetune_seq2gene", result="res, out") +
                 "pd.DataFrame(res.history)"),
        ("md", "## Loss trajectory and predictions\n\n`res.history` carries "
               "per-epoch train/val losses and the LR scale the plateau "
               "scheduler applied; `out` is the fine-tuned processor's "
               "prediction frame."),
        ("code", "out.explode([\"tissue_names\", \"predicted_expression\"])[\n"
                 "    [\"gene_id\", \"tissue_names\", \"predicted_expression\"]\n"
                 "]"),
    ],
}


def nb(name: str, cells):
    """The notebook ``name`` from ``(kind, source)`` cells: kinds ``md``,
    ``code``, ``params`` (a code cell tagged ``parameters``) and ``setup``
    (``SETUP`` for this notebook); no outputs, ids ``<name>-<index>``."""
    import nbformat

    notebook = nbformat.v4.new_notebook()
    notebook.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3",
    }
    made = []
    for i, (kind, src) in enumerate(cells):
        if kind == "md":
            cell = nbformat.v4.new_markdown_cell(src)
        else:
            cell = nbformat.v4.new_code_cell(SETUP.replace("{name}", name) if kind == "setup"
                                             else src)
            if kind == "params":
                cell.metadata["tags"] = ["parameters"]
        cell.id = f"{name}-{i:02d}"
        made.append(cell)
    notebook.cells = made
    return notebook


def build() -> dict:
    """Every notebook, by name, in memory."""
    return {name: nb(name, cells) for name, cells in NOTEBOOKS.items()}


def main(argv=None) -> int:
    import nbformat

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, default=NOTEBOOKS_DIR,
                    help="output directory (default: variantformer_tpu_torch/notebooks)")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    for name, notebook in build().items():
        path = args.out / f"{name}.ipynb"
        nbformat.write(notebook, str(path))
        print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
