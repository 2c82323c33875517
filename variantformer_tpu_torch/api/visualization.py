"""Tissue-expression visualization: self-contained HTML reports.

The port's copy of ``variantformer_tpu/api/visualization.py`` (the same
bytes out for the same frames): per-tissue predictions as a sorted
horizontal bar heatmap grouped by organ system (``expression_report``), and
an interactive 2D embedding scatter (``scatter_html``). Pure stdlib — each
emits a single HTML file, no widget runtime required.
"""

from __future__ import annotations

import html
from pathlib import Path

# Coarse organ-system grouping of the released tissue vocabulary
# (vocabs/tissue_vocab.yaml names), used to organize the report.
TISSUE_GROUPS = {
    "brain": "nervous system",
    "nerve": "nervous system",
    "pituitary": "nervous system",
    "heart": "cardiovascular",
    "artery": "cardiovascular",
    "blood": "cardiovascular",
    "whole blood": "cardiovascular",
    "lung": "respiratory",
    "esophagus": "digestive",
    "stomach": "digestive",
    "colon": "digestive",
    "small intestine": "digestive",
    "liver": "digestive",
    "pancreas": "digestive",
    "minor salivary gland": "digestive",
    "kidney": "urinary",
    "bladder": "urinary",
    "testis": "reproductive",
    "ovary": "reproductive",
    "uterus": "reproductive",
    "vagina": "reproductive",
    "cervix": "reproductive",
    "fallopian tube": "reproductive",
    "prostate": "reproductive",
    "breast": "reproductive",
    "adipose": "connective",
    "muscle": "musculoskeletal",
    "skin": "integumentary",
    "adrenal gland": "endocrine",
    "thyroid": "endocrine",
    "spleen": "immune",
    "cells": "cell lines",
    "lcl": "cell lines",
}
_CELL_LINES = {"A549", "GM23248", "HepG2", "K562", "NCI-H460", "Panc1"}


def tissue_group(name: str) -> str:
    if name in _CELL_LINES:
        return "cell lines"
    lowered = name.lower()
    for prefix, group in TISSUE_GROUPS.items():
        if lowered.startswith(prefix):
            return group
    return "other"


def _color(frac: float) -> str:
    """White -> warm ramp."""
    r = 255
    g = int(245 - 160 * frac)
    b = int(240 - 200 * frac)
    return f"rgb({r},{g},{b})"


def expression_report(
    predictions: dict[str, dict[str, float]],
    out_path: str | Path,
    title: str = "Tissue-specific expression",
) -> str:
    """predictions: {gene_id: {tissue_name: value}} -> writes an HTML report."""
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        "<style>body{font-family:system-ui,sans-serif;margin:2rem;max-width:60rem}"
        ".bar{height:1.1rem;border-radius:3px;display:inline-block;"
        "vertical-align:middle}"
        ".row{display:flex;align-items:center;gap:.5rem;margin:.15rem 0}"
        ".tname{width:18rem;font-size:.85rem;text-align:right}"
        ".val{font-size:.8rem;color:#555;width:4rem}"
        "h3{margin:.8rem 0 .2rem;color:#444}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
    ]
    for gene, tissues in predictions.items():
        parts.append(f"<h2>{html.escape(str(gene))}</h2>")
        vmax = max(tissues.values()) or 1.0
        groups: dict[str, list[tuple[str, float]]] = {}
        for name, value in tissues.items():
            groups.setdefault(tissue_group(name), []).append((name, value))
        for group in sorted(groups):
            parts.append(f"<h3>{html.escape(group)}</h3>")
            for name, value in sorted(groups[group], key=lambda kv: -kv[1]):
                frac = max(0.0, min(1.0, value / vmax))
                width = max(2, int(420 * frac))
                parts.append(
                    f"<div class='row'><span class='tname'>{html.escape(name)}"
                    f"</span><span class='bar' style='width:{width}px;"
                    f"background:{_color(frac)};border:1px solid #ccc'></span>"
                    f"<span class='val'>{value:.3f}</span></div>"
                )
    parts.append("</body></html>")
    out_path = Path(out_path)
    out_path.write_text("".join(parts))
    return str(out_path)


_SCATTER_PALETTE = (
    "#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951",
    "#ff8ab7", "#a463f2", "#97bbf5", "#9c6b4e", "#9498a0",
)


def scatter_html(
    df,
    out_path: str | Path,
    *,
    x: str = "x",
    y: str = "y",
    color: str | None = None,
    hover: list[str] | None = None,
    title: str = "2D embedding",
    width: int = 680,
    height: int = 520,
) -> str:
    """Interactive 2D scatter as a single self-contained HTML file
    (hover tooltips, categorical colors, legend — with zero widget/JS
    dependencies)."""
    xs = [float(v) for v in df[x]]
    ys = [float(v) for v in df[y]]
    pad = 0.05
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    x0, x1 = x0 - pad * xr, x1 + pad * xr
    y0, y1 = y0 - pad * yr, y1 + pad * yr

    def px(v):  # data -> svg coords (y flipped)
        return 40 + (v - x0) / (x1 - x0) * (width - 60)

    def py(v):
        return 12 + (y1 - v) / (y1 - y0) * (height - 52)

    categories: list[str] = []
    cat_of: list[str | None] = []
    if color is not None:
        for v in df[color]:
            s = str(v)
            if s not in categories:
                categories.append(s)
            cat_of.append(s)
    else:
        cat_of = [None] * len(xs)
    col = {
        c: _SCATTER_PALETTE[i % len(_SCATTER_PALETTE)]
        for i, c in enumerate(categories)
    }
    hover = hover or []
    circles = []
    for i in range(len(xs)):
        tip_parts = [f"{h}: {df[h].iloc[i]}" for h in hover]
        if color is not None:
            tip_parts.append(f"{color}: {cat_of[i]}")
        tip_parts.append(f"({xs[i]:.3g}, {ys[i]:.3g})")
        fill = col[cat_of[i]] if cat_of[i] is not None else _SCATTER_PALETTE[0]
        circles.append(
            f"<circle cx='{px(xs[i]):.1f}' cy='{py(ys[i]):.1f}' r='4.5' "
            f"fill='{fill}' fill-opacity='0.8' stroke='#fff' "
            f"stroke-width='0.8' data-tip=\""
            f"{html.escape(' | '.join(tip_parts), quote=True)}\"/>"
        )
    legend = "".join(
        f"<span style='margin-right:1rem;white-space:nowrap'>"
        f"<span style='display:inline-block;width:.7rem;height:.7rem;"
        f"border-radius:50%;background:{col[c]};margin-right:.3rem'></span>"
        f"{html.escape(c)}</span>"
        for c in categories
    )
    page = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        "<style>body{font-family:system-ui,sans-serif;margin:2rem}"
        "#tip{position:fixed;display:none;background:#222;color:#fff;"
        "padding:.3rem .5rem;border-radius:4px;font-size:.8rem;"
        "pointer-events:none;max-width:24rem}</style></head><body>"
        f"<h1>{html.escape(title)}</h1>"
        f"<div style='margin:.3rem 0 .6rem'>{legend}</div>"
        f"<svg width='{width}' height='{height}' "
        "style='border:1px solid #ddd;background:#fafafa'>"
        + "".join(circles)
        + "</svg><div id='tip'></div><script>"
        "const tip=document.getElementById('tip');"
        "document.querySelectorAll('circle[data-tip]').forEach(c=>{"
        "c.addEventListener('mousemove',e=>{tip.style.display='block';"
        "tip.style.left=(e.clientX+12)+'px';tip.style.top=(e.clientY+12)+'px';"
        "tip.textContent=c.dataset.tip;});"
        "c.addEventListener('mouseleave',()=>tip.style.display='none');});"
        "</script></body></html>"
    )
    out_path = Path(out_path)
    out_path.write_text(page)
    return str(out_path)


def report_from_prediction_df(df, out_path: str | Path, value_column: str = "predicted_expression"):
    """Adapter for VCFProcessor.predict output (list-valued columns)."""
    predictions = {}
    for _, row in df.iterrows():
        predictions[row["gene_id"]] = dict(
            zip(row["tissue_names"], [float(v) for v in row[value_column]])
        )
    return expression_report(predictions, out_path)
