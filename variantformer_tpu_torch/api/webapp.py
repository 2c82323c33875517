"""Reactive single-file HTML apps.

The port's copy of ``variantformer_tpu/api/webapp.py`` (the same bytes out
for the same frames). Predictions are embedded as JSON and all reactivity
(gene selector, tissue search/sort, aggregation toggle, anatomagram
recoloring, scatter filtering, risk thresholding) runs client-side in
dependency-free vanilla JS — no server, no network, no widget framework.
Re-running the model on in-silico edits needs a live model: that is
``api/live.py``.

Apps:
  * ``vcf2exp_app``   — per-gene tissue expression explorer: gene selector,
    recolorable 3-view anatomagram, sortable/searchable tissue table, bar
    chart; one shared color scale per gene.
  * ``vcf2risk_app``  — AD-risk view: per-tissue risk table + anatomagram +
    a live probability-threshold slider flagging at-risk tissues.
  * ``vcf2embed_app`` — gene-tissue embedding scatter with color-by selector,
    category legend filters and hover-linked detail table.

All three return the output path.
"""

from __future__ import annotations

import html as _html
import json
from pathlib import Path

from variantformer_tpu_torch.api.anatomagram import (
    _PAGE_CSS,
    _heat,
    anatomagram_svg,
    load_tissue_uberon_map,
)


def _json_embed(obj) -> str:
    """JSON for an inline <script> block: '</' would let a string value
    containing '</script>' (or '<!--') terminate the block and inject
    markup — escape it as '<\\/' (valid JSON, same parsed value)."""
    return json.dumps(obj).replace("</", "<\\/")

_APP_CSS = _PAGE_CSS + """
.controls{display:flex;gap:1rem;align-items:center;flex-wrap:wrap;
  margin:.8rem 0;padding:.6rem;background:#f6f4f0;border-radius:8px}
.controls label{font-size:.85rem}
select,input[type=search]{padding:.25rem .4rem;font-size:.85rem}
table.values th{cursor:pointer;user-select:none}
table.values th.sorted::after{content:' \\2193'}
table.values th.sorted.asc::after{content:' \\2191'}
.bar{fill:#a33b2a}
.bar:hover{fill:#222}
.panel{display:flex;gap:2rem;align-items:flex-start;flex-wrap:wrap}
.risk-hi{background:#fbe3de}
.dot{cursor:pointer}
.legend span{display:inline-block;margin-right:.8rem;cursor:pointer;
  font-size:.8rem}
.legend span.off{opacity:.35;text-decoration:line-through}
.legend i{display:inline-block;width:10px;height:10px;border-radius:5px;
  margin-right:4px}
#detail{font-size:.8rem;min-height:1.2rem;margin:.4rem 0;color:#444}
"""

# Shared client-side runtime: tooltip, region recoloring, sortable tables.
_APP_JS_LIB = """
const tip = document.getElementById('tooltip');
function showTip(ev, text){
  tip.textContent = text;
  tip.style.left = (ev.clientX + 14) + 'px';
  tip.style.top = (ev.clientY + 6) + 'px';
  tip.style.display = 'block';
}
function hideTip(){ tip.style.display = 'none'; }
function heat(frac){
  frac = Math.max(0, Math.min(1, frac));
  const r = Math.round(248 - 90 * frac);
  const g = Math.round(232 * (1 - frac) + 30);
  const b = Math.round(190 * (1 - frac) + 30);
  return `rgb(${r},${g},${b})`;
}
// Aggregate {tissue: value} onto drawable regions via TISSUE_MAP.
function regionValues(values, agg){
  const regions = {};
  for (const [t, v] of Object.entries(values)){
    const m = TISSUE_MAP[t] || TISSUE_MAP[t.toLowerCase()];
    if (!m || m.cell_line) continue;
    (regions[m.svg] = regions[m.svg] || []).push([t, v]);
  }
  const out = {};
  for (const [u, pairs] of Object.entries(regions)){
    const vs = pairs.map(p => p[1]);
    out[u] = [agg === 'mean' ? vs.reduce((a,b)=>a+b,0)/vs.length
                             : Math.max(...vs), pairs.map(p => p[0])];
  }
  return out;
}
// Recolor every .region in the document from {tissue: value}.
function paintRegions(values, agg){
  const vals = regionValues(values, agg);
  const drawn = Object.values(vals).map(v => v[0]);
  const lo = drawn.length ? Math.min(...drawn) : 0;
  const hi = drawn.length ? Math.max(...drawn) : 1;
  const span = (hi - lo) || 1;
  document.querySelectorAll('.region').forEach(r => {
    const hit = vals[r.dataset.uberon];
    const color = hit ? heat((hit[0] - lo) / span) : '#e3ddd2';
    r.style.opacity = hit ? 1 : 0.55;
    r.querySelectorAll('path,ellipse,circle,rect,polygon').forEach(
      n => { n.style.fill = color; });
    const label = r.dataset.label;
    r.dataset.tipText = hit
      ? label + ' — ' + hit[1].map(
          t => `${t}: ${values[t].toPrecision(4)}`).join('; ')
      : label + ': no data';
  });
  const s = document.querySelector('.scalewrap');
  if (s) s.innerHTML = `${lo.toPrecision(3)} <span class='scale' `
      + `style='display:inline-block;vertical-align:middle'></span> `
      + `${hi.toPrecision(3)}`;
}
document.addEventListener('mousemove', ev => {
  const r = ev.target.closest && ev.target.closest('.region');
  if (r) showTip(ev, r.dataset.tipText || r.dataset.label); else hideTip();
});
document.querySelectorAll('.tabs button').forEach(b => {
  b.addEventListener('click', () => {
    document.querySelectorAll('.tabs button').forEach(
      x => x.classList.remove('active'));
    document.querySelectorAll('.view').forEach(
      x => x.classList.remove('active'));
    b.classList.add('active');
    document.querySelector(
      `.view[data-view="${b.dataset.view}"]`).classList.add('active');
  });
});
// Sortable table: th click toggles sort on the tbody rows by data-value.
function makeSortable(table){
  table.querySelectorAll('th').forEach((th, col) => {
    th.addEventListener('click', () => {
      const asc = th.classList.contains('sorted') &&
                  !th.classList.contains('asc');
      table.querySelectorAll('th').forEach(
        x => x.classList.remove('sorted', 'asc'));
      th.classList.add('sorted');
      if (asc) th.classList.add('asc');
      const body = table.tBodies[0];
      const rows = Array.from(body.rows);
      rows.sort((a, b) => {
        const av = a.cells[col].dataset.v ?? a.cells[col].textContent;
        const bv = b.cells[col].dataset.v ?? b.cells[col].textContent;
        const an = parseFloat(av), bn = parseFloat(bv);
        const cmp = (isNaN(an) || isNaN(bn))
          ? String(av).localeCompare(String(bv)) : an - bn;
        return asc ? cmp : -cmp;
      });
      rows.forEach(r => body.appendChild(r));
    });
  });
}
"""


def _blank_views(views: tuple[str, ...]) -> str:
    """Tabbed neutral anatomagram views; JS recolors regions in place."""
    parts = ["<div class='scalewrap'></div><div class='tabs'>"]
    for i, view in enumerate(views):
        active = " class='active'" if i == 0 else ""
        parts.append(
            f"<button data-view='{view}'{active}>{view.title()}</button>"
        )
    parts.append("</div>")
    for i, view in enumerate(views):
        active = " active" if i == 0 else ""
        parts.append(
            f"<div class='view{active}' data-view='{view}'>"
            + anatomagram_svg({}, view=view)
            + "</div>"
        )
    return "".join(parts)


def _shell(title: str, body: str, data: dict, js: str) -> str:
    tissue_map = {
        t: {"svg": m.get("svg"), "cell_line": bool(m.get("cell_line")),
            "display": m.get("display", t)}
        for t, m in load_tissue_uberon_map().items()
    }
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_html.escape(title)}</title><style>"
        + _APP_CSS.replace("%G0%", _heat(0.0)).replace("%G1%", _heat(1.0))
        + "</style></head><body>"
        f"<h1>{_html.escape(title)}</h1><div id='tooltip'></div>"
        + body
        + "<script>\n"
        f"const DATA = {_json_embed(data)};\n"
        f"const TISSUE_MAP = {_json_embed(tissue_map)};\n"
        + _APP_JS_LIB
        + js
        + "</script></body></html>"
    )


def vcf2exp_app(
    df,
    out_path: str | Path,
    value_column: str = "predicted_expression",
    title: str = "VariantFormer vcf2exp explorer",
    views: tuple[str, ...] = ("male", "female", "brain"),
) -> str:
    """Interactive expression explorer from ``VCFProcessor.predict`` output
    (rows: gene_id + parallel tissue_names/value lists). Reference flow:
    notebooks/vcf2exp.py's gene dropdown + anatomagram + table."""
    data = {}
    for _, row in df.iterrows():
        data[str(row["gene_id"])] = {
            str(t): float(v)
            for t, v in zip(row["tissue_names"], row[value_column])
        }
    genes = list(data)
    body = (
        "<div class='controls'>"
        "<label>Gene <select id='gene'>"
        + "".join(
            f"<option value='{_html.escape(g)}'>{_html.escape(g)}</option>"
            for g in genes
        )
        + "</select></label>"
        "<label>Aggregation <select id='agg'>"
        "<option value='max'>max</option><option value='mean'>mean</option>"
        "</select></label>"
        "<label>Filter tissues <input type='search' id='search' "
        "placeholder='e.g. brain'></label>"
        "</div><div class='panel'><div>"
        + _blank_views(views)
        + "</div><div>"
        "<svg id='bars' width='420' height='300'></svg>"
        "<table class='values' id='tbl'><thead><tr>"
        "<th>Tissue</th><th>Expression</th></tr></thead>"
        "<tbody></tbody></table>"
        "</div></div>"
    )
    js = """
const geneSel = document.getElementById('gene');
const aggSel = document.getElementById('agg');
const search = document.getElementById('search');
function render(){
  const values = DATA[geneSel.value] || {};
  paintRegions(values, aggSel.value);
  const q = search.value.toLowerCase();
  const rows = Object.entries(values)
    .filter(([t]) => !q || t.toLowerCase().includes(q))
    .sort((a, b) => b[1] - a[1]);
  const body = document.querySelector('#tbl tbody');
  body.innerHTML = rows.map(([t, v]) =>
    `<tr><td data-v="${t}">${t}</td>` +
    `<td data-v="${v}">${v.toPrecision(5)}</td></tr>`).join('');
  const top = rows.slice(0, 12);
  const w = 420, h = 300, bh = h / Math.max(top.length, 1);
  const vmax = Math.max(...top.map(r => r[1]), 1e-9);
  document.getElementById('bars').innerHTML = top.map(([t, v], i) =>
    `<g><rect class='bar' x='150' y='${i * bh + 2}' ` +
    `width='${(w - 160) * v / vmax}' height='${Math.max(bh - 5, 2)}'>` +
    `<title>${t}: ${v.toPrecision(5)}</title></rect>` +
    `<text x='146' y='${i * bh + bh / 2 + 3}' text-anchor='end' ` +
    `font-size='10'>${t.slice(0, 24)}</text></g>`).join('');
}
geneSel.addEventListener('change', render);
aggSel.addEventListener('change', render);
search.addEventListener('input', render);
makeSortable(document.getElementById('tbl'));
render();
"""
    out_path = Path(out_path)
    out_path.write_text(_shell(title, body, data, js))
    return str(out_path)


def vcf2risk_app(
    df,
    out_path: str | Path,
    value_column: str = "ad_risk",
    title: str = "VariantFormer vcf2risk explorer",
    views: tuple[str, ...] = ("male", "female", "brain"),
    threshold: float = 0.5,
) -> str:
    """AD-risk explorer from per-tissue risk predictions (columns
    tissue_name + ad_risk, reference vcf2risk.py contract): anatomagram of
    P(AD), a live threshold slider and a flagged-tissue table."""
    data = {
        str(row["tissue_name"]): float(row[value_column])
        for _, row in df.iterrows()
    }
    body = (
        "<div class='controls'>"
        f"<label>Risk threshold <input type='range' id='thr' min='0' max='1' "
        f"step='0.01' value='{threshold}'> "
        "<span id='thrv'></span></label>"
        "<span id='flagged'></span>"
        "</div><div class='panel'><div>"
        + _blank_views(views)
        + "</div><div>"
        "<table class='values' id='tbl'><thead><tr>"
        "<th>Tissue</th><th>P(AD)</th><th>Flag</th></tr></thead>"
        "<tbody></tbody></table>"
        "</div></div>"
    )
    js = """
const thr = document.getElementById('thr');
function render(){
  const t = parseFloat(thr.value);
  document.getElementById('thrv').textContent = t.toFixed(2);
  paintRegions(DATA, 'mean');
  const rows = Object.entries(DATA).sort((a, b) => b[1] - a[1]);
  const n = rows.filter(([, v]) => v >= t).length;
  document.getElementById('flagged').textContent =
    `${n} / ${rows.length} tissues at or above threshold`;
  document.querySelector('#tbl tbody').innerHTML = rows.map(([k, v]) =>
    `<tr${v >= t ? " class='risk-hi'" : ''}><td data-v="${k}">${k}</td>` +
    `<td data-v="${v}">${v.toFixed(4)}</td>` +
    `<td data-v="${v >= t ? 1 : 0}">${v >= t ? 'AT RISK' : ''}</td></tr>`
  ).join('');
}
thr.addEventListener('input', render);
makeSortable(document.getElementById('tbl'));
render();
"""
    out_path = Path(out_path)
    out_path.write_text(_shell(title, body, data, js))
    return str(out_path)


def vcf2embed_app(
    df,
    out_path: str | Path,
    color: str = "cluster",
    hover: tuple[str, ...] = ("gene_id", "tissue", "predicted_expression"),
    title: str = "VariantFormer vcf2embed explorer",
) -> str:
    """Embedding-scatter explorer (reference vcf2embed.py's UMAP scatter):
    rows need x/y + categorical columns; color-by selector, clickable legend
    filters, hover detail line."""
    import pandas.api.types as ptypes

    cat_cols = [
        c for c in df.columns
        if c not in ("x", "y")
        and (ptypes.is_string_dtype(df[c]) or ptypes.is_object_dtype(df[c]))
    ]
    if color not in cat_cols and cat_cols:
        color = cat_cols[0]
    records = df.to_dict(orient="records")
    for r in records:
        for k, v in list(r.items()):
            if hasattr(v, "item"):
                r[k] = v.item()
    data = {"rows": records, "catCols": cat_cols, "color": color,
            "hover": list(hover)}
    body = (
        "<div class='controls'>"
        "<label>Color by <select id='color'>"
        + "".join(f"<option>{_html.escape(c)}</option>" for c in cat_cols)
        + "</select></label>"
        "<span class='legend' id='legend'></span>"
        "</div>"
        "<div id='detail'>&nbsp;</div>"
        "<svg id='scatter' width='640' height='460'></svg>"
    )
    js = """
const PALETTE = ['#a33b2a','#2a6fa3','#3c8a4e','#8a6d3b','#7a4f9c',
                 '#c26f9c','#5b8a8a','#b0722a'];
const colorSel = document.getElementById('color');
colorSel.value = DATA.color;
const off = new Set();
function categories(){
  return [...new Set(DATA.rows.map(r => String(r[colorSel.value])))];
}
function render(){
  const cats = categories();
  const cmap = Object.fromEntries(
    cats.map((c, i) => [c, PALETTE[i % PALETTE.length]]));
  document.getElementById('legend').innerHTML = cats.map(c =>
    `<span data-cat="${c}" class="${off.has(c) ? 'off' : ''}">` +
    `<i style='background:${cmap[c]}'></i>${c}</span>`).join('');
  document.querySelectorAll('#legend span').forEach(s =>
    s.addEventListener('click', () => {
      off.has(s.dataset.cat) ? off.delete(s.dataset.cat)
                             : off.add(s.dataset.cat);
      render();
    }));
  const rows = DATA.rows.filter(
    r => !off.has(String(r[colorSel.value])));
  const xs = DATA.rows.map(r => r.x), ys = DATA.rows.map(r => r.y);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const w = 640, h = 460, pad = 30;
  const px = v => pad + (w - 2 * pad) * (v - x0) / ((x1 - x0) || 1);
  const py = v => h - pad - (h - 2 * pad) * (v - y0) / ((y1 - y0) || 1);
  document.getElementById('scatter').innerHTML = rows.map((r, i) =>
    `<circle class='dot' data-i='${DATA.rows.indexOf(r)}' cx='${px(r.x)}' ` +
    `cy='${py(r.y)}' r='6' fill='${cmap[String(r[colorSel.value])]}' ` +
    `fill-opacity='0.85'/>`).join('');
  document.querySelectorAll('.dot').forEach(d => {
    d.addEventListener('mousemove', ev => {
      const r = DATA.rows[+d.dataset.i];
      const text = DATA.hover.filter(hh => hh in r)
        .map(hh => `${hh}: ${r[hh]}`).join('  |  ');
      showTip(ev, text);
      document.getElementById('detail').textContent = text;
    });
    d.addEventListener('mouseleave', hideTip);
  });
}
colorSel.addEventListener('change', render);
render();
"""
    out_path = Path(out_path)
    out_path.write_text(_shell(title, body, data, js))
    return str(out_path)
