"""Anatomagram: UBERON-mapped human body/brain heatmaps of per-tissue values.

The port's copy of ``variantformer_tpu/api/anatomagram.py`` (the same bytes
out for the same values). It draws its own stylized-but-anatomically-placed
body (male/female) and brain (sagittal) views and emits a dependency-free
interactive HTML page (tabs, hover tooltips, shared color scale) that opens
in any browser.

Every tissue of the released vocabulary maps to its UBERON term
(``vocabs/tissue_uberon.yaml``, read through the port's
``resolve_vocab_path``); tissues whose precise term has no drawn region fall
back to a hierarchy fallback region. Cell lines are never drawn; they render
in the value table. When several tissues share a drawn region (both skin
samplings -> UBERON_0000014), the region takes the ``aggregation`` of their
values ("max" default, or "mean") and the tooltip lists every contributor.
"""

from __future__ import annotations

import functools
import html as _html
import json
from pathlib import Path

import yaml

from variantformer_tpu_torch.utils.assets import resolve_vocab_path


@functools.lru_cache(maxsize=1)
def load_tissue_uberon_map() -> dict[str, dict]:
    """tissue name -> {uberon, svg, display, cell_line} from the vendored vocab."""
    with open(resolve_vocab_path("tissue_uberon.yaml")) as fh:
        return yaml.safe_load(fh)["tissues"]


# ---------------------------------------------------------------------------
# Region geometry. Each view maps svg-target UBERON ids to SVG path/shape
# fragments on its canvas. Paths are hand-drawn originals (stylized organs at
# anatomically correct positions), NOT the Expression Atlas assets.
# ---------------------------------------------------------------------------

# Body canvas: 280 x 620, body midline at x=140.
_BODY_COMMON: dict[str, tuple[str, str]] = {
    # organ id: (svg fragment with %FILL%/%TITLE% placeholders, label)
    "UBERON_0001043": (  # esophagus
        "<path d='M140 96 C141 110 139 128 140 150' stroke='%FILL%'"
        " stroke-width='7' fill='none'/>",
        "Esophagus",
    ),
    "UBERON_0007650": (  # gastroesophageal junction
        "<ellipse cx='141' cy='152' rx='6' ry='4.5' fill='%FILL%'/>",
        "Gastroesophageal junction",
    ),
    "UBERON_0002046": (  # thyroid: butterfly
        "<path d='M132 104 q4 -6 8 0 q4 -6 8 0 q0 9 -8 7 q-8 2 -8 -7 Z'"
        " fill='%FILL%'/>",
        "Thyroid",
    ),
    "UBERON_0002048": (  # lungs
        "<path d='M128 132 C112 138 104 162 106 192 C108 206 122 208 128 200"
        " C132 188 132 150 128 132 Z' fill='%FILL%'/>"
        "<path d='M152 132 C168 138 176 162 174 192 C172 206 158 208 152 200"
        " C148 188 148 150 152 132 Z' fill='%FILL%'/>",
        "Lung",
    ),
    "UBERON_0000947": (  # aorta: arch + descending
        "<path d='M144 136 q10 -10 16 2 M140 140 C150 128 160 136 156 150"
        " M148 150 L146 236' stroke='%FILL%' stroke-width='5' fill='none'/>",
        "Aorta",
    ),
    "UBERON_0006618": (  # atrial appendage: upper-right lobe of heart
        "<ellipse cx='133' cy='166' rx='7' ry='6' fill='%FILL%'/>",
        "Atrial appendage",
    ),
    "UBERON_0002084": (  # left ventricle: lower-left heart bulge
        "<path d='M134 172 C130 186 140 196 150 190 C158 184 156 170 148 166"
        " C142 164 136 166 134 172 Z' fill='%FILL%'/>",
        "Heart (left ventricle)",
    ),
    "UBERON_0001621": (  # coronary artery: arc across the heart
        "<path d='M136 170 q8 10 16 8' stroke='%FILL%' stroke-width='2.5'"
        " fill='none'/>",
        "Coronary artery",
    ),
    "UBERON_0002107": (  # liver: wedge under right lung
        "<path d='M112 214 C110 228 118 238 134 238 C152 238 162 232 164 224"
        " C160 214 146 210 132 210 C124 210 116 210 112 214 Z' fill='%FILL%'/>",
        "Liver",
    ),
    "UBERON_0000945": (  # stomach: curved sac left of liver
        "<path d='M146 214 C142 228 150 240 162 238 C174 236 178 224 172 214"
        " C166 206 150 204 146 214 Z' fill='%FILL%'/>",
        "Stomach",
    ),
    "UBERON_0002106": (  # spleen
        "<ellipse cx='178' cy='232' rx='9' ry='7' fill='%FILL%'"
        " transform='rotate(-20 178 232)'/>",
        "Spleen",
    ),
    "UBERON_0001264": (  # pancreas: horizontal behind stomach
        "<path d='M144 244 q20 -6 32 2 q-14 8 -32 4 Z' fill='%FILL%'/>",
        "Pancreas",
    ),
    "UBERON_0002369": (  # adrenal glands: caps on kidneys
        "<path d='M112 252 q8 -6 14 0 l-2 5 q-6 -3 -10 0 Z' fill='%FILL%'/>"
        "<path d='M168 252 q-8 -6 -14 0 l2 5 q6 -3 10 0 Z' fill='%FILL%'/>",
        "Adrenal gland",
    ),
    "UBERON_0001225": (  # kidney cortex: bean outlines
        "<path d='M110 258 C102 264 102 282 110 288 C118 292 124 284 122 272"
        " C121 263 116 256 110 258 Z' fill='%FILL%'/>"
        "<path d='M170 258 C178 264 178 282 170 288 C162 292 156 284 158 272"
        " C159 263 164 256 170 258 Z' fill='%FILL%'/>",
        "Kidney cortex",
    ),
    "UBERON_0002113": (  # kidney (medulla fallback): inner bean
        "<path d='M112 265 C109 269 109 278 113 281 C117 283 119 277 118 271"
        " Z' fill='%FILL%'/>"
        "<path d='M168 265 C171 269 171 278 167 281 C163 283 161 277 162 271"
        " Z' fill='%FILL%'/>",
        "Kidney (medulla)",
    ),
    "UBERON_0001155": (  # colon: frame around small intestine
        "<path d='M108 300 L108 336 M108 300 Q140 288 172 300 M172 300 L172 336"
        " M108 336 Q116 346 124 340 M172 336 Q166 350 152 348'"
        " stroke='%FILL%' stroke-width='9' fill='none' stroke-linecap='round'/>",
        "Colon",
    ),
    "UBERON_0002116": (  # small intestine (terminal ileum)
        "<path d='M126 310 q14 -6 28 0 q-14 8 -28 4 q14 10 28 6 q-12 10 -26 6"
        " q12 8 24 6' stroke='%FILL%' stroke-width='6' fill='none'"
        " stroke-linecap='round'/>",
        "Small intestine",
    ),
    "UBERON_0001255": (  # bladder
        "<path d='M130 362 q10 -8 20 0 q0 12 -10 12 q-10 0 -10 -12 Z'"
        " fill='%FILL%'/>",
        "Bladder",
    ),
    "UBERON_0001013": (  # adipose: flank zones
        "<path d='M100 288 q-8 18 -2 38 l8 -2 q-5 -18 0 -34 Z' fill='%FILL%'/>"
        "<path d='M180 288 q8 18 2 38 l-8 -2 q5 -18 0 -34 Z' fill='%FILL%'/>",
        "Adipose tissue",
    ),
    "UBERON_0001134": (  # skeletal muscle: right thigh zone
        "<path d='M116 420 C112 450 112 484 118 506 L134 506 C138 480 138 446"
        " 134 420 Z' fill='%FILL%'/>",
        "Skeletal muscle (thigh)",
    ),
    "UBERON_0001021": (  # nerve: left-leg line
        "<path d='M158 416 C160 460 160 520 158 566' stroke='%FILL%'"
        " stroke-width='3.5' fill='none' stroke-dasharray='6 3'/>",
        "Peripheral nerve (tibial)",
    ),
    "UBERON_0001637": (  # artery (tibial fallback): left-leg vessel
        "<path d='M150 416 C152 460 152 520 150 566' stroke='%FILL%'"
        " stroke-width='3.5' fill='none'/>",
        "Artery (tibial)",
    ),
    "UBERON_0000014": (  # skin: right forearm strip
        "<path d='M74 220 L64 288 L76 290 L84 224 Z' fill='%FILL%'/>",
        "Skin zone (forearm)",
    ),
    "UBERON_0000178": (  # blood: drop beside the body
        "<path d='M58 140 q10 16 0 24 q-10 -8 0 -24 Z' fill='%FILL%'/>",
        "Blood",
    ),
    "UBERON_0001044": (  # saliva gland (minor salivary fallback): cheek dot
        "<ellipse cx='126' cy='62' rx='5' ry='4' fill='%FILL%'/>",
        "Salivary gland",
    ),
}

_BODY_MALE: dict[str, tuple[str, str]] = {
    "UBERON_0002367": (
        "<ellipse cx='140' cy='382' rx='9' ry='6' fill='%FILL%'/>",
        "Prostate",
    ),
    "UBERON_0000473": (
        "<ellipse cx='133' cy='398' rx='6' ry='8' fill='%FILL%'/>"
        "<ellipse cx='147' cy='398' rx='6' ry='8' fill='%FILL%'/>",
        "Testis",
    ),
}

_BODY_FEMALE: dict[str, tuple[str, str]] = {
    "UBERON_0000310": (  # breast
        "<circle cx='118' cy='192' r='13' fill='%FILL%'/>"
        "<circle cx='162' cy='192' r='13' fill='%FILL%'/>",
        "Breast (mammary)",
    ),
    "UBERON_0003889": (  # fallopian tubes
        "<path d='M132 352 q-12 -8 -20 2' stroke='%FILL%' stroke-width='3.5'"
        " fill='none'/>"
        "<path d='M148 352 q12 -8 20 2' stroke='%FILL%' stroke-width='3.5'"
        " fill='none'/>",
        "Fallopian tube",
    ),
    "UBERON_0000992": (  # ovaries
        "<ellipse cx='112' cy='356' rx='5.5' ry='4.5' fill='%FILL%'/>"
        "<ellipse cx='168' cy='356' rx='5.5' ry='4.5' fill='%FILL%'/>",
        "Ovary",
    ),
    "UBERON_0000995": (  # uterus: pear
        "<path d='M132 348 q8 -6 16 0 q4 12 -2 18 q-6 5 -12 0 q-6 -6 -2 -18 Z'"
        " fill='%FILL%'/>",
        "Uterus",
    ),
    "UBERON_0000002": (  # uterine cervix (endocervix fallback)
        "<rect x='135' y='366' width='10' height='6' rx='2' fill='%FILL%'/>",
        "Cervix",
    ),
    "UBERON_0012249": (  # ectocervix
        "<rect x='136' y='372' width='8' height='4' rx='2' fill='%FILL%'/>",
        "Ectocervix",
    ),
    "UBERON_0000996": (  # vagina
        "<rect x='137' y='376' width='6' height='12' rx='3' fill='%FILL%'/>",
        "Vagina",
    ),
}

# Brain canvas: 340 x 280 sagittal view, anterior (face) at the left.
_BRAIN: dict[str, tuple[str, str]] = {
    "UBERON_0000956": (  # cerebral cortex: outer band (parietal/occipital)
        "<path d='M128 36 C180 22 244 40 258 96 C264 120 258 142 240 154"
        " L228 146 C248 128 250 102 238 80 C222 50 172 34 134 48 Z'"
        " fill='%FILL%'/>",
        "Cerebral cortex",
    ),
    "UBERON_0001870": (  # frontal lobe: anterior region
        "<path d='M128 36 C92 44 68 70 66 102 C65 120 72 134 84 142 L98 132"
        " C86 122 82 106 88 88 C96 64 112 50 134 48 Z' fill='%FILL%'/>",
        "Frontal lobe",
    ),
    "UBERON_0001873": (  # caudate: C-arc above thalamus
        "<path d='M128 84 C148 78 168 84 174 98 C168 96 150 92 136 96'"
        " stroke='%FILL%' stroke-width='8' fill='none' stroke-linecap='round'/>",
        "Caudate nucleus",
    ),
    "UBERON_0001874": (  # putamen
        "<ellipse cx='146' cy='106' rx='13' ry='8' fill='%FILL%'"
        " transform='rotate(-12 146 106)'/>",
        "Putamen",
    ),
    "UBERON_0001882": (  # nucleus accumbens: antero-inferior to putamen
        "<circle cx='122' cy='118' r='6.5' fill='%FILL%'/>",
        "Nucleus accumbens",
    ),
    "UBERON_0002421": (  # hippocampus: curved arc in temporal region
        "<path d='M160 132 C178 128 192 134 198 146' stroke='%FILL%'"
        " stroke-width='7' fill='none' stroke-linecap='round'/>",
        "Hippocampal formation",
    ),
    "UBERON_0001876": (  # amygdala: anterior tip of hippocampus
        "<circle cx='154' cy='134' r='6' fill='%FILL%'/>",
        "Amygdala",
    ),
    "UBERON_0001898": (  # hypothalamus
        "<ellipse cx='134' cy='130' rx='8' ry='5.5' fill='%FILL%'/>",
        "Hypothalamus",
    ),
    "UBERON_0000007": (  # pituitary on its stalk
        "<path d='M134 136 L132 146' stroke='#999' stroke-width='1.5'/>"
        "<circle cx='131' cy='150' r='5' fill='%FILL%'/>",
        "Pituitary gland",
    ),
    "UBERON_0002038": (  # substantia nigra: midbrain
        "<ellipse cx='160' cy='150' rx='8' ry='4' fill='%FILL%'"
        " transform='rotate(24 160 150)'/>",
        "Substantia nigra",
    ),
    "UBERON_0002037": (  # cerebellum: posterior-inferior
        "<path d='M206 158 C230 152 248 162 248 178 C248 194 228 202 210 196"
        " C196 190 194 168 206 158 Z' fill='%FILL%'/>",
        "Cerebellum",
    ),
    "UBERON_0002245": (  # cerebellar hemisphere: lateral lobe
        "<path d='M212 166 C226 162 238 170 238 180 C238 190 224 194 214 190"
        " C206 186 206 172 212 166 Z' fill='%FILL%'/>",
        "Cerebellar hemisphere",
    ),
    "UBERON_0002240": (  # spinal cord: brainstem down
        "<path d='M172 158 C178 172 182 192 182 216 L182 254' stroke='%FILL%'"
        " stroke-width='9' fill='none' stroke-linecap='round'/>",
        "Spinal cord",
    ),
}

_BODY_SILHOUETTE = (
    "<g fill='#f4efe8' stroke='#c9c2b6' stroke-width='1.2'>"
    "<ellipse cx='140' cy='52' rx='30' ry='34'/>"                 # head
    "<rect x='127' y='82' width='26' height='20' rx='8'/>"        # neck
    "<path d='M86 108 Q140 92 194 108 L200 150 Q206 240 196 320"  # torso
    " Q180 372 140 380 Q100 372 84 320 Q74 240 80 150 Z'/>"
    "<path d='M84 116 Q64 130 62 170 L56 268 Q56 286 70 288"      # arms
    " L86 292 Z'/>"
    "<path d='M196 116 Q216 130 218 170 L224 268 Q224 286 210 288"
    " L194 292 Z'/>"
    "<path d='M100 376 Q96 470 104 560 Q106 576 124 576 L134 576"  # legs
    " Q140 480 138 400 Z'/>"
    "<path d='M180 376 Q184 470 176 560 Q174 576 156 576 L146 576"
    " Q140 480 142 400 Z'/>"
    "</g>"
)

_BRAIN_SILHOUETTE = (
    "<g fill='#f4efe8' stroke='#c9c2b6' stroke-width='1.2'>"
    "<path d='M130 34 C60 44 44 110 76 146 C64 160 70 176 86 180"
    " C100 216 140 224 168 210 L176 252 L190 252 L184 206"
    " C226 210 262 186 266 144 C276 96 246 40 186 30 C166 26 148 30 130 34 Z'/>"
    "</g>"
)

_VIEWS = {
    "male": (280, 620, _BODY_SILHOUETTE, ({**_BODY_COMMON, **_BODY_MALE})),
    "female": (280, 620, _BODY_SILHOUETTE, ({**_BODY_COMMON, **_BODY_FEMALE})),
    "brain": (340, 280, _BRAIN_SILHOUETTE, _BRAIN),
}


def _heat(frac: float) -> str:
    """Pale straw -> deep red ramp (Expression-Atlas-like)."""
    frac = max(0.0, min(1.0, frac))
    r = int(248 - 90 * frac)
    g = int(232 * (1 - frac) + 30)
    b = int(190 * (1 - frac) + 30)
    return f"rgb({r},{g},{b})"


def region_values(
    tissue_values: dict[str, float], aggregation: str = "max"
) -> tuple[dict[str, tuple[float, list[str]]], list[str]]:
    """Aggregate tissue values onto drawable UBERON regions.

    Returns ({svg_uberon: (value, [contributing tissue, ...])}, [cell lines]).
    """
    mapping = load_tissue_uberon_map()
    regions: dict[str, list[tuple[str, float]]] = {}
    cell_lines: list[str] = []
    for tissue, value in tissue_values.items():
        m = mapping.get(tissue) or mapping.get(tissue.lower())
        if m is None or m.get("cell_line"):
            cell_lines.append(tissue)
            continue
        regions.setdefault(m["svg"], []).append((tissue, float(value)))
    agg = max if aggregation == "max" else (lambda vs: sum(vs) / len(vs))
    out = {}
    for uberon, pairs in regions.items():
        out[uberon] = (agg([v for _, v in pairs]), [t for t, _ in pairs])
    return out, cell_lines


def anatomagram_svg(
    tissue_values: dict[str, float],
    view: str = "male",
    vmin: float | None = None,
    vmax: float | None = None,
    aggregation: str = "max",
) -> str:
    """Render one gene's per-tissue values as a body/brain-map SVG string.

    Regions carry ``data-uberon`` and ``data-tissues`` attributes plus a
    <title> tooltip, so the SVG is interactive when embedded by
    ``anatomagram_html`` and self-describing when viewed standalone.
    """
    if view not in _VIEWS:
        raise ValueError(f"view must be one of {sorted(_VIEWS)}, got {view!r}")
    w, h, silhouette, shapes = _VIEWS[view]
    vals, _ = region_values(tissue_values, aggregation)
    lo = min((v for v, _ in vals.values()), default=0.0) if vmin is None else vmin
    hi = max((v for v, _ in vals.values()), default=1.0) if vmax is None else vmax
    span = (hi - lo) or 1.0

    mapping = load_tissue_uberon_map()
    display = {t: m.get("display", t) for t, m in mapping.items()}
    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' viewBox='0 0 {w} {h}' "
        f"width='{w}' height='{h}' class='anatomagram' data-view='{view}'>",
        silhouette,
    ]
    for uberon, (fragment, label) in shapes.items():
        if uberon in vals:
            value, tissues = vals[uberon]
            color = _heat((value - lo) / span)
            tip = "; ".join(
                f"{display.get(t, t)}: {tissue_values[t]:.3f}" for t in tissues
            )
            extra = ""
        else:
            color = "#e3ddd2"
            tip = f"{label}: no data"
            tissues = []
            extra = " data-empty='1'"
        body = fragment.replace("%FILL%", color)
        parts.append(
            f"<g class='region' data-uberon='{uberon}' "
            f"data-label='{_html.escape(label)}' "
            f"data-tissues='{_html.escape(json.dumps(tissues))}'{extra}>"
            f"<title>{_html.escape(f'{label} — {tip}' if tissues else tip)}</title>"
            f"{body}</g>"
        )
    parts.append("</svg>")
    return "".join(parts)


_PAGE_CSS = """
body{font-family:system-ui,sans-serif;margin:1.5rem;color:#222}
.gene{margin-bottom:2.5rem;border-top:1px solid #ddd;padding-top:1rem}
.tabs button{border:1px solid #bbb;background:#f6f4f0;padding:.3rem .9rem;
  cursor:pointer;border-radius:6px 6px 0 0;margin-right:.2rem}
.tabs button.active{background:#fff;border-bottom:2px solid #fff;font-weight:600}
.view{display:none;padding:.5rem;border:1px solid #bbb;border-radius:0 6px 6px 6px}
.view.active{display:flex;gap:2rem;align-items:flex-start}
.region{stroke:#8a8274;stroke-width:.5;cursor:pointer}
.region:hover{stroke:#222;stroke-width:1.6}
.region[data-empty]{opacity:.55}
#tooltip{position:fixed;pointer-events:none;background:#222;color:#fff;
  padding:.35rem .6rem;border-radius:4px;font-size:.8rem;display:none;z-index:9}
table.values{border-collapse:collapse;font-size:.8rem}
table.values td,table.values th{border:1px solid #ddd;padding:.15rem .5rem;
  text-align:left}
.scale{height:12px;width:220px;background:linear-gradient(90deg,%G0%,%G1%)}
.scalewrap{font-size:.75rem;margin:.4rem 0}
"""

_PAGE_JS = """
const tip = document.getElementById('tooltip');
document.querySelectorAll('.region').forEach(r => {
  r.addEventListener('mousemove', ev => {
    const t = r.querySelector('title');
    tip.textContent = t ? t.textContent : r.dataset.label;
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 6) + 'px';
    tip.style.display = 'block';
  });
  r.addEventListener('mouseleave', () => tip.style.display = 'none');
});
document.querySelectorAll('.tabs button').forEach(b => {
  b.addEventListener('click', () => {
    const gene = b.closest('.gene');
    gene.querySelectorAll('.tabs button').forEach(x => x.classList.remove('active'));
    gene.querySelectorAll('.view').forEach(x => x.classList.remove('active'));
    b.classList.add('active');
    gene.querySelector(`.view[data-view="${b.dataset.view}"]`).classList.add('active');
  });
});
"""


def anatomagram_html(
    predictions: dict[str, dict[str, float]],
    out_path: str | Path,
    title: str = "VariantFormer anatomagram",
    views: tuple[str, ...] = ("male", "female", "brain"),
    aggregation: str = "max",
) -> str:
    """Interactive multi-view page of body maps.

    predictions: {gene (or risk item): {tissue: value}}. Each item gets
    Male / Female / Brain tabs sharing one color scale, a hover tooltip with
    the contributing tissues' values, and a full value table (cell lines
    included) beside the figure.
    """
    mapping = load_tissue_uberon_map()
    display = {t: m.get("display", t) for t, m in mapping.items()}
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        "<style>",
        _PAGE_CSS.replace("%G0%", _heat(0.0)).replace("%G1%", _heat(1.0)),
        "</style></head><body>",
        f"<h1>{_html.escape(title)}</h1>",
        "<div id='tooltip'></div>",
    ]
    for gene, tissues in predictions.items():
        numeric = {t: float(v) for t, v in tissues.items()}
        vals, _ = region_values(numeric, aggregation)
        drawable = [v for v, _ in vals.values()]
        lo, hi = (min(drawable), max(drawable)) if drawable else (0.0, 1.0)
        parts.append(f"<div class='gene'><h2>{_html.escape(str(gene))}</h2>")
        parts.append(
            "<div class='scalewrap'>"
            f"{lo:.3g} <span class='scale' style='display:inline-block;"
            "vertical-align:middle'></span> "
            f"{hi:.3g}</div>"
        )
        parts.append("<div class='tabs'>")
        for i, view in enumerate(views):
            active = " class='active'" if i == 0 else ""
            parts.append(
                f"<button data-view='{view}'{active}>{view.title()}</button>"
            )
        parts.append("</div>")
        for i, view in enumerate(views):
            active = " active" if i == 0 else ""
            rows = "".join(
                f"<tr><td>{_html.escape(display.get(t, t))}</td>"
                f"<td>{v:.4g}</td></tr>"
                for t, v in sorted(numeric.items(), key=lambda kv: -kv[1])
            )
            parts.append(
                f"<div class='view{active}' data-view='{view}'>"
                + anatomagram_svg(
                    numeric, view=view, vmin=lo, vmax=hi, aggregation=aggregation
                )
                + "<table class='values'><tr><th>Tissue</th><th>Value</th></tr>"
                + rows
                + "</table></div>"
            )
        parts.append("</div>")
    parts.append(f"<script>{_PAGE_JS}</script></body></html>")
    out_path = Path(out_path)
    out_path.write_text("".join(parts))
    return str(out_path)


def anatomagram_from_prediction_df(df, out_path, value_column="predicted_expression"):
    """Adapter for VCFProcessor.predict output (one row per gene with
    parallel tissue_names / value arrays), as the reference's
    EnhancedVCFExpressionConverter consumes."""
    predictions = {}
    for _, row in df.iterrows():
        predictions[row["gene_id"]] = dict(
            zip(row["tissue_names"], [float(v) for v in row[value_column]])
        )
    return anatomagram_html(predictions, out_path)


def anatomagram_from_risk_df(
    df, out_path, risk_item_name="AD_RISK", value_column="ad_risk",
    aggregation="mean",
):
    """Adapter for per-tissue risk predictions (reference
    EnhancedVCFRiskConverter contract: columns tissue_name + ad_risk; mean
    aggregation across tissues sharing one region)."""
    values = {
        str(row["tissue_name"]): float(row[value_column])
        for _, row in df.iterrows()
    }
    return anatomagram_html(
        {risk_item_name: values}, out_path, title=f"{risk_item_name} anatomagram",
        aggregation=aggregation,
    )
