"""Live model-in-the-loop app: a stdlib ``http.server`` app whose page
round-trips user interactions through a JSON endpoint that runs the model.

The port's copy of ``variantformer_tpu/api/live.py``, over the port's
``VCFProcessor`` (on the card unless the processor was made with
``device="cpu"``): gene/tissue re-selection and in-silico edits merged into
the donor VCF by ``create_vcf_from_variant`` re-run ``predict``, then the
page recolors the anatomagram and tables from the fresh predictions
(``api/webapp.py`` renders the static pages).

Usage::

    proc = VCFProcessor(sources=...); proc.load_model()
    LiveExpressionApp(proc, vcf_path=donor_vcf).serve(port=8765)

Endpoints:
  GET  /            the app page (self-contained HTML+JS)
  POST /api/predict {"gene": id, "tissues": [names], "edits": [
                      {"chrom","pos","ref","alt","zygosity": "het"|"hom"}]}
                    -> {"values": {tissue: expression}, "seconds": float,
                        "vcf": basename-used, "cached": bool}
"""

from __future__ import annotations

import hashlib
import html as _html
import json
import logging
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pandas as pd

from variantformer_tpu_torch.api.webapp import _blank_views, _json_embed, _shell

log = logging.getLogger(__name__)


class LiveExpressionApp:
    """Serve a live vcf2exp explorer around a loaded :class:`VCFProcessor`.

    Model calls are serialized with a lock (one device) and cached per
    (gene, tissues, edits) so repeated interactions are instant."""

    def __init__(
        self,
        processor,
        vcf_path: str | None = None,
        genes: list[str] | None = None,
        workdir: str | None = None,
    ):
        self.proc = processor
        self.vcf_path = vcf_path
        gencode = processor.get_genes()
        self.genes = genes or list(gencode["gene_id"].head(200))
        self.tissues = list(processor.get_tissues())
        self.workdir = Path(workdir or tempfile.mkdtemp(prefix="vfx_live_"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._cache: dict[tuple, dict] = {}

    # -- model round trip ---------------------------------------------------
    def predict(self, gene: str, tissues: list[str], edits: list[dict]) -> dict:
        bad = [t for t in tissues if t not in self.tissues]
        if bad:
            raise ValueError(f"unknown tissues: {bad[:3]}")
        if gene not in self.genes:
            raise ValueError(f"unknown gene {gene!r}")
        norm_edits = tuple(
            (str(e["chrom"]), int(e["pos"]), str(e["ref"]).upper(),
             str(e["alt"]).upper(), str(e.get("zygosity", "het")).lower())
            for e in edits
        )
        key = (gene, tuple(sorted(tissues)), norm_edits)
        if key in self._cache:
            return dict(self._cache[key], cached=True)
        with self._lock:
            if key in self._cache:  # raced
                return dict(self._cache[key], cached=True)
            t0 = time.time()
            vcf = self.vcf_path
            if norm_edits:
                tag = hashlib.sha1(repr(norm_edits).encode()).hexdigest()[:12]
                edited = self.workdir / f"edit_{tag}.vcf.gz"
                if not edited.exists():
                    var_df = pd.DataFrame(
                        [
                            {"chrom": c, "pos": p, "ref": r, "alt": a,
                             "GT": "1|1" if z == "hom" else "0|1"}
                            for c, p, r, a, z in norm_edits
                        ]
                    )
                    self.proc.create_vcf_from_variant(
                        var_df, str(edited), vcf_path=self.vcf_path
                    )
                vcf = str(edited)
            query = pd.DataFrame(
                {"gene_id": [gene], "tissues": [",".join(tissues)]}
            )
            out = self.proc.predict(vcf, query)
            row = out.iloc[0]
            result = {
                "values": {
                    str(t): float(v)
                    for t, v in zip(
                        row["tissue_names"], row["predicted_expression"]
                    )
                },
                "seconds": round(time.time() - t0, 2),
                "vcf": Path(vcf).name if vcf else "reference (no VCF)",
                "cached": False,
            }
            self._cache[key] = result
            return result

    # -- page ---------------------------------------------------------------
    def page(self) -> str:
        body = (
            "<div class='controls'>"
            "<label>Gene <select id='gene'>"
            + "".join(
                f"<option value='{_html.escape(g)}'>{_html.escape(g)}</option>"
                for g in self.genes
            )
            + "</select></label>"
            "<label>Filter tissues <input type='search' id='search' "
            "placeholder='e.g. brain'></label>"
            "<button id='run'>Run model</button>"
            "<span id='status'>idle</span>"
            "</div>"
            "<div class='controls'><label>In-silico edits "
            "(one per line: chrom pos ref alt het|hom)<br>"
            "<textarea id='edits' rows='3' cols='48' "
            "placeholder='chr1 721 C T het'></textarea></label></div>"
            "<div class='panel'><div>"
            + _blank_views(("male", "female", "brain"))
            + "</div><div>"
            "<svg id='bars' width='420' height='300'></svg>"
            "<table class='values' id='tbl'><thead><tr>"
            "<th>Tissue</th><th>Expression</th></tr></thead>"
            "<tbody></tbody></table>"
            "</div></div>"
        )
        js = """
const geneSel = document.getElementById('gene');
const search = document.getElementById('search');
const status = document.getElementById('status');
let VALUES = {};
function render(){
  paintRegions(VALUES, 'mean');
  const q = search.value.toLowerCase();
  const rows = Object.entries(VALUES)
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
function parseEdits(){
  return document.getElementById('edits').value.split('\\n')
    .map(l => l.trim()).filter(Boolean).map(l => {
      const [chrom, pos, ref, alt, zyg] = l.split(/\\s+/);
      return {chrom, pos: +pos, ref, alt, zygosity: zyg || 'het'};
    });
}
async function runModel(){
  status.textContent = 'running model…';
  try {
    const resp = await fetch('/api/predict', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({gene: geneSel.value,
        tissues: ALL_TISSUES, edits: parseEdits()})});
    const out = await resp.json();
    if (out.error) { status.textContent = 'error: ' + out.error; return; }
    VALUES = out.values;
    status.textContent = `${out.vcf} · ${out.seconds}s` +
      (out.cached ? ' (cached)' : '');
    render();
  } catch (e) { status.textContent = 'error: ' + e; }
}
document.getElementById('run').addEventListener('click', runModel);
geneSel.addEventListener('change', runModel);
search.addEventListener('input', render);
makeSortable(document.getElementById('tbl'));
runModel();
"""
        js = f"const ALL_TISSUES = {_json_embed(self.tissues)};\n" + js
        return _shell(
            "VariantFormer live explorer (model in the loop)", body, {}, js
        )

    # -- server -------------------------------------------------------------
    def handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                log.debug("live: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?")[0] in ("/", "/index.html"):
                    self._send(
                        200, app.page().encode(), "text/html; charset=utf-8"
                    )
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/api/predict":
                    self._send(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = app.predict(
                        req["gene"],
                        list(req.get("tissues") or app.tissues),
                        list(req.get("edits") or []),
                    )
                    code = 200
                except Exception as exc:
                    log.exception("live predict failed")
                    out, code = {"error": str(exc)}, 400
                self._send(
                    code, json.dumps(out).encode(), "application/json"
                )

        return Handler

    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        return ThreadingHTTPServer((host, port), self.handler())

    def serve(self, host: str = "127.0.0.1", port: int = 8765):
        srv = self.make_server(host, port)
        log.info("live app at http://%s:%d/", *srv.server_address)
        print(f"live app at http://{srv.server_address[0]}:"
              f"{srv.server_address[1]}/  (Ctrl-C to stop)")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
