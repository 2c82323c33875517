"""live_app — serve the model-in-the-loop explorer (``api/live.py``).

The port of ``examples/live_app.py``: a stdlib HTTP server whose page
re-runs ``VCFProcessor`` on every interaction (gene/tissue re-selection and
in-silico variant edits merged into the donor VCF in-process), then
recolours the anatomagram and tables from the fresh predictions.

    python -m variantformer_tpu_torch.examples.live_app [--port 8765] [--once] [--device cpu]

``--once`` starts the server on a free local port, makes one interaction
round trip (a base prediction and an in-silico edit) and exits.
"""

import json
import sys
import tempfile
import threading
import urllib.request
from pathlib import Path

from variantformer_tpu_torch.examples import _common


def main(root=None, device: str = "cuda", port: int = 8765, once: bool = True):
    """With ``once``, returns ``{"base": ..., "edited": ...}`` (each the
    server's JSON answer; ``edited`` None when the probe base is ambiguous);
    otherwise serves until interrupted."""
    root = Path(root or tempfile.mkdtemp(prefix="vfx_live_"))
    proc, extras = _common.build_processor(root / "env", device)
    from variantformer_tpu_torch.api.live import LiveExpressionApp

    genes = None if _common.artifacts_present() else ["GENE1.1", "GENE2.1"]
    app = LiveExpressionApp(proc, vcf_path=extras["vcf"], genes=genes,
                            workdir=str(root / "live"))
    if not once:
        app.serve(port=port)
        return None

    srv = app.make_server(port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, bound = srv.server_address
    print(f"live app at http://{host}:{bound}/")

    def post(payload):
        req = urllib.request.Request(
            f"http://{host}:{bound}/api/predict",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    try:
        gene = app.genes[0]
        tissues = app.tissues[:3]
        base = post({"gene": gene, "tissues": tissues})
        print(f"base prediction ({base['seconds']}s via {base['vcf']}):")
        for t, v in base["values"].items():
            print(f"  {t:24s} {v:.4f}")

        # in-silico edit: flip a base just inside the gene's start
        gencode = proc.get_genes()
        row = gencode[gencode["gene_id"] == gene].iloc[0]
        from variantformer_tpu_torch.utils.fasta import FastaReader

        fasta = FastaReader(proc.sources.fasta_path)
        pos = int(row["start"]) + 5
        ref = fasta.fetch(row["chromosome"], pos - 1, pos).upper()
        alt = {"A": "G", "C": "T", "G": "A", "T": "C"}.get(ref)
        edited = None
        if alt is None:
            print("reference base ambiguous at probe position; skipping edit")
        else:
            edited = post({
                "gene": gene, "tissues": tissues,
                "edits": [{"chrom": str(row["chromosome"]), "pos": pos,
                           "ref": ref, "alt": alt, "zygosity": "hom"}],
            })
            print(f"\nwith in-silico {ref}->{alt} hom edit at "
                  f"{row['chromosome']}:{pos} ({edited['seconds']}s):")
            for t, v in edited["values"].items():
                print(f"  {t:24s} {v:.4f}  (Δ {v - base['values'][t]:+.5f})")
    finally:
        srv.shutdown()
        srv.server_close()
    return {"base": base, "edited": edited}


if __name__ == "__main__":
    args = _common.flow_args(
        __doc__, **{"--port": {"type": int, "default": 8765},
                    "--once": {"action": "store_true"}})
    result = main(args.root, args.device, args.port, args.once)
    sys.exit(0 if result is not None or not args.once else 1)
