"""A narrow configuration and small traffic of every kind, for the CPU tests:
the harness's whole run at a size a test can hold."""

from __future__ import annotations

import copy
import json

from vfx_bench import harness


def tiny_config(name: str = "v4_pcg") -> dict:
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["window_encoder"].update(embedding_dim=32, num_heads=4, num_layers=2, ffn_hidden_dim=64)
    cfg["seq2gene"].update(emb_dim=48, gene_emb_dim=32, token_dim=32, num_heads=4, num_layers=3,
                           ffn_hidden_dim=64)
    cfg["dataset"].update(max_length=24, max_chunks=6, gene_upstream_neighbour_hood=100,
                          gene_downstream_neighbour_hood=3000)
    return cfg


GENOME = {"genes": 6, "spacing": 1800, "jitter": 50, "margin": 300, "window_up": 100,
          "window_down": 3000, "gene_extra": 300, "cre_median": 3, "cre_sigma": 0.5,
          "cre_min": 2, "cre_max": 5, "snv_per_kb": 4.0, "het_share": 0.6, "donors": 2}

TRAFFIC = {
    "forward": {"kind": "forward", "donors": 2, "cre_windows": 5, "gene_windows": 4,
                "tokens": 24, "tissues": 3, "batches": 2, "trace_calls": 2},
    "query": {"kind": "query", "genome": GENOME, "tissues": 3, "check_sample": 3,
              "trace_calls": 2, "warm_genes": 2, "build_workers": 1},
    "sweep": {"kind": "sweep", "genome": GENOME, "tissues": 3, "batch_size": 2,
              "check_sample": 3, "trace_calls": 1, "build_workers": 1},
    "finetune": {"kind": "finetune", "genome": dict(GENOME, donors=1), "tissues": 3,
                 "genes_per_step": 2, "check_steps": 3, "trace_steps": 1, "build_workers": 1},
}


def tiny_cell(kind: str, limits: dict | None = None) -> harness.Cell:
    man = harness.manifest()
    cfg = tiny_config("v4_pcg_ft" if kind == "finetune" else "v4_pcg")
    name = f"tiny.{kind}"
    return harness.Cell(
        name=name, config=cfg, traffic=copy.deepcopy(TRAFFIC[kind]),
        limits=limits or {}, chips=1,
        end_to_end=[m for m in man["end_to_end"]],
        per_layer=[m for m in man["per_layer"]],
    )
