"""Traffic kind ``query``: the wait for one answer, one client, closed loop.

Each query is ``VCFProcessor.predict`` of one gene x ``tissues`` tissues
for one donor's VCF (BGZF + tabix) on the synthetic genome of the
traffic's ``genome`` group; genes come in seeded permutations of all the
genes, one after another (``predict`` keeps no cache). The latency of a query is the host clock
around its ``predict``; the end-to-end metric is the 90th percentile of all
queries completed in the window.
"""

from __future__ import annotations

import time

import numpy as np
import pandas as pd
import torch

from vfx_bench import compare, serving

ORDER = 100_000  # queries drawn per run: more than any window completes


def _order(seed: int, genes: int) -> np.ndarray:
    """Every gene once in a seeded order, again in another, and so on: each
    seed asks for the same sizes, in another order."""
    rng = np.random.default_rng([seed, 20])
    return np.concatenate([rng.permutation(genes) for _ in range(-(-ORDER // genes))])


def setup(run) -> dict:
    g = serving.genome(run, donors=1)
    proc = serving.processor(run, g)
    order = _order(run.seed, len(g.genes))
    counts = np.asarray([len(g.cre_maps[x]) for x in g.genes])
    state = {"g": g, "proc": proc, "order": order, "tissues": ",".join(g.tissue_names)}
    # Warm-up: the genes with the most and the fewest CREs (the largest and
    # smallest batch shapes of the traffic).
    for i in sorted({int(counts.argmax()), int(counts.argmin())})[:run.cell.traffic.get(
            "warm_genes", 2)]:
        _query(state, i)
    return state


def _query(state: dict, gene_index: int):
    df = pd.DataFrame({"gene_id": [state["g"].genes[gene_index]], "tissues": [state["tissues"]]})
    with torch.profiler.record_function("vfx_bench.predict"):
        out = state["proc"].predict(state["g"].vcfs[0], df)
    return out["predicted_expression"].iloc[0], out["embeddings"].iloc[0]


def window(run, state: dict) -> None:
    lat, kept = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        gi = int(state["order"][len(lat)])
        q0 = time.perf_counter()
        kept.append((gi, *_query(state, gi)))
        lat.append(time.perf_counter() - q0)
    run.attempted = len(lat)
    run.kept["answers"] = kept
    run.counters.update(window_s=time.perf_counter() - t0, queries=len(lat),
                        latency_p50_ms=1e3 * float(np.percentile(lat, 50)))
    run.end_to_end["query_p90_ms"] = 1e3 * float(np.percentile(lat, 90))


def traced(run, state: dict, tracer) -> None:
    calls = run.cell.traffic["trace_calls"]
    with tracer.window():
        for k in range(calls):
            _query(state, int(state["order"][k]))
    run.counters["trace_calls"] = calls


def release(run, state: dict) -> None:
    run.kept["g"] = state["g"]
    state["proc"].cleanup()
    state.clear()


def _gaps(run, prog: list, genes: list[int], fp8_ref: bool = False) -> dict:
    g = run.kept["g"]
    samples = serving.rebuild(run, g, [(g.genes[i], g.vcfs[0]) for i in genes])
    tissue_ids = list(range(len(g.tissue_names)))
    if fp8_ref:
        prog = serving.reference(run, samples, tissue_ids, fp8=True)
    return compare.serve_gaps(prog, serving.reference(run, samples, tissue_ids))


def check(run) -> None:
    answers = run.kept["answers"]
    pick = serving.sample(run.seed, len(answers), run.cell.traffic["check_sample"], 21)
    run.readings.update(_gaps(run, [answers[i][1:] for i in pick],
                              [answers[i][0] for i in pick]))


def control(run) -> dict:
    """The numbers compared with the reference in float8 in the program's
    place, on as many genes of the run's order as a run compares."""
    run.kept["g"] = serving.genome(run, donors=1)
    order = _order(run.seed, len(run.kept["g"].genes))
    genes = [int(order[i]) for i in range(run.cell.traffic["check_sample"])]
    return _gaps(run, None, genes, fp8_ref=True)
