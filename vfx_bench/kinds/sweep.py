"""Traffic kind ``sweep``: the user's genome-wide run, host-bound.

Each call is ``api/sweeps.genome_wide_expression`` over a ``VCFProcessor``
(``batch_size`` genes a dispatch, ``tissues`` tissues) for every gene of
the synthetic genome, in a seeded order, and one donor's VCF (BGZF +
tabix); donors rotate call by call. The rate is the genes of the
calls completed over their time (the window ends with the call that
crosses it). ``host_build_ms.sweep`` reads the calls' ``stats``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vfx_bench import compare, flops, serving


def _genes(run, g, k: int) -> list[str]:
    """Call ``k``'s genes: every gene of the genome, in a seeded order."""
    rng = np.random.default_rng([run.seed, 30, k])
    return [g.genes[i] for i in rng.permutation(len(g.genes))]


def setup(run) -> dict:
    g = serving.genome(run)
    proc = serving.processor(run, g)
    state = {"g": g, "proc": proc}
    # Warm-up: one dispatch of the genes with the most CREs (the largest shape).
    counts = [len(g.cre_maps[x]) for x in g.genes]
    top = [g.genes[i] for i in np.argsort(counts)[::-1][:run.cell.traffic["batch_size"]]]
    _call(run, state, top, g.vcfs[0])
    return state


def _call(run, state: dict, genes: list[str], vcf: str) -> tuple:
    from variantformer_tpu_torch.api.sweeps import genome_wide_expression

    stats: dict = {}
    with torch.profiler.record_function("vfx_bench.genome_wide_expression"):
        df = genome_wide_expression(state["proc"], vcf, state["g"].tissue_names, genes=genes,
                                    batch_size=run.cell.traffic["batch_size"], stats=stats)
    return df, stats


def window(run, state: dict) -> None:
    g = state["g"]
    kept, genes_done, build_s, build_n = [], 0, 0.0, 0
    k = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        vcf = g.vcfs[k % len(g.vcfs)]
        df, stats = _call(run, state, _genes(run, g, k), vcf)
        pred = {gid: grp["predicted_expression"].to_numpy() for gid, grp in df.groupby("gene_id",
                                                                                         sort=False)}
        kept.append((vcf, pred))
        genes_done += len(pred)
        hb = stats["stages"].get("host_build", {})
        build_s += hb.get("total_s", 0.0)
        build_n += hb.get("count", 0)
        k += 1
    elapsed = time.perf_counter() - t0
    run.attempted = k
    run.kept["answers"] = kept
    run.counters.update(window_s=elapsed, calls=k, genes=genes_done, host_build_s=build_s,
                        host_build_genes=build_n)
    run.end_to_end["sweep_genes_per_s"] = genes_done / elapsed
    run.counters["flops"] = _flops(run, g, kept)


def _flops(run, g, kept) -> float:
    """Model FLOPs of the genes completed as the port's ``utils/flops.py``
    counts them: each gene's real CRE count from its map, the gene windows
    at their cap (every gene window of this genome is full), every window
    at ``max_length`` tokens."""
    t = len(g.tissue_names)
    length = run.cfg["dataset"]["max_length"]
    shapes = [flops.GeneShape(tuple([length] * len(g.cre_maps[gid])),
                              tuple([length] * run.cfg["dataset"]["max_chunks"]), t)
              for _, pred in kept for gid in pred]
    return flops.batch_flops(run.cfg, shapes)["total"]


def traced(run, state: dict, tracer) -> None:
    g = state["g"]
    with tracer.window():
        for k in range(run.cell.traffic["trace_calls"]):
            _call(run, state, _genes(run, g, k), g.vcfs[k % len(g.vcfs)])
    run.counters["trace_calls"] = run.cell.traffic["trace_calls"]


def release(run, state: dict) -> None:
    run.kept["g"] = state["g"]
    state["proc"].cleanup()
    state.clear()


def _gaps(run, prog: list | None, pairs: list) -> dict:
    g = run.kept["g"]
    samples = serving.rebuild(run, g, pairs)
    tissue_ids = list(range(len(g.tissue_names)))
    if prog is None:
        prog = serving.reference(run, samples, tissue_ids, fp8=True)
    return compare.serve_gaps(prog, serving.reference(run, samples, tissue_ids),
                              embeddings=False)


def check(run) -> None:
    answers = [(vcf, gid, p) for vcf, pred in run.kept["answers"] for gid, p in pred.items()]
    pick = serving.sample(run.seed, len(answers), run.cell.traffic["check_sample"], 31)
    run.readings.update(_gaps(run, [(answers[i][2], None) for i in pick],
                              [(answers[i][1], answers[i][0]) for i in pick]))


def control(run) -> dict:
    """The number compared with the reference in float8 in the program's
    place, on the first call's genes of the run's seed."""
    g = run.kept["g"] = serving.genome(run)
    genes = _genes(run, g, 0)[:run.cell.traffic["check_sample"]]
    return _gaps(run, None, [(gid, g.vcfs[0]) for gid in genes])
