"""What the ``query`` and ``sweep`` kinds share: the synthetic genome on
disk, the port's ``VCFProcessor`` on it with the run's weights, and the
reference's rebuild of sampled answers from the same files."""

from __future__ import annotations

import os

import numpy as np
import torch

from vfx_bench import compare
from vfx_bench.genome import Genome
from vfx_bench.harness import program_config
from vfx_bench.reference import host
from vfx_bench.weights import make_weights


def genome(run, donors: int | None = None) -> Genome:
    params = dict(run.cell.traffic["genome"])
    if donors is not None:
        params["donors"] = donors
    return Genome(run.scratch / "genome", params, run.seed, run.cell.traffic["tissues"])


def processor(run, g: Genome):
    """``VCFProcessor`` on the genome's files, the run's weights set (and
    packed) as ``set_params`` does."""
    from variantformer_tpu_torch.api.vcfprocessor import DataSources, VCFProcessor

    cfg = run.cfg
    sources = DataSources(fasta_path=str(g.root / "genome.fa"),
                          gencode_path=str(g.root / "gencode.csv"),
                          tissue_vocab_path=str(g.root / "tissues.yaml"),
                          cre_map_provider=g.cre_maps.get)
    proc = VCFProcessor(config=program_config(cfg), sources=sources, device=run.device,
                        impl=cfg["serve"]["impl"])
    proc.set_params(make_weights(cfg, run.seed, torch.device(run.device),
                                 compare.DTYPES[cfg["serve"]["weights_dtype"]]))
    return proc


def jobs(g: Genome, dataset: dict, pairs: list[tuple[str, str]]) -> list[tuple]:
    """``host.build_job`` arguments of (gene id, VCF path) pairs."""
    import pandas as pd

    gencode = pd.read_csv(g.root / "gencode.csv").set_index("gene_id", drop=False)
    out = []
    for gid, vcf in pairs:
        cre = g.cre_maps[gid]
        rows = list(zip(cre["start_cre"].astype(int).tolist(), cre["end_cre"].astype(int).tolist(),
                        cre["cre_name"].tolist()))
        out.append((str(g.root / "genome.fa"), vcf, gencode.loc[gid].to_dict(), rows, dataset))
    return out


def rebuild(run, g: Genome, pairs: list[tuple[str, str]]) -> list[dict]:
    """The reference's host pipeline over the pairs, on spawned workers."""
    workers = run.cell.traffic.get("build_workers", min(8, os.cpu_count() or 1))
    return host.build_many(jobs(g, run.cfg["dataset"], pairs), workers)


def reference(run, samples: list[dict], tissue_ids, fp8: bool = False) -> list:
    dev = torch.device(run.device)
    params = compare.reference_params(run.cfg, run.seed, dev, run.cfg["serve"]["weights_dtype"])
    return compare.reference_outputs(run.cfg, params, samples, tissue_ids, dev, fp8=fp8)


def sample(seed: int, n: int, k: int, salt: int) -> list[int]:
    """``k`` indices of ``n`` drawn from the seed, without repeats."""
    rng = np.random.default_rng([seed, salt])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
