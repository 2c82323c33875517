"""Multi-process genome-wide vcf2exp launcher: the port of
``scripts/launch_genome_wide.py`` on ``torch.distributed``.

Run one process per card (torchrun sets the rendezvous), or pass
``--coordinator``/``--num-processes``/``--process-id`` (or ``--init-method``)
yourself. Each process brings up the default process group, takes its
round-robin share of the gene list, runs the streaming sweep
(``api/sweeps.genome_wide_expression``) and writes its own parquet shards
and ``stats.json`` under ``OUT/host_{i:03d}/``. There is no cross-process
communication in the sweep unless ``--mesh`` is given: then the genes split
over nodes (``LOCAL_WORLD_SIZE`` consecutive ranks, 1 by default) and each
node's ranks share its forwards through ``VCFProcessor.use_mesh``; the
node's first rank writes its files.

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m variantformer_tpu_torch.scripts.launch_genome_wide \\
        --vcf donor.vcf.gz --tissues "liver,whole blood" --out sweep/
    python -m variantformer_tpu_torch.scripts.launch_genome_wide --synthetic \\
        --device cpu --tissues tissue0 --out sweep/
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--vcf", default=None, help="donor VCF (default: reference genome)")
    ap.add_argument("--tissues", required=True, help="comma-separated tissue names")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--genes", default=None, help="comma-separated subset of gene ids")
    ap.add_argument("--model-class", default="v4_pcg")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0's store")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed rendezvous URL (e.g. file:///shared/store); "
                         "overrides --coordinator")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic example genome + tiny seeded model")
    ap.add_argument("--mesh", action="store_true",
                    help="split genes over nodes of LOCAL_WORLD_SIZE ranks and share each "
                         "node's forwards over its ranks (VCFProcessor.use_mesh); without "
                         "it every rank sweeps its own genes alone")
    ap.add_argument("--partition", default="donor", choices=("donor", "tissue"),
                    help="what the node's ranks split with --mesh: donors (default) or "
                         "tissues and windows (single-donor scale-out)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: cuda:{LOCAL_RANK}), cuda:N or cpu")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on a card, gloo on the "
                         "CPU); several ranks on one card need gloo")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run this process's share; returns its ``stats.json`` contents (every
    rank's, also those that write none)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("launch")

    from variantformer_tpu_torch.api.sweeps import genome_wide_expression
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.examples import _common
    from variantformer_tpu_torch.parallel.launch import (
        initialize_distributed,
        rank_device,
        shard_query_across_hosts,
    )

    topo = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id, device=args.device,
        backend=args.backend, init_method=args.init_method,
    )
    rank, world = topo["process_index"], topo["process_count"]
    device = rank_device()

    if args.synthetic:
        sources, cfg, extras = _common.synthetic_env(Path(args.out) / "_env")
        proc = VCFProcessor(sources=sources, config=cfg, device=device)
        proc.set_params(_common.synthetic_params(cfg, device))
        vcf = args.vcf or extras["vcf"]
        tissues = [t for t in args.tissues.split(",") if t in proc.tissue_vocab] or [
            "tissue0"
        ]
    else:
        sources, cfg = _common.real_sources(args.model_class)
        proc = VCFProcessor(model_class=args.model_class, sources=sources, config=cfg,
                            device=device)
        proc.load_model()
        vcf = args.vcf
        tissues = args.tissues.split(",")

    part, parts, writer = rank, world, True
    if args.mesh:
        from variantformer_tpu_torch.parallel.mesh import make_node_mesh

        node_size = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        proc.use_mesh(make_node_mesh(node_size), partition=args.partition)
        part, parts, writer = rank // node_size, world // node_size, rank % node_size == 0

    gencode = proc.get_genes()
    genes = (
        args.genes.split(",")
        if args.genes
        else [g for g, c in zip(gencode["gene_id"], gencode["chromosome"])
              if c not in ("chrX", "chrY", "chrM")]
    )
    my_genes = shard_query_across_hosts(genes, part, parts)
    log.info("host %d/%d (rank %d/%d): %d of %d genes", part, parts, rank, world,
             len(my_genes), len(genes))

    out_dir = Path(args.out) / f"host_{part:03d}"
    t0 = time.time()
    genome_wide_expression(
        proc, vcf, tissues, genes=my_genes,
        batch_size=args.batch_size, out_dir=str(out_dir) if writer else None,
    )
    dt = time.time() - t0
    stats = {
        "host": part,
        "genes": len(my_genes),
        "seconds": round(dt, 2),
        "genes_per_sec": round(len(my_genes) / dt, 4) if dt else None,
    }
    if writer:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "stats.json").write_text(json.dumps(stats))
    log.info("done: %s", stats)
    proc.cleanup()
    return stats


if __name__ == "__main__":
    from variantformer_tpu_torch.parallel.launch import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
