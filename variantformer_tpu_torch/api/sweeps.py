"""Large-scale sweep drivers: genome-wide expression and in-silico saturation
mutagenesis.

The port of ``variantformer_tpu/api/sweeps.py``. Both sweeps run on the
processor's device (the card unless the processor was made with
``device="cpu"``):

  * genome_wide_expression: all (requested) genes for one donor; host sample
    builds run on a pool of worker threads ahead of the device, and batch
    i+1 is launched before batch i's results are copied back, as in the
    JAX package; results are returned as one frame or streamed to parquet
    shards,
  * saturation_scan: every SNV over a locus scored against a gene — the
    reference sample is built once and shared; per-variant het/hom samples
    run together on the device. The native BPE releases the GIL, so host
    re-tokenization parallelizes across threads.

Every dispatch of a sweep has one donor count (``batch_size``, or
2 x ``variants_per_batch`` for the scan): a partial group is padded by
repeating its last sample and the pad rows are dropped from the outputs.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd

from variantformer_tpu_torch.data.pipeline import pack_samples
from variantformer_tpu_torch.data.vep import Variant
from variantformer_tpu_torch.utils.profiling import StageTimer
from variantformer_tpu_torch.utils.readahead import warm_page_cache

log = logging.getLogger(__name__)

BUILD_WORKERS = 4  # host sample-build threads of a sweep


def _bounded_map(pool, fn, items, limit: int, timer: StageTimer | None = None):
    """Yield fn(item) in order with at most ``limit`` builds in flight.

    Executor.map would submit every item up front, letting workers race
    arbitrarily far ahead of the device and pinning the whole work list's
    samples in host memory; this keeps a fixed window of futures instead.
    With a ``timer``, the waits for each next result are its stage
    ``wait_build``."""
    pending: deque = deque()
    it = iter(items)

    def top_up():
        while len(pending) < limit:
            item = next(it, None)
            if item is None:
                return
            pending.append(pool.submit(fn, item))

    top_up()
    while pending:
        with timer.stage("wait_build") if timer else contextlib.nullcontext():
            result = pending.popleft().result()
        top_up()
        yield result


def _pad_group(samples: list, target: int) -> list:
    """Pad a dispatch group to its canonical donor count by repeating the
    last sample, so every dispatch of a sweep has one batch shape. Callers
    drop the pad rows from the outputs; the wasted work is at most one group
    per sweep."""
    assert samples, "_pad_group requires a non-empty group"
    return samples + [samples[-1]] * (target - len(samples))


def genome_wide_expression(
    processor,
    vcf_path: str | None,
    tissues: list[str],
    genes: list[str] | None = None,
    batch_size: int = 4,
    out_dir: str | None = None,
    shard_rows: int = 512,
    prefetch: int = 8,
    stats: dict | None = None,
) -> pd.DataFrame | None:
    """Predict expression for every gene (or ``genes``) x ``tissues`` for one
    donor through ``processor`` (a ``VCFProcessor``). With ``out_dir`` set,
    streams parquet shards and returns None; otherwise returns the full
    dataframe (gene_id, tissue, predicted_expression).

    Pass a dict as ``stats`` to receive the per-stage wall-clock breakdown
    (``stages``: StageTimer totals; host_build runs in worker threads,
    wait_build/pack/dispatch/device_sync on the main thread) and the
    sweep's wall seconds (``wall_s``). Under a profiler each stage is the
    span ``sweep.<stage>``; the card's own busy time is in its trace
    (``utils/profiling.device_trace``)."""
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    # Warm the random-read files in the background while the sweep starts.
    warm_page_cache([processor.sources.fasta_path, vcf_path])

    gencode = processor.get_genes()
    if genes is None:
        genes = [
            g for g, c in zip(gencode["gene_id"], gencode["chromosome"])
            if str(c).startswith("chr") and c not in ("chrX", "chrY", "chrM")
        ]
    tissue_ids = [processor.tissue_vocab[t] for t in tissues]
    builder = GeneSampleBuilder(
        cfg=processor.config.dataset,
        fasta=FastaReader(processor.sources.fasta_path),
        tokenizer=processor.tokenizer,
        gencode=gencode,
        cre_map_provider=(
            processor.sources.cre_map_provider
            or processor.sources.default_cre_map_provider()
        ),
        vcf=VCFReader(vcf_path) if vcf_path else None,
    )
    timer = StageTimer("sweep")
    wall_t0 = time.perf_counter()

    def build(gene_id):
        try:
            with timer.stage("host_build"):
                return builder.build(gene_id)
        except (ValueError, KeyError) as exc:
            log.warning("skipping %s: %s", gene_id, exc)
            return None

    rows: list[dict] = []
    shards = 0
    out_path = Path(out_dir) if out_dir else None
    if out_path:
        out_path.mkdir(parents=True, exist_ok=True)

    def flush(force=False):
        nonlocal rows, shards
        if out_path and (force or len(rows) >= shard_rows) and rows:
            pd.DataFrame(rows).to_parquet(out_path / f"shard_{shards:05d}.parquet")
            shards += 1
            rows = []

    def drain(samples, out):
        with timer.stage("device_sync"):
            preds = out.pred_expression.cpu().numpy()  # waits for the device
        for i, sample in enumerate(samples):
            for j, name in enumerate(tissues):
                rows.append(
                    {
                        "gene_id": sample.gene_id,
                        "tissue": name,
                        "predicted_expression": float(preds[i, j]),
                    }
                )
        flush()

    # Workers build genes (one future per gene, so the pipeline fills after
    # one build, not one whole batch); the main thread groups consecutive
    # successful samples into full device batches — build failures never
    # shrink a dispatch group — packs, and launches batch i+1 before copying
    # batch i's results back. On the port no two batches overlap on the
    # card: batch i+1's copy to the card waits for batch i's kernels, and
    # batch i's copy back waits for batch i+1's. The inference ops replay
    # CUDA graphs (ops/graphs.py), so launching a batch is a few replays and
    # the forward's plain ops: the card runs each batch while the main thread
    # waits in the next drain, with the interpreter lock left to the build
    # threads, and idles while the main thread packs, copies and launches.
    in_flight = None

    def dispatch(samples):
        nonlocal in_flight
        with timer.stage("pack"):
            batch = pack_samples(_pad_group(samples, batch_size), tissue_ids)
        with timer.stage("dispatch"):
            out = processor._forward(batch)
        if in_flight is not None:
            drain(*in_flight)
        in_flight = (samples, out)

    limit = max(prefetch, 1) * batch_size  # bounded build-ahead (memory cap)
    with ThreadPoolExecutor(max_workers=BUILD_WORKERS) as pool:
        group: list = []
        for sample in _bounded_map(pool, build, genes, limit, timer):
            if sample is None:
                continue
            group.append(sample)
            if len(group) == batch_size:
                dispatch(group)
                group = []
        if group:
            dispatch(group)
        if in_flight is not None:
            drain(*in_flight)
    timer.log_summary("genome-wide")
    if stats is not None:
        stats.update(stages=timer.summary(),
                     wall_s=round(time.perf_counter() - wall_t0, 3))
    if out_path:
        flush(force=True)
        return None
    return pd.DataFrame(rows)


def saturation_scan(
    variant_processor,
    chrom: str,
    start: int,
    end: int,
    gene_id: str,
    tissues: list[str],
    alts: str = "ACGT",
    variants_per_batch: int = 8,
    vcf_path: str | None = None,
    prefetch: int = 8,
) -> pd.DataFrame:
    """Score every SNV in 1-based [start, end] against ``gene_id`` through
    ``variant_processor`` (a ``VariantProcessor``).

    Returns per (pos, alt, tissue, zygosity) expression plus log2fc vs the
    shared reference prediction. Variants that overlap neither a CRE nor the
    gene window of ``gene_id`` are skipped. Under a profiler each stage of
    the scan is the span ``scan.<stage>``."""
    vp = variant_processor
    gencode = vp._vp.get_genes()
    info_row = gencode[gencode["gene_id"] == gene_id].iloc[0]
    gene_info = {
        "gene_id": gene_id,
        "start": int(info_row["start"]),
        "end": int(info_row["end"]),
        "gene_name": info_row.get("gene_name", ""),
        "strand": info_row["strand"],
        "chromosome": info_row["chromosome"],
    }
    tissue_ids = [vp.tissue_vocab[t] for t in tissues]
    builder = vp._vep_builder(vcf_path)
    fasta = builder.b.engine.fasta
    warm_page_cache([fasta.path, vcf_path])
    timer = StageTimer("scan")

    # Reference prediction once, shared by the whole scan.
    with timer.stage("ref_build"):
        cre_df = builder._cre_sequences(gene_id, gene_info)
        gene_seq = builder._gene_sequence(gene_info)
        ref_sample = builder._tokenize(cre_df, gene_seq, gene_id)
    with timer.stage("device"):
        # Padded to the scan batches' donor count: one batch shape a scan.
        ref_out = vp._vp._forward(
            pack_samples(_pad_group([ref_sample], 2 * variants_per_batch), tissue_ids)
        )
        ref_pred = ref_out.pred_expression[0].cpu().numpy()  # [T]

    # Enumerate SNVs with their reference base.
    jobs = []
    for pos in range(start, end + 1):
        base = fasta.fetch(chrom, pos - 1, pos).upper()
        if base not in "ACGT":
            continue
        for alt in alts:
            if alt != base:
                jobs.append((pos, base, alt))

    def build_variant(job):
        pos, ref, alt = job
        with timer.stage("host_build"):
            sample = builder.build(
                Variant(chrom=chrom, pos=pos, ref=ref, alt=alt, tissue=tissue_ids),
                gene_info,
            )
        return job, sample

    rows: list[dict] = []
    limit = max(prefetch, 1) * variants_per_batch  # bounded build-ahead
    with ThreadPoolExecutor(max_workers=BUILD_WORKERS) as pool:
        batch_items = []
        for job, sample in _bounded_map(pool, build_variant, jobs, limit, timer):
            if not sample.samples:
                continue
            # het (index 1) and hom (index 2) share the scan's ref
            batch_items.append((job, sample))
            if len(batch_items) >= variants_per_batch:
                _score_scan_batch(
                    vp, batch_items, tissue_ids, tissues, ref_pred, rows,
                    timer, variants_per_batch,
                )
                batch_items = []
        if batch_items:
            _score_scan_batch(
                vp, batch_items, tissue_ids, tissues, ref_pred, rows,
                timer, variants_per_batch,
            )
    timer.log_summary("saturation-scan")
    return pd.DataFrame(rows)


def _score_scan_batch(
    vp, items, tissue_ids, tissue_names, ref_pred, rows, timer, batch_target
):
    samples = []
    for _, vep_sample in items:
        samples.extend(vep_sample.samples[1:])  # het, hom
    with timer.stage("pack"):
        batch = pack_samples(_pad_group(samples, 2 * batch_target), tissue_ids)
    with timer.stage("device"):
        out = vp._vp._forward(batch)
        preds = out.pred_expression.cpu().numpy()  # [2K, T]
    eps = 1e-10
    for i, ((pos, ref, alt), vep_sample) in enumerate(items):
        for zyg, row_i in (("1", 2 * i), ("2", 2 * i + 1)):
            for j, name in enumerate(tissue_names):
                value = float(preds[row_i, j])
                rows.append(
                    {
                        "pos": pos, "ref": ref, "alt": alt, "tissue": name,
                        "zygosity": zyg, "variant_type": vep_sample.variant_type,
                        "expression": value,
                        "ref_expression": float(ref_pred[j]),
                        "log2fc": float(
                            np.log2((value + eps) / (ref_pred[j] + eps))
                        ),
                    }
                )
