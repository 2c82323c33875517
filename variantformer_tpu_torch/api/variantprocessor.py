"""VariantProcessor: the variant2exp / VEP / eQTL public API of the port.

The port of ``variantformer_tpu/api/variantprocessor.py``. Variants x
probable genes are scored as ref/het/hom triples per population, compiled to
the long dataframe schema (chrom/pos/.../zygosity/gene_exp/gene_emb/
gene_token_embedding/cre_token_embedding), pivoted to ``{POP}-{zygosity}-exp``
columns, and reduced to log2fc (or Poisson) + AF-weighted eQTL scores. The
six-population mode reads precomputed sequences from the artifacts; the
VCF-backed SAMPLE + REF_HG38 mode runs on local files, REF_HG38 falling back
to the local reference consensus when the artifacts are absent.

It runs on the card unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises. Each dispatch is one batch of ref/het/hom
rows through ``seq2gene_forward`` with window-dedup pools; the host sample
builds run on worker threads over the C++ engines.

Environment settings (those of the JAX package): ``VFX_VEP_BATCH``
(variants a dispatch), ``VFX_VEP_CANONICAL_C`` (CRE-axis floor),
``VFX_VEP_DEDUP=0`` (no window-dedup pools), ``VFX_VEP_REF_ONCE=0`` (no
ref-once cache), ``VFX_VEP_REF_CACHE`` (its entries), and
``VFX_VEP_BUILD_WORKERS`` (host build threads).

``use_mesh`` spreads the dispatches over a ``parallel/mesh.Mesh`` (see
``VCFProcessor.use_mesh``); the ref-once cache is off under a mesh.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from variantformer_tpu_torch.api.sweeps import _bounded_map
from variantformer_tpu_torch.api.vcfprocessor import DataSources, VCFProcessor
from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
from variantformer_tpu_torch.data.vep import Variant, VepSampleBuilder, get_probable_genes
from variantformer_tpu_torch.models.seq2gene import Seq2GeneOutput
from variantformer_tpu_torch.utils import assets
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.intervals import GeneIntervalIndex
from variantformer_tpu_torch.utils.scoring import (
    generate_log2fc_score,
    generate_poisson_score,
)
from variantformer_tpu_torch.utils.vcf import VCFReader

log = logging.getLogger(__name__)

POPULATIONS = ("REF_HG38", "EAS", "EUR", "AFR", "SAS", "AMR")
STREAMS = ("gene_stream", "cre_stream")


class VariantProcessor:
    def __init__(
        self,
        model_class: str = "v4_pcg",
        sources: DataSources | None = None,
        config=None,
        config_path: str | None = None,
        device: str | torch.device = "cuda",
        impl: str = "fused2",
    ):
        # VCFProcessor holds the config, vocabularies, parameters and device.
        self._vp = VCFProcessor(model_class=model_class, sources=sources, config=config,
                                config_path=config_path, device=device, impl=impl)
        self.sources = self._vp.sources
        self.tissue_vocab = self._vp.tissue_vocab
        self.tissue_idx_to_name = {v: k for k, v in self.tissue_vocab.items()}
        self.gene_variant_pairs: list[dict] = []
        # Ref-once cache: the REF sample is the same for every variant on a
        # (gene, population), so its expression, embedding and final streams
        # are cached from one triple dispatch, and later variants run as
        # het/hom PAIRS (a third less device work); the ref token embeddings
        # are gathered on the host from the cached streams at each variant's
        # positions. Streams are cached as CPU tensors in the compute dtype
        # (~35 MB a gene at full geometry in bf16); predict sorts pairs by
        # (gene, population), so one live entry usually suffices.
        self._ref_cache: OrderedDict[tuple, dict | None] = OrderedDict()
        self._ref_cache_max = int(os.environ.get("VFX_VEP_REF_CACHE", "8"))
        # Entries with buffered het/hom pairs outstanding are pinned (never
        # evicted), so a grouped flush cannot miss its ref.
        self._ref_pins: dict[tuple, int] = {}
        self.vep_stats: dict[str, float] = {}
        self._stats_lock = threading.Lock()

    @property
    def config(self):
        return self._vp.config

    @property
    def device(self) -> torch.device:
        return self._vp.device

    def load_model(self, **kw):
        return self._vp.load_model(**kw)

    def set_params(self, params, config=None):
        self._vp.set_params(params, config)

    def cleanup(self):
        """Release the parameters (and the card's cached blocks)."""
        self._vp.cleanup()

    def use_mesh(self, mesh=None, partition: str = "donor"):
        """Spread the dispatches over a mesh (see ``VCFProcessor.use_mesh``).
        VEP batches are ref/het/hom triples (D=3), so ``partition="tissue"``
        fits meshes wider than 3 donors."""
        self._vp.use_mesh(mesh, partition=partition)

    def _stat(self, key: str, value: float) -> None:
        with self._stats_lock:  # the host builds report from worker threads
            self.vep_stats[key] = self.vep_stats.get(key, 0) + value

    # -- variant loading ----------------------------------------------------
    def load_variants(self, var_df: pd.DataFrame) -> list[Variant]:
        df = var_df.rename(columns={"chr": "chrom"})
        for col in ("chrom", "pos", "ref", "alt", "tissue"):
            if col not in df.columns:
                raise ValueError(f"Column {col} missing from variant dataframe")
        df = df.sort_values(["chrom", "pos"]).reset_index(drop=True)
        variants = []
        for _, row in df.iterrows():
            tissues = [self.tissue_vocab[t] for t in str(row["tissue"]).split(",")]
            genes = (
                [g.split(".")[0] for g in str(row["gene_id"]).split(",")]
                if "gene_id" in row and pd.notna(row.get("gene_id"))
                else []
            )
            variants.append(Variant(
                chrom=str(row["chrom"]), pos=int(row["pos"]),
                ref=str(row["ref"]), alt=str(row["alt"]),
                tissue=tissues, gene_id=genes,
                consequence=row.get("consequence", "NA"),
                label=row.get("label", "NA"),
            ))
        return variants

    def _pairs(self, variants, vcf_path, sample_name):
        gencode = self._vp.get_genes()
        index = GeneIntervalIndex(gencode)  # built once, O(log n) per variant
        pairs = []
        mapped = 0
        for variant in variants:
            probable = get_probable_genes(gencode, variant, index=index)
            if variant.gene_id:
                probable = [g for g in probable
                            if g["gene_id"].split(".")[0] in variant.gene_id]
            if probable:
                mapped += 1
            for gene in probable:
                if vcf_path is not None and sample_name is not None:
                    pairs.append(dict(variant=variant, gene=gene, population="SAMPLE",
                                      sample_name=sample_name, vcf_path=vcf_path))
                    pairs.append(dict(variant=variant, gene=gene, population="REF_HG38",
                                      sample_name="hg38", vcf_path=None))
                else:
                    for pop in POPULATIONS:
                        pairs.append(dict(variant=variant, gene=gene, population=pop,
                                          sample_name=pop, vcf_path=None))
        if mapped == 0:
            raise ValueError("No gene-variant pairs found")
        log.info("Mapped %d variants to genes (%d pairs)", mapped, len(pairs))
        return pairs

    # -- prediction ---------------------------------------------------------
    def _vep_builder(self, vcf_path: str | None) -> VepSampleBuilder:
        base = GeneSampleBuilder(
            cfg=self.config.dataset,
            fasta=FastaReader(self.sources.fasta_path),
            tokenizer=self._vp.tokenizer,
            gencode=self._vp.get_genes(),
            cre_map_provider=(
                self.sources.cre_map_provider or self.sources.default_cre_map_provider()
            ),
            vcf=VCFReader(vcf_path) if vcf_path else None,
            snps_only=True,
        )
        return VepSampleBuilder(base)

    def _forward_triples(
        self, vep_samples: list, tissues: list[int], pad_to: int | None = None,
        cre_pad_to: int | None = None, zygs: tuple = (0, 1, 2),
        return_streams: bool = False, defer: bool = False,
    ):
        """Run k ref/het/hom triples (or het/hom PAIRS, ``zygs=(1, 2)``: the
        ref-once cache path) through the model in ONE dispatch
        (D = len(zygs) * k) and split the outputs back per item. All items
        of a group share the tissue list and position presence (the caller
        groups; presence is judged across all three zygosities whatever
        ``zygs`` is).

        ``pad_to`` pads a partial trailing group to the canonical k by
        repeating the last item (the pad outputs are dropped), so that a
        sweep keeps one batch shape.

        ``return_streams`` also returns each item's REF row of the final
        streams (gene [1, T, G+1, E], CRE [1, C, E]) as CPU tensors in the
        compute dtype: only the ref-once cache reads them.

        ``defer=True`` returns a zero-argument ``finish()`` instead of the
        outputs: the kernels are launched, and the copy to the host (which
        waits for the card) happens when ``finish()`` runs, so the caller
        can pack and launch the next group while the card works on this
        one."""
        t_pack0 = time.perf_counter()
        n_real = len(vep_samples)
        z = len(zygs)
        if pad_to is not None and n_real < pad_to:
            vep_samples = vep_samples + [vep_samples[-1]] * (pad_to - n_real)
        flat = [vs.samples[zi] for vs in vep_samples for zi in zygs]
        batch = pack_samples(flat, tissues, cre_pad_to=cre_pad_to)
        first = vep_samples[0]
        ctp = None
        if not np.isnan(first.cre_token_position):
            ctp = np.asarray(
                [int(vs.cre_token_position) for vs in vep_samples for _ in zygs], np.int32)
        gtp = None
        if not any(np.isnan(g) for g in first.gene_token_positions):
            gtp = np.asarray(
                [int(vs.gene_token_positions[zi]) for vs in vep_samples for zi in zygs],
                np.int32)
        batch = batch._replace(cre_token_position=ctp, gene_token_position=gtp)
        batch = self._dedup_windows(batch)
        # The embeddings cross to the host as bf16 (lossless at the bf16
        # compute dtype), one copy per leaf, then numpy slicing per item.
        t_disp0 = time.perf_counter()
        out = self._vp._forward(batch, return_streams=return_streams, narrow_embeddings=True)
        t_disp1 = time.perf_counter()
        # Only the copy to the host proves the card finished, so fetch_s is
        # the card's tail plus the copy.
        self._stat("pack_s", t_disp0 - t_pack0)
        self._stat("dispatch_s", t_disp1 - t_disp0)
        self._stat("dispatches", 1)

        def finish() -> list:
            t_fetch0 = time.perf_counter()
            host = self._to_host(out, z)
            self._stat("fetch_s", time.perf_counter() - t_fetch0)
            return [
                Seq2GeneOutput(**{
                    name: None if leaf is None
                    else leaf[i:i + 1] if name in STREAMS
                    else leaf[z * i:z * i + z]
                    for name, leaf in host.items()
                })
                for i in range(n_real)
            ]

        return finish if defer else finish()

    @staticmethod
    def _to_host(out: Seq2GeneOutput, z: int) -> dict:
        """The dispatch's outputs on the host: numpy f32, and each item's
        REF row of the streams (every z-th) as CPU tensors in the compute
        dtype."""
        return {
            name: None if leaf is None
            else leaf[::z].cpu() if name in STREAMS
            else leaf.cpu().float().numpy()
            for name, leaf in out._asdict().items()
        }

    @staticmethod
    def _dedup_windows(batch, slack: int = 64):
        """Attach window-dedup pools to a VEP batch (VFX_VEP_DEDUP=0 to
        disable). The donors of a dispatch (ref/het/hom of one variant, or k
        batched variants on the same gene) share all but the edited
        windows, and window encoding is strictly per-window, so encoding
        each unique (tok_len, tokens) row once and gathering per donor is
        EXACT. Pool axes are padded to canonical caps (window slots +
        ``slack``) so every dispatch of a group shares one shape; a pool
        overflowing its cap falls back to the plain layout."""
        if os.environ.get("VFX_VEP_DEDUP", "1") == "0":
            return batch

        def pool(tokens, lens, cap):
            d, n, length = tokens.shape
            keyed = np.concatenate(
                [np.asarray(lens).reshape(d * n, 1), np.asarray(tokens).reshape(d * n, length)],
                axis=1,
            )
            uniq, inv = np.unique(keyed, axis=0, return_inverse=True)
            if len(uniq) > cap:
                return None
            pt = np.zeros((cap, length), np.int32)
            pl = np.zeros((cap,), np.int32)
            pt[: len(uniq)] = uniq[:, 1:]
            pl[: len(uniq)] = uniq[:, 0]
            return pt, pl, inv.reshape(d, n).astype(np.int32)

        cp = pool(batch.cre_tokens, batch.cre_tok_len, batch.cre_tokens.shape[1] + slack)
        gp = pool(batch.gene_tokens, batch.gene_tok_len, batch.gene_tokens.shape[1] + slack)
        if cp is None or gp is None:
            return batch
        return batch._replace(
            cre_pool_tokens=cp[0], cre_pool_len=cp[1], cre_gather=cp[2],
            gene_pool_tokens=gp[0], gene_pool_len=gp[1], gene_gather=gp[2],
        )

    def _output_path(self, output_dir: str, chunks: int, chunk_id: int) -> str:
        name = f"vep_chunk{chunk_id}_VF.parquet" if chunks > 1 else "vep_VF.parquet"
        return os.path.join(output_dir, name)

    def predict(
        self,
        var_df: pd.DataFrame,
        output_dir: str,
        vcf_path: str | None = None,
        sample_name: str | None = None,
        chunks: int = 1,
        chunk_id: int = 0,
        variants_per_dispatch: int | None = None,
        canonical_cres: int | None = None,
    ) -> pd.DataFrame:
        """Score every (variant, probable gene, population) as ref/het/hom
        and return the long frame (also written as parquet when the writer
        is available).

        chunks/chunk_id partition the variant list for resumable sweeps: a
        chunk whose output file already exists raises instead of
        recomputing.

        variants_per_dispatch batches k ref/het/hom triples (D = 3k) per
        dispatch (default 1; env ``VFX_VEP_BATCH``). canonical_cres sets a
        FLOOR on the CRE-window axis so variants at loci with different CRE
        counts share one batch shape (env ``VFX_VEP_CANONICAL_C``)."""
        if self._vp._params is None:
            raise RuntimeError("call load_model() or set_params() first")
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        out_file = self._output_path(output_dir, chunks, chunk_id)
        if os.path.exists(out_file):
            raise ValueError(
                f"Variants already processed at {out_file}. To reprocess, "
                "change the output directory or remove the existing file."
            )
        variants = self.load_variants(var_df)
        if chunks > 1:
            variants = variants[chunk_id::chunks]
            if not variants:
                raise ValueError(f"chunk {chunk_id}/{chunks} is empty")
        self.gene_variant_pairs = self._pairs(variants, vcf_path, sample_name)
        # Pair scheduling: group by (gene, population) so the ref-once cache
        # sees every variant of a (gene, population) back to back: one ref
        # triple per group, everything else het/hom pairs. The stable sort
        # keeps coordinate order within a group; compile_predictions zips
        # this list.
        self.gene_variant_pairs.sort(
            key=lambda p: (p["gene"]["gene_id"], p["population"], p["sample_name"])
        )
        self.vep_stats = {}

        if variants_per_dispatch is None:
            variants_per_dispatch = int(os.environ.get("VFX_VEP_BATCH", "1"))
        if canonical_cres is None:
            env_c = os.environ.get("VFX_VEP_CANONICAL_C")
            canonical_cres = int(env_c) if env_c else None
        k = max(1, variants_per_dispatch)
        bucket_step, gene_cap = 64, self.config.dataset.max_chunks
        predictions: list[dict | None] = [None] * len(self.gene_variant_pairs)

        # Build -> grouped dispatch: triples buffer per group key (same
        # tissue list, position presence and bucketed shape) and flush every
        # k, so peak memory is O(k x live groups).
        buffers: dict[tuple, list[tuple[int, object, tuple]]] = {}
        filled: set[tuple] = set()  # keys that reached k at least once
        pad_stats = {"real": 0, "padded": 0}
        # One-deep dispatch pipeline: a flushed group's copy to the host is
        # deferred until the NEXT group has been launched.
        pending: list = [None]

        def complete(entry) -> None:
            fin, idxs_samples, mode = entry
            for (i, sample, ckey), out in zip(idxs_samples, fin()):
                if mode == "ref":
                    self._cache_ref(ckey, out)  # fills the placeholder
                    self._unpin(ckey)  # the dispatch-time placeholder pin
                elif mode == "pair":
                    out = self._merge_ref(out, sample, ckey, len(ckey[4]))
                    self._unpin(ckey)
                out = out._replace(gene_stream=None, cre_stream=None)
                predictions[i] = dict(variant_type=sample.variant_type, out=out)

        def ref_dispatch(pair_index, sample, ckey, tissues, c_key) -> None:
            """Deferred ref triple: launch now, fetch when the next group
            launches. A placeholder entry (pinned, so never evicted) makes
            the ref visible to _consume_builds' classification; the one-deep
            pipeline completes groups in launch order, so the placeholder
            is filled before any pair group that merges against it."""
            self._ref_cache[ckey] = None  # placeholder
            self._ref_cache.move_to_end(ckey)
            self._ref_pins[ckey] = self._ref_pins.get(ckey, 0) + 1
            fin = self._forward_triples([sample], list(tissues), cre_pad_to=c_key,
                                        return_streams=True, defer=True)
            prev, pending[0] = pending[0], (fin, [(pair_index, sample, ckey)], "ref")
            if prev is not None:
                complete(prev)

        def flush(key: tuple, pad: bool = True) -> None:
            idxs_samples = buffers.pop(key, [])
            if not idxs_samples:
                return
            pair_mode = key[-1] == "pair"
            if pair_mode:
                # Pins make an eviction before the flush impossible; guard
                # anyway: a pair whose ref entry is gone runs as a triple.
                missing = [t for t in idxs_samples if t[2] not in self._ref_cache]
                if missing:
                    self._stat("ref_fallbacks", len(missing))
                    idxs_samples = [t for t in idxs_samples if t[2] in self._ref_cache]
                    for i, sample, ckey in missing:
                        self._unpin(ckey)
                        out = self._forward_triples([sample], list(key[0]), cre_pad_to=key[3])[0]
                        predictions[i] = dict(variant_type=sample.variant_type, out=out)
                    if not idxs_samples:
                        return
            # Padding trades wasted work for one batch shape; a key that
            # never filled a group dispatches at its natural size.
            pad_to = k if pad else None
            fin = self._forward_triples(
                [s for _, s, _ in idxs_samples], list(key[0]), pad_to=pad_to,
                cre_pad_to=key[3], zygs=(1, 2) if pair_mode else (0, 1, 2), defer=True,
            )
            pad_stats["real"] += len(idxs_samples)
            if pad_to is not None:
                pad_stats["padded"] += pad_to - len(idxs_samples)
            prev, pending[0] = pending[0], (fin, idxs_samples, "pair" if pair_mode else "plain")
            if prev is not None:
                complete(prev)

        builders: dict[str | None, VepSampleBuilder] = {}
        manifests = None
        for pair in self.gene_variant_pairs:
            pvcf = pair["vcf_path"]
            if pvcf not in builders:
                builders[pvcf] = self._vep_builder(pvcf)
            if pvcf is None and manifests is None:
                manifests = (assets.cre_sequences_manifest(), assets.gene_sequences_manifest())

        def build_pair(indexed):
            """Host sample build of one (variant, gene, population) pair, on a
            worker thread (the C++ consensus and tokenizer release the GIL),
            overlapped with the main thread's dispatches."""
            t0 = time.perf_counter()
            pair_index, pair = indexed
            pvcf = pair["vcf_path"]
            # Precomputed per-population sequences apply whenever no sample
            # VCF backs the pair; hg38 pairs fall back to the local reference
            # consensus when the artifacts are absent.
            precomputed = None if pvcf is not None else (pair["population"], *manifests)
            try:
                sample = builders[pvcf].build(
                    pair["variant"], pair["gene"],
                    validate_ref=(pair["sample_name"] == "hg38"), precomputed=precomputed,
                )
            except Exception as exc:  # artifacts absent (manifest, fetch, files)
                if precomputed is None or pair["sample_name"] != "hg38":
                    raise
                log.debug("precomputed hg38 sequences unavailable (%s); local consensus", exc)
                self._stat("precomputed_fallbacks", 1)
                sample = builders[pvcf].build(pair["variant"], pair["gene"], validate_ref=True)
            # summed worker-thread time (can exceed the elapsed time)
            self._stat("build_s", time.perf_counter() - t0)
            return pair_index, pair, sample

        workers = int(os.environ.get("VFX_VEP_BUILD_WORKERS", "4"))
        pool = ThreadPoolExecutor(max_workers=workers)
        try:
            built = _bounded_map(pool, build_pair, enumerate(self.gene_variant_pairs),
                                 limit=workers * 2 * k)
            self._consume_builds(built, predictions, buffers, filled, flush, k,
                                 bucket_step, gene_cap, canonical_cres, ref_dispatch)
            for key in list(buffers):
                flush(key, pad=key in filled)
            if pending[0] is not None:  # drain the one-deep pipeline
                complete(pending[0])
                pending[0] = None
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            # After an exception, placeholders that were never filled and
            # the pins of this call would outlive it: a later predict would
            # classify its variants as pairs against a ref that is not there.
            for ckey in [c for c, entry in self._ref_cache.items() if entry is None]:
                del self._ref_cache[ckey]
            self._ref_pins.clear()
        total = pad_stats["real"] + pad_stats["padded"]
        if pad_stats["padded"]:
            log.info("VEP dispatch padding: %d/%d padded triples across %d group keys",
                     pad_stats["padded"], total, len(filled) or 1)
        hits = self.vep_stats.get("ref_hits", 0)
        misses = self.vep_stats.get("ref_misses", 0)
        if hits + misses:
            log.info("VEP ref-once cache: %d hits / %d misses, %d evictions, "
                     "%d triple fallbacks", hits, misses,
                     self.vep_stats.get("ref_evictions", 0),
                     self.vep_stats.get("ref_fallbacks", 0))
        return self.compile_predictions(predictions, output_dir, vcf_path=vcf_path,
                                        out_file=out_file)

    def _consume_builds(
        self, built, predictions, buffers, filled, flush, k, bucket_step,
        gene_cap, canonical_cres, ref_dispatch=None,
    ):
        """Group worker-built samples by batch-shape key and flush every k
        (see ``predict``). Runs on the main thread, in submission order.

        With the ref-once cache on (default; VFX_VEP_REF_ONCE=0 turns it
        off, and it is off under a mesh), the FIRST variant of each (gene, population) dispatches as a
        full triple that also returns the ref's final streams, and every
        later variant as a het/hom pair; the ref row is rebuilt from the
        cache exactly (the model's per-donor computation is
        donor-independent)."""
        ref_once = os.environ.get("VFX_VEP_REF_ONCE", "1") != "0" and self._vp._mesh is None
        for pair_index, pair, sample in built:
            if not sample.samples:
                predictions[pair_index] = dict(variant_type=sample.variant_type, out=None)
                continue
            c = max(s.cre_tokens.shape[0] for s in sample.samples)
            g = max(s.gene_tokens.shape[0] for s in sample.samples)
            c_key = -(-c // bucket_step) * bucket_step
            if canonical_cres:
                c_key = max(canonical_cres, c_key)
            tissues = tuple(pair["variant"].tissue)
            base = (
                tissues,
                bool(np.isnan(sample.cre_token_position)),
                any(np.isnan(gp) for gp in sample.gene_token_positions),
                c_key,
                gene_cap if g == gene_cap else -(-g // bucket_step) * bucket_step,
            )
            ckey = (pair["population"], pair["sample_name"], pair["vcf_path"],
                    pair["gene"]["gene_id"], tissues)
            if ref_once and ckey not in self._ref_cache:
                self._stat("ref_misses", 1)
                if ref_dispatch is not None:  # pipelined (deferred fetch)
                    ref_dispatch(pair_index, sample, ckey, tissues, c_key)
                    continue
                out = self._forward_triples([sample], list(tissues), cre_pad_to=c_key,
                                            return_streams=True)[0]
                self._cache_ref(ckey, out)
                predictions[pair_index] = dict(
                    variant_type=sample.variant_type,
                    out=out._replace(gene_stream=None, cre_stream=None),
                )
                continue
            key = base + (("pair",) if ref_once else ("triple",))
            if ref_once:
                self._stat("ref_hits", 1)
                self._ref_pins[ckey] = self._ref_pins.get(ckey, 0) + 1
            buffers.setdefault(key, []).append((pair_index, sample, ckey))
            if len(buffers[key]) >= k:
                filled.add(key)
                flush(key)

    def _cache_ref(self, ckey: tuple, out) -> None:
        self._ref_cache[ckey] = dict(
            exp=out.pred_expression[0],          # [T] f32
            emb=out.pooled_embedding[0],         # [T, E] f32
            gene_stream=out.gene_stream[0],      # [T, G1, E] CPU tensor, compute dtype
            cre_stream=out.cre_stream[0],        # [C, E]
        )
        self._ref_cache.move_to_end(ckey)
        # Evict the oldest UNPINNED entries; pinned ones have buffered
        # het/hom pairs whose flush still needs them, and the entry just
        # inserted is never the victim. The cache may exceed the cap for a
        # while when everything else is pinned.
        while len(self._ref_cache) > self._ref_cache_max:
            victim = next((c for c in list(self._ref_cache)[:-1] if not self._ref_pins.get(c)),
                          None)
            if victim is None:
                break
            del self._ref_cache[victim]
            self._stat("ref_evictions", 1)

    def _unpin(self, ckey: tuple) -> None:
        n = self._ref_pins.get(ckey, 0) - 1
        if n > 0:
            self._ref_pins[ckey] = n
        else:
            self._ref_pins.pop(ckey, None)

    def _merge_ref(self, out, sample, ckey: tuple, n_tissues: int) -> Seq2GeneOutput:
        """Reassemble a [3, ...] triple output from a het/hom pair dispatch
        plus the cached ref: expression and embedding do not depend on the
        variant; the ref token embeddings are host gathers from the cached
        final streams at THIS variant's positions (the in-model gather's
        values: the same stream values, index and f32 cast)."""
        ref = self._ref_cache[ckey]
        self._ref_cache.move_to_end(ckey)
        emb_dim = ref["emb"].shape[-1]
        if not any(np.isnan(x) for x in sample.gene_token_positions):
            pos = int(sample.gene_token_positions[0]) + 1
            gt_ref = ref["gene_stream"][:, pos, :].float().numpy()
        else:
            gt_ref = np.zeros((n_tissues, emb_dim), np.float32)
        if not np.isnan(sample.cre_token_position):
            row = ref["cre_stream"][int(sample.cre_token_position)].float().numpy()
            ct_ref = np.broadcast_to(row, (n_tissues, emb_dim))
        else:
            ct_ref = np.zeros((n_tissues, emb_dim), np.float32)

        def cat(head, tail):
            return np.concatenate([head[None], np.asarray(tail, np.float32)], axis=0)

        return Seq2GeneOutput(
            pred_expression=cat(ref["exp"], out.pred_expression),
            pooled_embedding=cat(ref["emb"], out.pooled_embedding),
            gene_token_embedding=cat(gt_ref, out.gene_token_embedding),
            cre_token_embedding=cat(ct_ref, out.cre_token_embedding),
        )

    # -- output assembly ----------------------------------------------------
    def compile_predictions(
        self, predictions: list[dict], output_dir: str, vcf_path=None,
        out_file: str | None = None,
    ) -> pd.DataFrame:
        emb_dim = self.config.seq2gene.emb_dim
        rows = {k: [] for k in (
            "chrom", "pos", "ref", "alt", "genes", "tissues", "variant_type",
            "population", "sample_name", "zygosity", "gene_exp", "gene_emb",
            "gene_token_embedding", "cre_token_embedding",
        )}
        for pair, pred in zip(self.gene_variant_pairs, predictions):
            variant, gene = pair["variant"], pair["gene"]
            out = pred["out"]
            nt = len(variant.tissue)
            if out is None:
                exp = np.full((3, nt), np.nan, np.float32)
                emb = gte = cte = np.full((3, nt, emb_dim), np.nan, np.float32)
            else:
                exp = np.asarray(out.pred_expression)          # [3, T]
                emb = np.asarray(out.pooled_embedding)         # [3, T, E]
                gte = np.asarray(out.gene_token_embedding)
                cte = np.asarray(out.cre_token_embedding)
            for t_idx, tissue in enumerate(variant.tissue):
                # zygosity 2=hom (row 2), 1=het (row 1), 0=ref (row 0)
                for zyg, row_i in (("2", 2), ("1", 1), ("0", 0)):
                    rows["chrom"].append(variant.chrom)
                    rows["pos"].append(variant.pos)
                    rows["ref"].append(variant.ref)
                    rows["alt"].append(variant.alt)
                    rows["genes"].append(gene["gene_id"])
                    rows["tissues"].append(self.tissue_idx_to_name[tissue])
                    rows["variant_type"].append(pred["variant_type"])
                    rows["population"].append(pair["population"])
                    rows["sample_name"].append(pair["sample_name"])
                    rows["zygosity"].append(zyg)
                    rows["gene_exp"].append(exp[row_i, t_idx])
                    rows["gene_emb"].append(emb[row_i, t_idx])
                    rows["gene_token_embedding"].append(gte[row_i, t_idx])
                    rows["cre_token_embedding"].append(cte[row_i, t_idx])
        df = pd.DataFrame(rows)
        if vcf_path is None:
            df = df[
                (df["zygosity"] != "0")
                | ((df["zygosity"] == "0") & (df["population"] == "REF_HG38"))
            ].reset_index(drop=True)
        if out_file is None:
            out_file = os.path.join(output_dir, "vep_VF.parquet")
        try:
            df.to_parquet(out_file)
            log.info("Predictions saved to %s", out_file)
        except (ImportError, OSError, ValueError, TypeError, NotImplementedError) as exc:
            # no parquet engine installed, or one that cannot take the
            # embedding columns: the frame is still returned
            log.warning("Could not write parquet (%s)", exc)
        return df

    def format_scores(self, df: pd.DataFrame) -> pd.DataFrame:
        """Pivot the long frame to {POP}-{zygosity}-exp columns."""
        df = df.copy()
        df["variant_id"] = df[["chrom", "pos", "ref", "alt"]].astype(str).agg("_".join, axis=1)
        df["gt-exp"] = df["population"] + "-" + df["zygosity"] + "-exp"
        df = df.rename(columns={"chrom": "chr"})
        df_exp = (
            df[["variant_id", "genes", "tissues", "variant_type", "gt-exp",
                "gene_exp", "chr", "pos", "ref", "alt"]]
            .drop_duplicates(
                subset=["variant_id", "genes", "tissues", "variant_type", "gt-exp"],
                keep="first",
            )
            .pivot(
                index=["variant_id", "genes", "tissues", "chr", "pos", "ref", "alt",
                       "variant_type"],
                columns="gt-exp",
                values="gene_exp",
            )
            .reset_index()
        )
        return df_exp.dropna(subset=["REF_HG38-0-exp"]).reset_index(drop=True)

    def eqtl_scores(self, df: pd.DataFrame, score: str = "log2fc") -> pd.DataFrame:
        """score: 'log2fc' (default) or 'poisson' (CDF-based)."""
        if score == "log2fc":
            return generate_log2fc_score(df, self.sources.af_path)
        if score == "poisson":
            return generate_poisson_score(df, self.sources.af_path)
        raise ValueError(f"unknown score type {score!r}")
