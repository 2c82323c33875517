"""VCFProcessor — the vcf2exp public API of the port.

The port of ``variantformer_tpu/api/vcfprocessor.py``: the same query-df
schema (gene_id, tissues) and output columns (predicted_expression,
embeddings). It runs on the card unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises. ``load_model`` reads the
reference's ``.pth`` (``api/model_manager.py``); without a CRE-map provider,
``predict`` reads the per-gene CRE maps through the artifacts' manifest
(``utils/assets.py``). The host engines are the C++ ones
(``utils/native.py``). ``create_vcf_from_variant`` writes (and merges into
a donor VCF) a BGZF VCF with its ``.tbi``. ``impl`` picks the forward's
routes as the JAX package's does (``models/seq2gene.py``); ``use_mesh``
spreads every flow over the ranks of a ``parallel/mesh.Mesh``.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from pathlib import Path

import pandas as pd
import torch
import yaml

from variantformer_tpu_torch.api.model_manager import ModelManager
from variantformer_tpu_torch.config import ModelConfig, load_model_config
from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
from variantformer_tpu_torch.device import compute_dtype, resolve_device
from variantformer_tpu_torch.models.params import to_tensors
from variantformer_tpu_torch.models.seq2gene import (
    IMPLS,
    Seq2GeneBatch,
    Seq2GeneOutput,
    pack_for_inference,
    seq2gene_forward,
    without_packed,
)
from variantformer_tpu_torch.utils import assets
from variantformer_tpu_torch.utils.bgzf import write_bgzf_lines
from variantformer_tpu_torch.utils.bpe import BPETokenizer
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.tabix import write_tbi
from variantformer_tpu_torch.utils.vcf import VCFReader, VCFStream

log = logging.getLogger(__name__)


@dataclasses.dataclass
class DataSources:
    fasta_path: str = ""
    gencode_path: str = ""
    bpe_vocab_path: str | None = None
    tissue_vocab_path: str | None = None
    checkpoint_path: str = ""
    tokenizer_checkpoint_path: str | None = None
    af_path: str | None = None
    cre_map_provider: object | None = None  # gene_id -> DataFrame

    def resolve_defaults(self):
        if self.bpe_vocab_path is None:
            self.bpe_vocab_path = assets.resolve_vocab_path("bpe_vocabulary_500.json")
        if self.tissue_vocab_path is None:
            self.tissue_vocab_path = assets.resolve_vocab_path("tissue_vocab.yaml")
        return self

    def default_cre_map_provider(self):
        """Per-gene CRE map CSVs through the artifacts' manifest
        (``assets.gene_cre_manifest``)."""
        manifest = assets.gene_cre_manifest()

        def provider(gene_id: str) -> pd.DataFrame:
            path = manifest.get_file_path(gene_id)
            if path is None:
                raise KeyError(f"No CRE map for gene {gene_id}")
            df = pd.read_csv(path)
            return df[["chromosome", "start_cre", "end_cre", "cre_name"]]

        return provider


class VCFProcessor:
    def __init__(
        self,
        model_class: str = "v4_pcg",
        sources: DataSources | None = None,
        config: ModelConfig | None = None,
        config_path: str | None = None,
        device: str | torch.device = "cuda",
        impl: str = "fused2",
    ):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.device = resolve_device(device)
        self.impl = impl
        self._mesh = None
        self.model_class = model_class
        self.config = config or load_model_config(config_path, model_class)
        self.sources = (sources or DataSources()).resolve_defaults()
        with open(self.sources.tissue_vocab_path) as fh:
            self.tissue_vocab: dict[str, int] = yaml.safe_load(fh)
        self.tokenizer = BPETokenizer.from_file(self.sources.bpe_vocab_path)
        self._gencode: pd.DataFrame | None = None
        self._params = None

    def get_tissues(self):
        return self.tissue_vocab.keys()

    def get_genes(self) -> pd.DataFrame:
        return self._load_gencode()

    def _load_gencode(self) -> pd.DataFrame:
        if self._gencode is None:
            self._gencode = pd.read_csv(self.sources.gencode_path)
        return self._gencode

    def create_vcf_from_variant(
        self, variant_df: pd.DataFrame, output_path: str, vcf_path: str | None = None
    ) -> str:
        """Write (and optionally merge) a BGZF VCF from a variant dataframe
        (columns chrom, pos, ref, alt, GT) and index it (``.tbi``).

        Reference alleles are checked against the FASTA. When merging, the
        donor VCF is STREAMED (O(1) memory) with the new records spliced in
        position order; a new record REPLACES any donor record at the same
        position. Returns the path of the written ``.vcf.gz``."""
        for col in ("chrom", "pos", "ref", "alt", "GT"):
            if col not in variant_df.columns:
                raise ValueError(f"{col} column is required")
        if len(variant_df) == 0:
            raise ValueError("variant_df is empty")
        fasta = FastaReader(self.sources.fasta_path)
        for _, row in variant_df.iterrows():
            pos, ref = int(row["pos"]), str(row["ref"])
            found = fasta.fetch(row["chrom"], pos - 1, pos - 1 + len(ref)).upper()
            if found != ref.upper():
                raise ValueError(
                    f"Reference mismatch at {row['chrom']}:{pos}: "
                    f"expected {ref!r} but found {found!r}"
                )

        # New records: the last one per (chrom, pos) wins, queued per
        # chromosome in position order.
        new: dict[tuple[str, int], tuple[str, str, str]] = {}
        for _, row in variant_df.iterrows():
            new[(str(row["chrom"]), int(row["pos"]))] = (
                str(row["ref"]), str(row["alt"]), str(row["GT"]))
        pending: dict[str, deque] = {}
        for (chrom, pos) in sorted(new):
            pending.setdefault(chrom, deque()).append((pos, *new[(chrom, pos)]))

        sample_name = "SAMPLE"
        contigs = sorted(pending)
        if vcf_path is not None:
            # One header pass: the sample name and the declared contigs, so
            # the header is written before a single record is streamed.
            hdr_scan = VCFReader.__new__(VCFReader)
            hdr_scan.path = vcf_path
            existing_contigs = []
            for raw in hdr_scan._lines():
                if raw.startswith(b"##contig=<ID="):
                    existing_contigs.append(
                        raw.decode().split("ID=", 1)[1].split(",", 1)[0].rstrip(">"))
                    continue
                if raw.startswith(b"#CHROM"):
                    names = raw.decode().split("\t")[9:]
                    sample_name = names[0] if names else "SAMPLE"
                    break
                if not raw.startswith(b"#"):
                    break
            contigs = list(dict.fromkeys(existing_contigs + contigs))

        def _fmt(chrom, pos, ref, alt, gt):
            return f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t{gt}"

        def merged_lines():
            yield "##fileformat=VCFv4.2"
            yield f"##reference={self.sources.fasta_path}"
            for chrom in contigs:
                yield f"##contig=<ID={chrom}>"
            yield '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">'
            yield "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample_name
            seen: set[str] = set()
            cur: str | None = None
            q: deque = deque()
            last_pos = -1
            if vcf_path is not None:
                # Stream the donor VCF and splice the new records in position
                # order; the input must be coordinate-sorted with grouped
                # chromosomes (the VCF/tabix contract).
                for chrom, var in VCFStream(vcf_path):
                    if chrom != cur:
                        while q:  # the finished chromosome's tail
                            yield _fmt(cur, *q.popleft())
                        if chrom in seen:
                            raise ValueError(f"{vcf_path} is not coordinate-sorted: "
                                             f"chromosome {chrom} appears twice")
                        seen.add(chrom)
                        cur, last_pos = chrom, -1
                        q = pending.pop(chrom, deque())
                    if var.pos < last_pos:
                        raise ValueError(
                            f"{vcf_path} is not coordinate-sorted at {chrom}:{var.pos}")
                    last_pos = var.pos
                    while q and q[0][0] < var.pos:
                        yield _fmt(chrom, *q.popleft())
                    if q and q[0][0] == var.pos:
                        yield _fmt(chrom, *q.popleft())  # the new record wins
                        continue
                    a0, a1 = var.alleles
                    alts = sorted({a for a in (a0, a1) if a != var.ref})
                    gt0 = 0 if a0 == var.ref else alts.index(a0) + 1
                    gt1 = 0 if a1 == var.ref else alts.index(a1) + 1
                    yield _fmt(chrom, var.pos, var.ref, ",".join(alts), f"{gt0}|{gt1}")
                while q:
                    yield _fmt(cur, *q.popleft())
            for chrom in sorted(pending):  # chromosomes absent from the donor VCF
                for rec in pending[chrom]:
                    yield _fmt(chrom, *rec)

        final = output_path if output_path.endswith(".vcf.gz") else output_path + ".vcf.gz"
        Path(final).parent.mkdir(parents=True, exist_ok=True)
        write_bgzf_lines(final, merged_lines())
        write_tbi(final)
        log.info("Wrote VCF %s + .tbi (streamed merge)", final)
        return final

    def validate_query(self, query_df: pd.DataFrame) -> pd.DataFrame:
        """Filter query rows to known genes/tissues."""
        gencode = self._load_gencode()
        known_genes = set(gencode["gene_id"])
        rows = []
        for _, row in query_df.iterrows():
            gene_id = row["gene_id"]
            if gene_id not in known_genes:
                log.warning("Gene %s not in gencode; skipping", gene_id)
                continue
            ids, names = [], []
            for t in str(row["tissues"]).split(","):
                if t in self.tissue_vocab:
                    ids.append(self.tissue_vocab[t])
                    names.append(t)
                else:
                    log.warning("Tissue %r not in vocab; skipping", t)
            if not ids:
                continue
            rows.append({"gene_id": gene_id, "tissues": ids, "tissue_names": names})
        if not rows:
            raise ValueError("No valid (gene, tissue) rows in query")
        return pd.DataFrame(rows)

    def _builder(self, vcf_path: str | None) -> GeneSampleBuilder:
        return GeneSampleBuilder(
            cfg=self.config.dataset,
            fasta=FastaReader(self.sources.fasta_path),
            tokenizer=self.tokenizer,
            gencode=self._load_gencode(),
            cre_map_provider=(
                self.sources.cre_map_provider or self.sources.default_cre_map_provider()
            ),
            vcf=VCFReader(vcf_path) if vcf_path else None,
        )

    def create_data(self, vcf_path: str | None, query_df: pd.DataFrame):
        """((validated query, sample builder), loader): the loader lazily
        yields (row, GeneSample) per query row."""
        query = self.validate_query(query_df)
        builder = self._builder(vcf_path)

        def loader():
            for _, row in query.iterrows():
                yield row, builder.build(row["gene_id"])

        return (query, builder), loader()

    def load_model(self, param_dtype: torch.dtype | None = None) -> dict:
        """Load ``sources.checkpoint_path`` (a reference ``.pth``; the
        tokenizer checkpoint first when one is given) onto the processor's
        device in ``param_dtype`` (bf16 by default), calibrate the config
        from it, and pack it as ``set_params`` does."""
        manager = ModelManager(
            dataclasses.replace(self.config, checkpoint_path=self.sources.checkpoint_path),
            tokenizer_checkpoint_path=self.sources.tokenizer_checkpoint_path,
        )
        loaded = manager.load_model(param_dtype or torch.bfloat16, device=self.device)
        self.config = loaded.config
        self.set_params(loaded.params)
        return loaded.params

    def cleanup(self):
        """Release the parameters (and the card's cached blocks); clears
        any mesh."""
        self._reset_mesh()
        self._params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def set_params(self, params, config: ModelConfig | None = None):
        """Inject parameters (a tree of numpy arrays or tensors, e.g. from
        ``models/init.init_seq2gene`` or the JAX package's init via
        numpy). The leaves move to the processor's device, and the stacks
        the forward runs through the whole-stack ops (as ``impl`` and the
        config route them) are packed once, here
        (``seq2gene.pack_for_inference``). Clears any mesh: call
        ``use_mesh`` again after."""
        self._reset_mesh()
        if config is not None:
            self.config = config
        self._params = pack_for_inference(to_tensors(params, self.device), self.config,
                                          self.impl)

    def _reset_mesh(self):
        """Undo ``use_mesh``: the pre-mesh impl, device and whole parameters
        (packed as ``set_params`` left them, so the whole-stack kernels run
        again)."""
        if self._mesh is not None:
            self._mesh = None
            self.impl = self._impl_before_mesh
            self.device = self._device_before_mesh
            self._params = self._whole_params
            self._whole_params = None

    def use_mesh(self, mesh=None, partition: str = "donor"):
        """Spread every flow (vcf2exp, VEP, sweeps) over the ranks of a
        ``parallel/mesh.Mesh`` (``make_mesh()`` by default, which needs
        ``parallel/launch.initialize_distributed`` first). Every rank calls
        the same API on the same inputs and gets the same outputs. Call
        after ``load_model()``/``set_params()``.

        ``partition="donor"``: donors split over every rank; each runs the
        intact forward (the whole-stack kernels on the card) on its donors
        with whole weights, and the outputs are all-gathered. A donor count
        the ranks do not divide is suffix-padded and the pad rows sliced
        off.

        ``partition="tissue"``: single-donor scale-out. The window axes
        split over every rank for the encoder (the embeddings all-gathered)
        and each rank runs the gene stack on its tissue shard, each stage
        on the route ``impl`` and the config give it unmeshed (the
        context flavour and max pooling take the layered encoder, the gene
        stack still its kernel under ``"fused2"``).

        ``impl="xla"`` runs the layered route under either partition, with
        heads and FFN columns split over the "model" axis and donors (or
        tissues and windows) over "data"."""
        from variantformer_tpu_torch.parallel import mesh as pmesh

        if self._params is None:
            raise RuntimeError("call load_model() or set_params() first")
        if partition not in ("donor", "tissue"):
            raise ValueError(f"unknown partition {partition!r}")
        mesh = mesh or pmesh.make_mesh()
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's rank device {mesh.device} is not a "
                             f"{self.device.type} device like the processor's")
        if self._mesh is None:
            # Recorded on the first call only: re-meshing must not overwrite
            # them, or _reset_mesh could never restore the kernel route.
            self._impl_before_mesh = self.impl
            self._device_before_mesh = self.device
            self._whole_params = self._params
        else:
            # Re-meshing decides from the ORIGINAL impl and whole weights.
            self.impl = self._impl_before_mesh
            self._params = self._whole_params
        self._mesh_fused = self.impl != "xla"
        self.device = mesh.device
        if self._mesh_fused:
            self._whole_params = pack_for_inference(self._params, self.config, self.impl)
            self._params = pmesh.replicate_params(self._whole_params, mesh)
        else:
            pmesh.check_model_split(self.config, mesh)
            self._params = pmesh.shard_params(without_packed(self._params), mesh)
        self._mesh = mesh
        self._mesh_partition = partition

    def _to_device(self, batch: Seq2GeneBatch) -> Seq2GeneBatch:
        """The batch's numpy leaves as tensors on the processor's device (a
        few MB of int32 per batch)."""
        return batch._replace(**{
            name: torch.as_tensor(leaf).to(self.device)
            for name, leaf in batch._asdict().items() if leaf is not None
        })

    def _forward(self, batch: Seq2GeneBatch, return_streams: bool = False,
                 narrow_embeddings: bool = False) -> Seq2GeneOutput:
        """One batch (numpy or tensor leaves) through the model on the
        processor's device. The outputs stay there.

        ``return_streams`` adds the final gene and CRE streams.
        ``narrow_embeddings`` gives the three embedding outputs in bf16
        (pred_expression stays f32): lossless when the compute dtype is
        bf16, since they are upcasts of bf16 stream values, and a no-op
        otherwise. It halves the embeddings' copy to the host."""
        if self._params is None:
            raise RuntimeError("call load_model() or set_params() first")
        if self._mesh is not None:
            if return_streams:
                raise ValueError("return_streams is a single-device path (VEP ref-once cache)")
            out = self._mesh_forward(batch)
        else:
            with torch.inference_mode():
                out = seq2gene_forward(self._params, self._to_device(batch), self.config,
                                       impl=self.impl, return_streams=return_streams)
        if narrow_embeddings and compute_dtype(self.config.precision) == torch.bfloat16:
            out = out._replace(**{
                name: getattr(out, name).to(torch.bfloat16)
                for name in ("pooled_embedding", "gene_token_embedding", "cre_token_embedding")
            })
        return out

    def _mesh_forward(self, batch: Seq2GeneBatch) -> Seq2GeneOutput:
        """One batch over the mesh: donors (or tissues and windows) padded
        to a multiple of the ranks they split over, this rank's shard run,
        the outputs gathered whole and the padding sliced off."""
        from variantformer_tpu_torch.parallel import mesh as pmesh

        mesh, fused = self._mesh, self._mesh_fused
        batch = Seq2GeneBatch(*(None if v is None else torch.as_tensor(v) for v in batch))
        d, t = batch.cre_tokens.shape[0], batch.tissue_ids.shape[0]
        # The kernel route splits over every rank, the layered one over "data".
        n = mesh.size if fused else mesh.shape["data"]
        if self._mesh_partition == "donor":
            if d % n:
                pad = n - d % n
                batch = batch._replace(**{
                    name: torch.cat([leaf] + [leaf[-1:]] * pad)
                    for name, leaf in batch._asdict().items()
                    if leaf is not None and leaf.dim() and name != "tissue_ids"
                    and "pool" not in name
                })
            if fused:
                out = pmesh.donor_dp_forward(self.config, mesh, impl=self.impl)(
                    self._params, pmesh.shard_batch_donor_all(batch, mesh))
            else:
                out = pmesh.sharded_forward(self.config, mesh)(
                    self._params, pmesh.shard_batch(batch, mesh, "donor"))
        else:
            batch, _ = pmesh.pad_tissue_axis(batch, mesh, multiple=n if fused else None)
            if fused:
                out = pmesh.tissue_dp_forward(self.config, mesh, impl=self.impl)(
                    self._params, pmesh.shard_batch_tissue_all(batch, mesh))
            else:
                out = pmesh.sharded_forward(self.config, mesh)(
                    self._params, pmesh.shard_batch(batch, mesh, "tissue"))
        return Seq2GeneOutput(*(leaf[:d, :t] for leaf in out[:4]))

    def predict(
        self,
        vcf_path: str | None,
        query_df: pd.DataFrame,
        batch_size: int = 4,
    ) -> pd.DataFrame:
        """vcf2exp: per query row, predicted expression + pooled embedding per
        tissue (list-valued columns appended to the validated query df)."""
        if self._params is None:
            raise RuntimeError("call load_model() or set_params() first")
        query = self.validate_query(query_df)
        builder = self._builder(vcf_path)

        pred_col: list = [None] * len(query)
        emb_col: list = [None] * len(query)
        # Group rows by tissue tuple so each batch shares one tissue axis.
        by_tissues: dict[tuple, list[int]] = {}
        for i, row in query.iterrows():
            by_tissues.setdefault(tuple(row["tissues"]), []).append(i)
        for tissues, row_ids in by_tissues.items():
            for start in range(0, len(row_ids), batch_size):
                ids = row_ids[start : start + batch_size]
                samples = [builder.build(query.iloc[i]["gene_id"]) for i in ids]
                out = self._forward(pack_samples(samples, list(tissues)))
                preds = out.pred_expression.cpu().numpy()   # [D, T]
                embs = out.pooled_embedding.cpu().numpy()   # [D, T, E]
                for j, i in enumerate(ids):
                    pred_col[i] = preds[j]
                    emb_col[i] = embs[j]
        query = query.copy()
        query["predicted_expression"] = pred_col
        query["embeddings"] = emb_col
        return query
