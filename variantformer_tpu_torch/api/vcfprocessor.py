"""VCFProcessor — the vcf2exp public API of the port.

The port of ``variantformer_tpu/api/vcfprocessor.py``: the same query-df
schema (gene_id, tissues) and output columns (predicted_expression,
embeddings). It runs on the card unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises. ``load_model`` reads the
reference's ``.pth`` (``api/model_manager.py``); without a CRE-map provider,
``predict`` reads the per-gene CRE maps through the artifacts' manifest
(``utils/assets.py``). The host engines are the C++ ones
(``utils/native.py``).

Not ported yet: ``use_mesh`` and ``create_vcf_from_variant``.
"""

from __future__ import annotations

import dataclasses
import logging

import pandas as pd
import torch
import yaml

from variantformer_tpu_torch.api.model_manager import ModelManager
from variantformer_tpu_torch.config import ModelConfig, load_model_config
from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
from variantformer_tpu_torch.device import compute_dtype, resolve_device
from variantformer_tpu_torch.models.params import to_tensors
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    Seq2GeneOutput,
    gene_packed,
    seq2gene_forward,
)
from variantformer_tpu_torch.models.seq2reg import encoder_packed
from variantformer_tpu_torch.utils import assets
from variantformer_tpu_torch.utils.bpe import BPETokenizer
from variantformer_tpu_torch.utils.fasta import FastaReader
from variantformer_tpu_torch.utils.vcf import VCFReader

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
    ):
        self.device = resolve_device(device)
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
        """Release the parameters (and the card's cached blocks)."""
        self._params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def set_params(self, params, config: ModelConfig | None = None):
        """Inject parameters (a tree of numpy arrays or tensors, e.g. from
        ``models/init.init_seq2gene`` or the JAX package's init via
        numpy). The leaves move to the processor's device, and the window
        encoders and the gene stack are packed once, here, in the compute
        dtype — repacking ~1.2 GB per forward is what this avoids."""
        if config is not None:
            self.config = config
        params = to_tensors(params, self.device)
        dt = compute_dtype(self.config.precision)
        wcfg = self.config.window_encoder
        for name in ("cre_tokenizer", "gene_tokenizer"):
            params[name]["layers_packed"] = encoder_packed(params[name], wcfg, dt)
        params["gene_layers_packed"] = gene_packed(params, self.config)
        self._params = params

    def _to_device(self, batch: Seq2GeneBatch) -> Seq2GeneBatch:
        """The batch's numpy leaves as tensors on the processor's device (a
        few MB of int32 per batch)."""
        return batch._replace(**{
            name: torch.as_tensor(leaf).to(self.device)
            for name, leaf in batch._asdict().items() if leaf is not None
        })

    def _forward(self, batch: Seq2GeneBatch) -> Seq2GeneOutput:
        """One batch (numpy or tensor leaves) through the model on the
        processor's device."""
        if self._params is None:
            raise RuntimeError("call load_model() or set_params() first")
        with torch.inference_mode():
            return seq2gene_forward(self._params, self._to_device(batch), self.config)

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
