"""Alzheimer's-disease risk head: gradient-boosted-tree inference over
gene-tissue embeddings.

The port of ``variantformer_tpu/api/ad_risk.py``. Tree ensembles are stored
as flat node arrays (the same ``.npz`` layout, so either package loads the
other's files) and evaluated either in numpy on the host (``raw_margin``) or
as a vectorized lockstep traversal in PyTorch on the card
(``torch_predict_margin``, for cohort-scale scoring). Converters load from
sklearn gradient-boosting models and — when the treelite package is
importable — from serialized treelite predictors.

``ADrisk(gene_id, tissue_id)(embeds) -> P(AD)`` and
``ADriskFromVCF(vcf_processor)(vcf, gene_ids, tissue_ids) -> DataFrame``;
the latter runs vcf2exp through the port's ``VCFProcessor`` (on the card
unless it was made with ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from variantformer_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TreeEnsemble:
    """Binary decision-tree ensemble in structure-of-arrays form.

    Per node: feature index (-1 = leaf), threshold, left/right child ids,
    value (leaf contribution). Trees are concatenated; ``tree_offsets`` holds
    each tree's first node. Prediction = base_score + sum of leaf values,
    mapped through sigmoid when ``objective == "binary_logistic"``.
    """

    feature: np.ndarray       # [n_nodes] int32
    threshold: np.ndarray     # [n_nodes] f32
    left: np.ndarray          # [n_nodes] int32 (absolute node ids)
    right: np.ndarray         # [n_nodes] int32
    value: np.ndarray         # [n_nodes] f32
    tree_offsets: np.ndarray  # [n_trees] int32
    base_score: float = 0.0
    objective: str = "binary_logistic"

    # -- evaluation --------------------------------------------------------
    def raw_margin(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, np.float32))
        out = np.full(x.shape[0], self.base_score, np.float64)
        for root in self.tree_offsets:
            node = np.full(x.shape[0], root, np.int64)
            while True:
                feat = self.feature[node]
                leaf = feat < 0
                if leaf.all():
                    break
                fv = x[np.arange(x.shape[0]), np.maximum(feat, 0)]
                go_left = fv <= self.threshold[node]
                nxt = np.where(go_left, self.left[node], self.right[node])
                node = np.where(leaf, node, nxt)
            out += self.value[node]
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        margin = self.raw_margin(x)
        if self.objective == "binary_logistic":
            p1 = 1.0 / (1.0 + np.exp(-margin))
            return np.stack([1.0 - p1, p1], axis=1)
        return margin[:, None]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """P(positive class) per row."""
        return self.predict_proba(x)[:, 1]

    # -- serialization -----------------------------------------------------
    def save(self, path: str):
        np.savez_compressed(
            path,
            feature=self.feature, threshold=self.threshold,
            left=self.left, right=self.right, value=self.value,
            tree_offsets=self.tree_offsets,
            base_score=np.float64(self.base_score),
            objective=np.bytes_(self.objective.encode()),
        )

    @classmethod
    def load(cls, path: str) -> "TreeEnsemble":
        z = np.load(path, allow_pickle=False)
        return cls(
            feature=z["feature"], threshold=z["threshold"],
            left=z["left"], right=z["right"], value=z["value"],
            tree_offsets=z["tree_offsets"],
            base_score=float(z["base_score"]),
            objective=bytes(z["objective"]).decode(),
        )

    # -- converters --------------------------------------------------------
    @classmethod
    def from_sklearn_gbm(cls, model) -> "TreeEnsemble":
        """Convert a fitted sklearn GradientBoostingClassifier (binary)."""
        feats, thrs, lefts, rights, vals, offsets = [], [], [], [], [], []
        lr = model.learning_rate
        base = 0.0
        if hasattr(model, "_raw_predict_init"):
            base = float(
                model._raw_predict_init(np.zeros((1, model.n_features_in_)))[0, 0]
            )
        n = 0
        for stage in model.estimators_:
            tree = stage[0].tree_
            offsets.append(n)
            feats.append(np.where(tree.children_left < 0, -1, tree.feature))
            thrs.append(tree.threshold)
            lefts.append(np.where(tree.children_left < 0, 0, tree.children_left + n))
            rights.append(np.where(tree.children_right < 0, 0, tree.children_right + n))
            vals.append(
                np.where(tree.children_left < 0, tree.value[:, 0, 0] * lr, 0.0)
            )
            n += tree.node_count
        return cls(
            feature=np.concatenate(feats).astype(np.int32),
            threshold=np.concatenate(thrs).astype(np.float32),
            left=np.concatenate(lefts).astype(np.int32),
            right=np.concatenate(rights).astype(np.int32),
            value=np.concatenate(vals).astype(np.float32),
            tree_offsets=np.asarray(offsets, np.int32),
            base_score=base,
            objective="binary_logistic",
        )

    @classmethod
    def from_treelite(cls, path: str) -> "TreeEnsemble":
        """Load a serialized treelite predictor (requires the treelite
        package)."""
        import treelite

        model = treelite.Model.deserialize(path)
        # Walk treelite's field accessors into flat arrays.
        header = model.get_header_accessor()
        n_trees = int(header.get_field("num_tree")[0])
        feats, thrs, lefts, rights, vals, offsets = [], [], [], [], [], []
        n = 0
        for t in range(n_trees):
            tree = model.get_tree_accessor(t)
            num_nodes = int(tree.get_field("num_nodes")[0])
            cleft = np.asarray(tree.get_field("cleft"))
            cright = np.asarray(tree.get_field("cright"))
            split = np.asarray(tree.get_field("split_index"))
            thr = np.asarray(tree.get_field("threshold"))
            leaf_val = np.asarray(tree.get_field("leaf_value"))
            is_leaf = cleft < 0
            offsets.append(n)
            feats.append(np.where(is_leaf, -1, split))
            thrs.append(thr)
            lefts.append(np.where(is_leaf, 0, cleft + n))
            rights.append(np.where(is_leaf, 0, cright + n))
            vals.append(np.where(is_leaf, leaf_val, 0.0))
            n += num_nodes
        return cls(
            feature=np.concatenate(feats).astype(np.int32),
            threshold=np.concatenate(thrs).astype(np.float32),
            left=np.concatenate(lefts).astype(np.int32),
            right=np.concatenate(rights).astype(np.int32),
            value=np.concatenate(vals).astype(np.float32),
            tree_offsets=np.asarray(offsets, np.int32),
            base_score=0.0,
            objective="binary_logistic",
        )


def torch_predict_margin(ensemble: TreeEnsemble, x, max_depth: int = 32,
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """Vectorized tree traversal on ``device``: [N, F] -> [N] f32 raw
    margins (a tensor on ``device``).

    All samples step all trees in lockstep for ``max_depth`` iterations
    (leaves self-loop): per step, gathers of each (sample, tree)'s node
    fields and feature value and one ``torch.where``, for cohort-scale AD
    scoring. ``max_depth`` must be at least the deepest tree's depth."""
    dev = resolve_device(device)
    feature = torch.as_tensor(ensemble.feature, device=dev).long()
    threshold = torch.as_tensor(ensemble.threshold, device=dev)
    left = torch.as_tensor(ensemble.left, device=dev).long()
    right = torch.as_tensor(ensemble.right, device=dev).long()
    value = torch.as_tensor(ensemble.value, device=dev)
    roots = torch.as_tensor(ensemble.tree_offsets, device=dev).long()

    x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=dev))
    node = roots[None, :].expand(x.shape[0], roots.shape[0])  # [N, T]
    for _ in range(max_depth):
        feat = feature[node]                        # [N, T]
        fv = torch.gather(x, 1, feat.clamp(min=0))
        nxt = torch.where(fv <= threshold[node], left[node], right[node])
        node = torch.where(feat < 0, node, nxt)
    return value[node].sum(dim=1) + ensemble.base_score


class ADrisk:
    """Per-(gene, tissue) AD-risk predictor."""

    def __init__(self, gene_id: str, tissue_id: int, model_class: str = "v4_pcg",
                 manifest=None):
        assert model_class in ("v4_ag", "v4_pcg")
        assert isinstance(tissue_id, int), "tissue_id should be an integer"
        assert isinstance(gene_id, str), "gene_id should be a string"
        self.gene_id = gene_id
        self.tissue_id = tissue_id
        if manifest is None:
            from variantformer_tpu_torch.utils import assets

            manifest = assets.gene_tissue_manifest(model_class)
        path = manifest.get_file_path(gene_id, tissue_id)
        if path is None:
            raise FileNotFoundError(
                f"AD predictor not found for gene {gene_id} / tissue {tissue_id}"
            )
        self.predictor = load_predictor(path)

    def __call__(self, gene_tissue_embeds: np.ndarray) -> np.ndarray:
        return self.predictor(np.atleast_2d(gene_tissue_embeds))


def load_predictor(path: str) -> TreeEnsemble:
    """Load a predictor: our .npz format, or a treelite artifact if the
    treelite package is available."""
    if str(path).endswith(".npz"):
        return TreeEnsemble.load(path)
    try:
        return TreeEnsemble.from_treelite(path)
    except ImportError as exc:
        raise RuntimeError(
            f"{path} looks like a treelite artifact; install treelite or "
            "convert it to the .npz ensemble format"
        ) from exc


class ADriskFromVCF:
    """Full vcf2exp -> per-(gene, tissue) AD risk."""

    def __init__(self, vcf_processor, model_class: str = "v4_pcg", manifest=None):
        self.vcf_processor = vcf_processor
        self.model_class = model_class
        if manifest is None:
            from variantformer_tpu_torch.utils import assets

            manifest = assets.gene_tissue_manifest(model_class)
        self.manifest = manifest
        tissues = vcf_processor.tissue_vocab
        self.tissue_names = {v: k for k, v in tissues.items()}

    def __call__(self, vcf_file: str, gene_ids: Sequence[str],
                 tissue_ids: Sequence[int]):
        import pandas as pd

        assert len(gene_ids) == len(tissue_ids)
        query = pd.DataFrame(
            {
                "gene_id": list(gene_ids),
                "tissues": [self.tissue_names[t] for t in tissue_ids],
            }
        )
        preds = self.vcf_processor.predict(vcf_file, query)
        risks = []
        for _, row in preds.iterrows():
            tissue_id = row["tissues"][0]
            emb = np.atleast_2d(np.asarray(row["embeddings"][0], np.float32))
            path = self.manifest.get_file_path(row["gene_id"], tissue_id)
            if path is None:
                risks.append(np.nan)
                continue
            risks.append(float(load_predictor(path)(emb)[0]))
        preds = preds.rename(columns={"tissues": "tissue_id", "embeddings": "embedding"})
        preds["tissue_id"] = preds["tissue_id"].apply(lambda x: x[0])
        preds["tissue_name"] = preds["tissue_id"].map(self.tissue_names)
        preds["ad_risk"] = risks
        return preds
