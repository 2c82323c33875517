"""finetune_seq2gene — fine-tune expression predictions on your own labels.

The port of ``examples/finetune_seq2gene.py``, the whole fine-tune flow:

  1. build training shards from a donor VCF + (gene, donor, tissue, TPM)
     expression table (``data/train_pipeline.TrainingShardWriter``),
  2. fit with the epoch loop: per-epoch validation, the plateau LR scale,
     the best checkpoint (``train/loop.fit``),
  3. save the best parameters as a port checkpoint and load them back into
     a ``VCFProcessor`` for inference.

It runs on the synthetic environment, on the card unless ``--device cpu``
is given; point the ``DataSources`` at real artifacts for a real fine-tune.

    python -m variantformer_tpu_torch.examples.finetune_seq2gene [--device cpu] [--root DIR]
"""

import sys
import tempfile
from pathlib import Path

import pandas as pd

from variantformer_tpu_torch.examples import _common


def main(root=None, device: str = "cuda"):
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.data.train_pipeline import TrainingShardWriter
    from variantformer_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint
    from variantformer_tpu_torch.train.loop import (
        fit,
        load_train_state,
        make_seq2gene_eval_loss,
        seq2gene_shard_batches,
    )
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState, make_seq2gene_train_step

    root = Path(root or tempfile.mkdtemp(prefix="vfx_finetune_"))
    sources, cfg, extras = _common.synthetic_env(root / "env")
    proc = VCFProcessor(sources=sources, config=cfg, device=device)

    # 1. Training shards: the processor's sample builder reads the donor VCF
    # (diploid consensus) exactly as inference does.
    expression = pd.DataFrame(
        [
            {"gene_id": "GENE1.1", "donor": "S1", "tissue": "tissue0", "TPM": 8.0, "FPKM": 6.0},
            {"gene_id": "GENE1.1", "donor": "S1", "tissue": "tissue3", "TPM": 0.2, "FPKM": 0.1},
            {"gene_id": "GENE2.1", "donor": "S1", "tissue": "tissue0", "TPM": 1.0, "FPKM": 0.8},
            {"gene_id": "GENE2.1", "donor": "S1", "tissue": "tissue3", "TPM": 4.0, "FPKM": 3.0},
        ]
    )
    query = pd.DataFrame({"gene_id": ["GENE1.1", "GENE2.1"],
                          "tissues": ["tissue0,tissue3"] * 2})
    (_, builder), _ = proc.create_data(extras["vcf"], query)
    writer = TrainingShardWriter(
        builders={"S1": builder},
        expression=expression,
        tissue_vocab=proc.tissue_vocab,
        out_dir=root / "shards",
    )
    written = writer.build_all(["GENE1.1", "GENE2.1"], ["S1"])
    print(f"built {len(written)} training shards")

    # 2. Fit. A real fine-tune starts from load_checkpoint(...); the
    # synthetic demo starts from the seeded init.
    params = _common.synthetic_params(cfg, device)
    opt = make_optimizer(
        params, learning_rate=3e-3, plateau="epoch", train_gene_tokenizer=False
    )
    state = TrainState(params, opt, 0)
    # The tokenizers are frozen (the reference's training contract), so
    # their backward is never built.
    step = make_seq2gene_train_step(cfg, opt, freeze_tokenizers=True)
    tissues = [proc.tissue_vocab["tissue0"], proc.tissue_vocab["tissue3"]]
    train_b = seq2gene_shard_batches(root / "shards", tissues, batch_size=2, device=device)
    val_b = seq2gene_shard_batches(
        root / "shards", tissues, batch_size=2, shuffle=False, device=device
    )
    res = fit(
        state, step, train_b,
        eval_loss=make_seq2gene_eval_loss(cfg, val_b),
        epochs=6, ckpt_dir=root / "fit",
    )
    print(f"fit: val {res.history[0]['val_loss']:.4f} -> "
          f"{res.history[-1]['val_loss']:.4f} (best epoch {res.best_epoch})")

    # 3. Ship the best parameters as a port checkpoint; reload for inference.
    best = load_train_state(root / "fit" / "best", res.state)
    save_checkpoint(root / "finetuned", best.params, cfg)
    params2, cfg2 = load_checkpoint(root / "finetuned", device=device)
    proc2 = VCFProcessor(sources=sources, config=cfg2, device=device)
    proc2.set_params(params2)
    out = proc2.predict(extras["vcf"], query)
    for _, row in out.iterrows():
        for name, value in zip(row["tissue_names"], row["predicted_expression"]):
            print(f"  {row['gene_id']:10s} {name:10s} pred {value:8.4f}")
    assert res.history[-1]["val_loss"] < res.history[0]["val_loss"]
    return res, out


if __name__ == "__main__":
    args = _common.flow_args(__doc__)
    sys.exit(0 if main(args.root, args.device) is not None else 1)
