"""Multi-process data-parallel training launcher: the port of
``scripts/launch_train.py`` on ``torch.distributed``.

Run one process per card (torchrun sets the rendezvous), or pass
``--coordinator``/``--num-processes``/``--process-id`` (or ``--init-method``)
yourself. Each process takes its round-robin share of the training shards
(``seq2gene_shard_batches(process_split=)``) and contributes its donors to
every global batch: one mesh spans every rank, each rank runs the
whole-stack kernels on its donors with whole weights, and one all-reduce a
step sums the gradients (``parallel/mesh.donor_dp_train_step``), so every
rank takes the same update.

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m variantformer_tpu_torch.scripts.launch_train \\
        --shards shards/ --tissue-ids 0,2 --epochs 3 --global-batch 8 --out train/
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shards", required=True, help="seq2gene npz shard dir")
    ap.add_argument("--tissue-ids", required=True,
                    help="comma-separated tissue ids to train against")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--global-batch", type=int, default=None,
                    help="donors per global step (default: one per process)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0's store")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed rendezvous URL (e.g. file:///shared/store); "
                         "overrides --coordinator")
    ap.add_argument("--tiny-model", action="store_true",
                    help="tiny f32 config (CI / smoke runs)")
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint dir to fine-tune from "
                         "(default: seeded random init)")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="deterministic shard order (lockstep testing)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: cuda:{LOCAL_RANK}), cuda:N or cpu")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on a card, gloo on the "
                         "CPU); several ranks on one card need gloo")
    return ap.parse_args(argv)


def tiny_config():
    """The tiny f32 config of ``--tiny-model``."""
    from variantformer_tpu_torch.config import (
        ModelConfig,
        PrecisionPolicy,
        Seq2GeneConfig,
        WindowEncoderConfig,
    )

    return ModelConfig(
        window_encoder=WindowEncoderConfig(
            vocab_size=64, embedding_dim=32, num_heads=4, num_layers=1,
            ffn_hidden_dim=64, token_length=8,
        ),
        seq2gene=Seq2GeneConfig(
            emb_dim=32, gene_emb_dim=32, token_dim=32, num_heads=4,
            num_layers=2, ffn_hidden_dim=64,
        ),
        precision=PrecisionPolicy(compute_dtype="float32"),
    )


def main(argv=None) -> dict:
    """Train; returns this rank's ``history.json`` contents."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("launch_train")

    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.parallel.launch import (
        globalize_step_args,
        globalize_train_state,
        initialize_distributed,
        rank_device,
    )
    from variantformer_tpu_torch.parallel.mesh import donor_dp_train_step, make_mesh
    from variantformer_tpu_torch.train.loop import fit, seq2gene_shard_batches
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState

    topo = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id, device=args.device,
        backend=args.backend, init_method=args.init_method,
    )
    rank, pc = topo["process_index"], topo["process_count"]
    device = rank_device()

    cfg = tiny_config() if args.tiny_model else ModelConfig()
    if args.checkpoint:
        from variantformer_tpu_torch.models.checkpoint import load_checkpoint

        params, ckpt_cfg = load_checkpoint(args.checkpoint, device=device)
        cfg = ckpt_cfg or cfg
    else:
        params = init_seq2gene(cfg, 0, device=device)
    opt = make_optimizer(params, learning_rate=args.lr, plateau="epoch")
    # One data-parallel mesh over every rank; whole parameters on each.
    mesh = make_mesh(num_model=1)
    state = globalize_train_state(TrainState(params, opt, 0), mesh)
    step = donor_dp_train_step(cfg, mesh, opt)

    tissue_ids = [int(t) for t in args.tissue_ids.split(",")]
    global_batch = args.global_batch or pc
    if global_batch % pc:
        raise SystemExit(f"--global-batch {global_batch} not divisible by "
                         f"{pc} processes")
    train_b = seq2gene_shard_batches(
        args.shards, tissue_ids,
        batch_size=global_batch // pc,
        shuffle=not args.no_shuffle,
        process_split=(rank, pc),
        device=device,
    )

    steps = 0

    def counted(*a):
        nonlocal steps
        steps += 1
        return step(*a)

    t0 = time.perf_counter()
    res = fit(
        state, counted, train_b, epochs=args.epochs,
        shard_fn=lambda b: globalize_step_args(b, mesh),
    )
    fit_s = time.perf_counter() - t0

    out_dir = Path(args.out) / f"host_{rank:03d}"
    out_dir.mkdir(parents=True, exist_ok=True)
    history = {
        "host": rank, "processes": pc, "global_batch": global_batch,
        "epochs": res.history, "steps": steps, "fit_seconds": fit_s,
    }
    (out_dir / "history.json").write_text(json.dumps(history, indent=2))
    log.info("done: final train loss %.6g", res.history[-1]["train_loss"])
    if rank == 0 and not args.tiny_model:
        from variantformer_tpu_torch.models.checkpoint import save_checkpoint

        save_checkpoint(Path(args.out) / "trained", res.state.params, cfg)
    return history


if __name__ == "__main__":
    from variantformer_tpu_torch.parallel.launch import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
