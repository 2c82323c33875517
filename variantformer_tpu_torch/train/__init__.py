"""Training: losses, optimizer, steps, metrics and the fit loop."""

# Each a submodule:
#   variantformer_tpu_torch.train.losses     poisson_nll, mse, cross-entropy, focal, dual loss
#   variantformer_tpu_torch.train.optimizer  make_optimizer (Adam/AdamW, plateau per epoch or
#                                            per step, gradient accumulation), apply_update
#   variantformer_tpu_torch.train.steps      seq2gene and seq2reg losses and train steps
#   variantformer_tpu_torch.train.metrics    per-class F1 / accuracy, make_seq2reg_eval_metrics
#   variantformer_tpu_torch.train.loop       fit, PlateauTracker, shard batches, eval losses
# Multi-device training (fit's mesh and shard_fn): variantformer_tpu_torch.parallel.mesh.
