"""Part of the PyTorch port (see variantformer_tpu_torch/__init__.py)."""

# Each a submodule:
#   variantformer_tpu_torch.models.core        projections, norms, GeGLU, attention blocks and
#                                              the context / cross-only / self-only layers
#   variantformer_tpu_torch.models.seq2reg     window encoder (both flavours, mean / max pool),
#                                              classify_windows
#   variantformer_tpu_torch.models.seq2gene    the hierarchical forward, every gene-layer variant
#   variantformer_tpu_torch.models.init        seeded parameter trees
#   variantformer_tpu_torch.models.params      the weight bridge (numpy <-> tensors)
#   variantformer_tpu_torch.models.convert     reference .pth -> parameter tree
#   variantformer_tpu_torch.models.checkpoint  the port's checkpoint format
