"""Part of the PyTorch port (see variantformer_tpu_torch/__init__.py)."""
