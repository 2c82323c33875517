"""The port's multi-process launchers: the counterparts of the repo's
``scripts/launch_genome_wide.py`` and ``scripts/launch_train.py`` on
``torch.distributed``, run as ``python -m variantformer_tpu_torch.scripts.<name>``."""
