"""The example flows of the port: the counterparts of the repo's
``examples/*.py``, run as ``python -m variantformer_tpu_torch.examples.<flow>``
(on the card unless ``--device cpu`` is given). Each runs on the released
artifacts when they are present (``_common.artifacts_present``), else on a
3 kb synthetic genome with a tiny seeded model."""
