"""Multi-device inference and training on ``torch.distributed``: the port of
``variantformer_tpu/parallel/``. ``launch`` brings the process group up,
``mesh`` lays the ranks out as a (data, model) grid and splits parameters,
batches and optimizer state over it, ``comm`` holds the collectives.
"""
