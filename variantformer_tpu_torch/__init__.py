"""PyTorch port of the variantformer_tpu serving path, for one NVIDIA H100.

The JAX package ``variantformer_tpu`` is the reference; this package imports
nothing from it and no JAX. Its two whole-stack Pallas kernels (the window
encoder and the gene modulator) run here as chains of CUDA C++ kernels
written for ``sm_90a`` (``csrc/``), built with nvcc at first use.
"""
