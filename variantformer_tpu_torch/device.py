"""Device resolution and the dtype policy of ``config.PrecisionPolicy``.

Entry points run on the card unless the caller asks for the CPU. Asking for
CUDA where there is none raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

from variantformer_tpu_torch.config import PrecisionPolicy

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def compute_dtype(policy: PrecisionPolicy) -> torch.dtype:
    """Dtype of matmul operands and activation streams."""
    return _DTYPES[policy.compute_dtype]
