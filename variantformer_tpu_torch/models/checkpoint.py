"""The port's checkpoint format: the parameter tree and a JSON config.

The JAX package (``variantformer_tpu/models/checkpoint.py``) writes its
parameter tree with orbax, which cannot be read without JAX. The port keeps
a format of its own with the same layout of a directory: ``params.pt``, the
tree of tensors as ``torch.save`` writes it, and ``config.json``, the
``ModelConfig`` as the JAX package writes it. ``convert_torch_checkpoint`` is
the one-shot migration from a reference ``.pth``:

    python -m variantformer_tpu_torch.models.checkpoint model.pth out_dir

``load_checkpoint(mesh=...)`` restores each rank's own slice of every leaf
the mesh splits over its model axis (``parallel/mesh.shard_params``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from variantformer_tpu_torch.config import ModelConfig, _update
from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models import convert
from variantformer_tpu_torch.models.params import to_tensors

PARAMS_FILE = "params.pt"
CONFIG_FILE = "config.json"


def save_checkpoint(path: str | Path, params, cfg: ModelConfig | None = None) -> None:
    """Write ``params`` (numpy arrays or tensors, on any device) as CPU
    tensors, and ``cfg`` beside them when it is given."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(to_tensors(params, "cpu"), path / PARAMS_FILE)
    if cfg is not None:
        (path / CONFIG_FILE).write_text(json.dumps(dataclasses.asdict(cfg), indent=2))


def load_checkpoint(
    path: str | Path, dtype: torch.dtype | None = None, device: str | torch.device = "cuda",
    mesh=None,
) -> tuple[dict, ModelConfig | None]:
    """(params, cfg): the tree on ``device`` (the card unless the caller asks
    for the CPU), floating leaves cast to ``dtype`` when it is given; ``cfg``
    is None when no config was saved. With ``mesh`` (a
    ``parallel/mesh.Mesh``) each leaf is this rank's ``shard_params`` slice
    on the mesh's device (the whole file is read on the host and only the
    slice moves)."""
    path = Path(path).absolute()
    dev = mesh.device if mesh is not None else resolve_device(device)
    params = torch.load(path / PARAMS_FILE, map_location="cpu", weights_only=True)
    if mesh is not None:
        from variantformer_tpu_torch.parallel.mesh import shard_params

        params = shard_params(params, mesh)
    params = to_tensors(params, dev, dtype)
    cfg_file = path / CONFIG_FILE
    cfg = _update(ModelConfig(), json.loads(cfg_file.read_text())) if cfg_file.exists() else None
    return params, cfg


def convert_torch_checkpoint(
    torch_path: str,
    out_dir: str,
    cfg: ModelConfig | None = None,
    num_heads: int = 32,
    encoder_num_heads: int = 8,
) -> tuple[dict, dict]:
    """One-shot reference ``.pth`` -> port checkpoint of a seq2gene model.
    Returns (numpy params, the ``.pth``'s hyper_parameters)."""
    sd, hyper = convert.load_torch_checkpoint(torch_path)
    params = convert.convert_seq2gene(
        sd, num_heads=num_heads, encoder_num_heads=encoder_num_heads
    )
    save_checkpoint(out_dir, params, cfg)
    return params, hyper


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("torch_checkpoint")
    ap.add_argument("out_dir")
    ap.add_argument("--num-heads", type=int, default=32)
    ap.add_argument("--encoder-num-heads", type=int, default=8)
    args = ap.parse_args()
    convert_torch_checkpoint(
        args.torch_checkpoint, args.out_dir,
        num_heads=args.num_heads, encoder_num_heads=args.encoder_num_heads,
    )
