"""Capability probes of the Hopper kernels, the counterpart of
``scripts/mosaic_capability_probe.py``.

Each probe runs one small kernel of ``csrc/probes.cu`` (through its wrapper
in ``ops/kernels.py``) on the JAX script's input, made from
``np.random.default_rng(0)``, checks it against the same numpy expectation
at the same tolerance, and returns ``(ok, detail)``:

    48slice    lane slices at 48-element offsets          (max err < 1e-6)
    3dreshape  [16, 192] -> [16, 4, 48] summed over heads  (max err < 1e-5)
    48bf16mm   48-wide bf16 head slices feeding a product  (max err < 0.5)

    python -m variantformer_tpu_torch.probes [48slice 3dreshape 48bf16mm] [--device cpu]

prints one ``name: OK (max err ...)`` line a probe, as the JAX script does,
and exits non-zero unless every probe is OK. It runs on the card; without
one it raises unless ``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.ops import kernels

HEAD, HEADS = kernels.PROBE_HEAD, kernels.PROBE_HEADS


def probe_input(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The JAX script's input: normal(0, 1) from ``default_rng(0)``, cast."""
    x = np.random.default_rng(0).normal(size=shape)
    return torch.from_numpy(x).to(dtype).to(device)


def _max_err(out: torch.Tensor, expect: np.ndarray) -> float:
    return float(np.abs(out.float().cpu().numpy() - expect).max())


def probe_48slice(device="cuda"):
    """Lane slicing at 48-element offsets."""
    x = probe_input((16, HEADS * HEAD), torch.float32, device)
    out = kernels.probe_48slice(x)
    expect = x.cpu().numpy() * np.repeat([1.0, 2.0, 3.0, 4.0], HEAD)[None, :]
    err = _max_err(out, expect)
    return err < 1e-6, f"max err {err}"


def probe_3dreshape(device="cuda"):
    """[R, H*D] -> [R, H, D] lane-splitting reshape, summed over H."""
    x = probe_input((16, HEADS * HEAD), torch.float32, device)
    out = kernels.probe_3dreshape(x)
    expect = x.cpu().numpy().reshape(16, HEADS, HEAD).sum(1)
    err = _max_err(out, expect)
    return err < 1e-5, f"max err {err}"


def probe_48slice_bf16_matmul(device="cuda"):
    """bf16 48-offset slices feeding a product (the modulator pattern)."""
    x = probe_input((32, HEADS * HEAD), torch.bfloat16, device)
    out = kernels.probe_48slice_bf16_matmul(x)
    xf = x.float().cpu().numpy()
    expect = np.concatenate(
        [(xf[:, h * HEAD:(h + 1) * HEAD] @ xf[:, h * HEAD:(h + 1) * HEAD].T)[:, :16]
         for h in range(HEADS)], axis=1)
    err = _max_err(out, expect)
    return err < 0.5, f"max err {err}"


PROBES = {
    "48slice": probe_48slice,
    "3dreshape": probe_3dreshape,
    "48bf16mm": probe_48slice_bf16_matmul,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("names", nargs="*", metavar="name",
                        help=f"probes to run (default: all of {', '.join(PROBES)})")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels, default) or cpu (their plain versions)")
    args = parser.parse_args(argv)
    unknown = [n for n in args.names if n not in PROBES]
    if unknown:
        parser.error(f"unknown probes {unknown}; choose from {list(PROBES)}")
    device = resolve_device(args.device)
    failed = 0
    for name in args.names or list(PROBES):
        try:
            ok, detail = PROBES[name](device)
            print(f"{name}: {'OK' if ok else 'WRONG-RESULT'} ({detail})")
        except Exception as exc:  # report and go on, as the JAX script does
            ok = False
            print(f"{name}: FAIL ({type(exc).__name__}: {str(exc)[:200]})")
        failed += not ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
