"""Ring depth and split count of the TMA + wgmma weight gradient, timed on
the card.

    python -m variantformer_tpu_torch.gemm_bench [--iters N] [--json PATH]

Holds two choices of ``csrc/gemm_sm90.cu`` and its launch plan
(``ops/kernels.py`` ``gemm_plan``) against their alternatives, at the
weight-gradient shapes of a training step (the window encoder's 80 000
gene-window rows, the gene stack's 4 x 54 x 201 rows), added into a buffer:

* the ring depth: the built default (3 stages) against a second build of
  the source with ``VF_GEMM_STAGES=4``, which the weight gradient alone fits
  (it has no staging tile);
* the split count where the rows are split: the plan's against twice as
  many and half as many.

Each variant is first checked against the plain version (within 1e-3 of
max |plain|), then each pair is timed in the order a, b, b, a over CUDA
events (``--iters`` calls after one warm-up each time). Prints one line per
pair, the card's name and power limit, and a JSON line with every time;
``--json`` also writes it to a file. Needs a CUDA device.

The choice of 256-wide tiles at every N was made with this script's first
form, which also timed 128-wide tiles (``PERF.md`` section 6).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from variantformer_tpu_torch.ops import kernels

WGRAD_TOL = 1e-3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def make_plan(m: int, n: int, k: int, splits: int, sms: int) -> kernels.GemmPlan:
    """A launch plan with the split count given."""
    tiles_m, tiles_n = _cdiv(m, kernels.GEMM_BLOCK_M), _cdiv(n, kernels.GEMM_BLOCK_N)
    ktiles = _cdiv(k, kernels.GEMM_BLOCK_K)
    per_split = _cdiv(ktiles, splits)
    splits = _cdiv(ktiles, per_split)
    return kernels.GemmPlan(tiles_m, tiles_n, splits, per_split,
                            min(tiles_m * tiles_n * splits, sms), min(8, tiles_m))


def build_variant(define: str):
    """``vf_gemm_sm90`` of ``gemm_sm90.cu`` built with ``-D<define>``, beside
    the default build."""
    info = kernels.build()
    lib = Path(info["dir"]) / f"gemm_sm90_{define.replace('=', '_')}.so"
    if not lib.exists():
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-D{define}", "-o", str(lib),
               str(kernels.CSRC / "gemm_sm90.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -D{define} failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).vf_gemm_sm90
    fn.argtypes = kernels._SIGNATURES["gemm_sm90.cu"]["vf_gemm_sm90"]
    fn.restype = ctypes.c_int
    return fn


def wgrad_launcher(fn, x, dy, out, plan):
    """out [K, N] += x [R, K]^T dy [R, N] by ``fn`` with the plan given (not
    counted in ``kernels.LAUNCHES``)."""
    rows, k = x.shape
    n = dy.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(x.data_ptr(), dy.data_ptr(), None, None, out.data_ptr(), k, n, rows, 1,
                plan.splits, plan.per_split, plan.blocks, plan.group_m, stream)
        if rc != 0:
            raise RuntimeError(f"vf_gemm_sm90 {plan}: CUDA error {rc}")
        return out

    return run


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    if not rel <= WGRAD_TOL:
        raise AssertionError(f"{name}: rel error {rel:.4g} > {WGRAD_TOL}")
    return rel


def pair(name: str, variants: dict, iters: int) -> dict:
    """Times two variants a, b, b, a; returns the mean ms of each."""
    (la, fa), (lb, fb) = variants.items()
    ta = [time_ms(fa, iters)]
    tb = [time_ms(fb, iters), time_ms(fb, iters)]
    ta.append(time_ms(fa, iters))
    res = {la: sum(ta) / 2, lb: sum(tb) / 2}
    print(f"{name}: {la} {res[la]:.4f} ms ({ta[0]:.4f}, {ta[1]:.4f}); "
          f"{lb} {res[lb]:.4f} ms ({tb[0]:.4f}, {tb[1]:.4f}); {lb}/{la} {res[lb] / res[la]:.4f}")
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Ring depth and split count of the TMA + wgmma "
                                             "weight gradient, timed on the card.")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gemm_bench needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    default = kernels._fn("gemm_sm90.cu", "vf_gemm_sm90")
    stages4 = build_variant("VF_GEMM_STAGES=4")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    results: dict = {"card": card.strip(), "iters": args.iters, "cases": {}}

    rows_enc, rows_gene = 400 * 200, 4 * 54 * 201
    for label, rows, k, n in (("encoder out-proj", rows_enc, 512, 512),
                              ("encoder ffn_out", rows_enc, 1024, 512),
                              ("encoder qkv", rows_enc, 512, 1536),
                              ("encoder ffn_in", rows_enc, 512, 2048),
                              ("gene qkv", rows_gene, 1536, 4608),
                              ("gene ffn_out", rows_gene, 1024, 1536)):
        x, dy = randn(rows, k), randn(rows, n)
        acc = torch.randn((k, n), generator=gen, device=dev)
        want = kernels.gemm_wgrad_plain(x, dy, out=acc.clone())
        planned = kernels.gemm_plan(k, n, rows, split=True, sms=sms)
        cands = {"planned": (default, planned), "stages4": (stages4, planned)}
        if planned.splits > 1:
            cands["2x splits"] = (default, make_plan(k, n, rows, 2 * planned.splits, sms))
            cands["half the splits"] = (default, make_plan(k, n, rows, planned.splits // 2, sms))
        runs = {}
        for key, (fn, plan) in cands.items():
            out = acc.clone()
            run = wgrad_launcher(fn, x, dy, out, plan)
            rel = check(f"{label} {key}", run(), want)
            print(f"check gemm_wgrad {label} {key} {plan}: rel={rel:.3g}")
            runs[key] = run  # the timed calls add into `out` again, unchecked
        base = f"gemm_wgrad {rows} rows [{k},{n}] {label}, {planned.splits} splits planned"
        for other in [key for key in runs if key != "planned"]:
            name = f"{base}: planned vs {other}"
            results["cases"][name] = pair(name, {"planned": runs["planned"], other: runs[other]},
                                          args.iters)
        del x, dy, acc, want, runs

    line = json.dumps(results)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
