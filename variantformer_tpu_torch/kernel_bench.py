"""Times the attention forward and ``gemm_dgrad`` at the main paths' shapes
on the card: ``python -m variantformer_tpu_torch.kernel_bench [--label L]``.

Cases: the attention's three uses (the window encoder's self-attention over
1536 CRE windows, the gene stack's self-attention and its cross-attention to
384 CRE slots, 4 genes x 54 tissues), each at mixed key counts (0, 1 and
short rows, as ``chip_smoke.py`` checks them) and at the main path's full
ones; ``gemm_dgrad`` at the gene qkv shape with a residual and at a ragged
encoder shape. Each case is first held against its plain version (3e-2 of
max |plain| for the attention, one bf16 ulp for the GEMM), then timed by
CUDA events: the mean of ``--iters`` calls after one warm-up.

The script uses only the wrappers' signatures, so it can time another
tree's kernels in the same call for comparison: copy it into that tree's
``variantformer_tpu_torch/`` and run ``python -m
variantformer_tpu_torch.kernel_bench --label parent`` from that tree's
root. Prints the card's name and power limit, one JSON line per case and a
last JSON line with every case's ms.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    import variantformer_tpu_torch
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    print(f"package {variantformer_tpu_torch.__file__}")
    kernels.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(torch.bfloat16)
    ints = lambda v: torch.tensor(v, device=dev, dtype=torch.int32)

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    def check(name, out, ref, tol):
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        if not rel <= tol:
            raise AssertionError(f"{name}: rel error {rel:.4g} > {tol}")
        return rel

    results = {}

    def case(name, fn, plain, tol):
        rel = check(name, fn(), plain(), tol)
        ms = time_ms(fn)
        results[name] = ms
        print(json.dumps({"label": args.label, "case": name, "ms": ms, "rel_err": rel}))

    # attention: N=1536 windows of 200 tokens, 8 heads of 64; 4 x 54 gene
    # rows of 201, 32 heads of 48; cross K/V of 4 donors x 384 CRE slots.
    n_cre, length, d4, t, g1, c = 1536, 200, 4, 54, 201, 384
    enc_mixed = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                              dtype=torch.int32)
    enc_mixed[:4] = ints([0, 1, 2, length])
    uses = (
        ("encoder self", n_cre, length, n_cre, length, 8, 64, True, 1, 1,
         enc_mixed, ints([length] * n_cre)),
        ("gene self", d4 * t, g1, d4 * t, g1, 32, 48, True, 1, t,
         ints([201, 150, 1, 77]), ints([g1] * d4)),
        ("gene cross", d4 * t, g1, d4, c, 32, 48, False, t, t,
         ints([384, 300, 1, 2]), ints([c] * d4)),
    )
    for use, b, sq, kv_rows, sk, heads, hd, alibi, kv_div, len_div, mixed, full in uses:
        e = heads * hd
        if kv_div == 1:
            qkv = randn(b, sq, 3 * e, scale=2.0)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            kvt = randn(kv_rows, sk, 2 * e, scale=2.0)
            q, k, v = randn(b, sq, e, scale=2.0), kvt[..., :e], kvt[..., e:]
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        for suffix, lens in (("", mixed), (", full lengths", full)):
            a = (q, k, v, lens, slopes, hd ** -0.5, heads, kv_div, len_div)
            case(f"attention {use}{suffix}", lambda a=a: kernels.attention(*a),
                 lambda a=a: kernels.attention_plain(*a), 3e-2)

    # gemm_dgrad: dY [43416, 4608] W[1536, 4608]^T + residual; [66607, 1024] W[512, 1024]^T.
    for name, m, k, n, residual in (("gemm_dgrad gene qkv", d4 * t * g1, 1536, 4608, True),
                                    ("gemm_dgrad ragged M", 333 * 200 + 7, 512, 1024, False)):
        dy, w = randn(m, n), randn(k, n, scale=n ** -0.5)
        res = randn(m, k) if residual else None
        case(name, lambda dy=dy, w=w, res=res: kernels.gemm_dgrad(dy, w, res),
             lambda dy=dy, w=w, res=res: kernels.gemm_dgrad_plain(dy, w, res), 2.0 ** -7)
        del dy, w, res
    print(json.dumps({"label": args.label, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
