"""Times the attention forward and backward, ``gemm_dgrad``, the LayerNorm
forward and backward, the masked mean pool and the vcf2exp forward at the
main paths' shapes on the card:
``python -m variantformer_tpu_torch.kernel_bench [--label L] [--group G]``.

Cases of ``--group fwd``: the attention's three uses (the window encoder's
self-attention over 1536 CRE windows, the gene stack's self-attention and
its cross-attention to 384 CRE slots, 4 genes x 54 tissues), each at mixed
key counts (0, 1 and short rows, as ``chip_smoke.py`` checks them) and at
the main path's full ones; ``gemm_dgrad`` at the gene qkv shape with a
residual and at a ragged encoder shape; ``layernorm`` at [43416, 1536] and
[307200, 512] and ``masked_mean_pool`` at [1536, 200, 512], as
``chip_smoke.py`` times them; and ``seq2gene_forward`` at full v4_pcg width
(random weights and tokens from a seed, 4 genes x 54 tissues, the batch
shapes of ``chip_smoke.py``'s vcf2exp run). Of ``--group bwd``: the
attention backward's four uses as the training path calls them (gene self
and the encoder's self-attention over 400 gene windows writing bf16 slices
of one d(QKV); gene cross with 384 CRE slots and with one writing f32
slices of one d(K|V)) and the LayerNorm backward at [43416, 1536] with two
residual cotangents and with none, and at [80000, 512]. ``--group all``
(the default) runs both. ``--profile`` adds each case's device time, in
all and by kernel (``torch.profiler``). Each case is first held against
its plain version (3e-2 of max(max |plain|, 1) for the attention, its
backward, the LayerNorm and its backward and the pool, one bf16 ulp for
the GEMM, 6e-2 of max |plain| for the forward's predictions and pooled
embeddings), then timed by CUDA events: the mean of ``--iters`` calls after
one warm-up.

The script uses only the entry points' and wrappers' signatures, so it can
time another tree's kernels in the same call for comparison: copy it into
that tree's ``variantformer_tpu_torch/`` and run ``python -m
variantformer_tpu_torch.kernel_bench --label parent`` from that tree's
root. Prints the card's name and power limit, one JSON line per case and a
last JSON line with every case's ms.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

# N=1536 CRE windows of 200 tokens, 8 heads of 64; 4 x 54 gene rows of 201,
# 32 heads of 48; cross K/V of 4 donors x 384 CRE slots.
N_CRE, LENGTH, D4, T, G1, C = 1536, 200, 4, 54, 201, 384


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--group", choices=("fwd", "bwd", "all"), default="all")
    parser.add_argument("--profile", action="store_true",
                        help="also print each case's device time, in all and by kernel "
                             "(torch.profiler)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    import variantformer_tpu_torch
    from variantformer_tpu_torch.ops import kernels

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

    def check(name, out, ref, tol, floor):
        if isinstance(out, (tuple, list)):
            return max(check(f"{name} [{i}]", o, r, tol, floor)
                       for i, (o, r) in enumerate(zip(out, ref)))
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), floor, 1e-30)
        if not rel <= tol:
            raise AssertionError(f"{name}: rel error {rel:.4g} > {tol}")
        return rel

    def by_kernel(fn) -> dict:
        """Device us of one call by kernel name (templates and arguments cut)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if ev.self_device_time_total > 0:
                name = ev.key.removeprefix("void ").replace("(anonymous namespace)::", "")
                key = re.split(r"[<(]", name)[0][:60]
                out[key] = out.get(key, 0.0) + ev.self_device_time_total
        return out

    results = {}

    def case(name, fn, plain, tol, floor=0.0):
        rel = check(name, fn(), plain(), tol, floor)
        ms = time_ms(fn)
        results[name] = ms
        line = {"label": args.label, "case": name, "ms": ms, "rel_err": rel}
        if args.profile:
            us = by_kernel(fn)
            line["device_ms"] = sum(us.values()) / 1e3
            line["device_us_by_kernel"] = us
        print(json.dumps(line))

    if args.group in ("fwd", "all"):
        forward_cases(torch, kernels, randn, ints, gen, case)
    if args.group in ("bwd", "all"):
        backward_cases(torch, kernels, randn, ints, gen, case)
    print(json.dumps({"label": args.label, "ms": results}))
    return 0


def forward_cases(torch, kernels, randn, ints, gen, case):
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    n_cre, length, d4, t, g1, c = N_CRE, LENGTH, D4, T, G1, C
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

    # layernorm at the gene rows and the CRE-window token rows; the pool of
    # the CRE windows' tokens.
    for name, rows, e in (("layernorm gene", d4 * t * g1, 1536),
                          ("layernorm cre-window", n_cre * length, 512)):
        x = randn(rows, e, scale=3.0)
        sc = torch.rand(e, generator=gen, device=dev) + 0.5
        bi = torch.randn(e, generator=gen, device=dev) * 0.1
        case(name, lambda x=x, sc=sc, bi=bi: kernels.layernorm(x, sc, bi),
             lambda x=x, sc=sc, bi=bi: kernels.layernorm_plain(x, sc, bi), 3e-2, floor=1.0)
        del x
    x = randn(n_cre, length, 512)
    tok_len = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                            dtype=torch.int32)
    tok_len[:3] = ints([0, 1, length])
    case("masked_mean_pool cre-window", lambda: kernels.masked_mean_pool(x, tok_len),
         lambda: kernels.masked_mean_pool_plain(x, tok_len), 3e-2, floor=1.0)
    del x
    vcf2exp_forward_case(torch, gen, case)


def vcf2exp_forward_case(torch, gen, case):
    """``seq2gene_forward`` at full v4_pcg width and depth on one batch of
    4 genes x 54 tissues (384 CRE and 200 gene windows of 200 tokens a
    gene), random weights from seed 0 and random tokens and lengths."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import (
        Seq2GeneBatch,
        seq2gene_forward,
        seq2gene_forward_plain,
    )

    dev = torch.device("cuda")
    cfg = ModelConfig()
    d, c, g, length, t = D4, C, 200, LENGTH, T
    ints = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=gen, device=dev,
                                           dtype=torch.int32)
    vocab = cfg.window_encoder.vocab_size
    batch = Seq2GeneBatch(
        cre_tokens=ints(0, vocab, d, c, length), cre_tok_len=ints(1, length + 1, d, c),
        cre_count=torch.full((d,), c, device=dev, dtype=torch.int32),
        cre_labels=ints(0, 9, d, c), gene_tokens=ints(0, vocab, d, g, length),
        gene_tok_len=ints(1, length + 1, d, g),
        gene_count=torch.full((d,), g, device=dev, dtype=torch.int32),
        tissue_ids=torch.arange(t, device=dev, dtype=torch.int32),
    )
    params = init_seq2gene(cfg, 0, device="cuda")

    def run(fwd):
        with torch.inference_mode():
            out = fwd(params, batch, cfg)
        return out.pred_expression, out.pooled_embedding

    case(f"vcf2exp forward, {d} genes x {t} tissues", lambda: run(seq2gene_forward),
         lambda: run(seq2gene_forward_plain), 6e-2)
    del params
    torch.cuda.empty_cache()


def backward_cases(torch, kernels, randn, ints, gen, case):
    """The attention backward's four uses, from the kernel forward's lse and
    f32 output, and the LayerNorm backward's three shapes."""
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    length, d4, t, g1, c = LENGTH, D4, T, G1, C
    n_gene = 400
    enc_lens = torch.randint(2, length + 1, (n_gene,), generator=gen, device=dev,
                             dtype=torch.int32)
    enc_lens[:4] = ints([0, 1, 2, length])
    uses = (
        ("gene self", d4 * t, g1, d4 * t, g1, 32, 48, True, 1, t, ints([201, 150, 1, 77])),
        ("gene cross C=384", d4 * t, g1, d4, c, 32, 48, False, t, t, ints([384, 300, 1, 2])),
        ("gene cross C=1", d4 * t, g1, d4, 1, 32, 48, False, t, t, ints([1, 1, 1, 1])),
        ("encoder self", n_gene, length, n_gene, length, 8, 64, True, 1, 1, enc_lens),
    )
    for use, b, sq, kv_rows, sk, heads, hd, alibi, kv_div, len_div, lens in uses:
        e = heads * hd
        if kv_div == 1:
            qkv = randn(b, sq, 3 * e, scale=2.0)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            kvt = randn(kv_rows, sk, 2 * e, scale=2.0)
            q, k, v = randn(b, sq, e, scale=2.0), kvt[..., :e], kvt[..., e:]
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        _, lse, o = kernels.attention(q, k, v, lens, slopes, hd ** -0.5, heads, kv_div, len_div,
                                      for_backward=True)
        a = (q, k, v, o, lse, randn(b, sq, e), lens, slopes, hd ** -0.5, heads, kv_div, len_div)
        # the cotangents' buffers as the training path hands them over
        if kv_div == 1:
            dqkv = torch.empty((b, sq, 3 * e), dtype=torch.bfloat16, device=dev)
            out = dict(dq=dqkv[..., :e], dk=dqkv[..., e:2 * e], dv=dqkv[..., 2 * e:])
        else:
            dkv = torch.empty((kv_rows, sk, 2 * e), dtype=torch.float32, device=dev)
            out = dict(dk=dkv[..., :e], dv=dkv[..., e:])
        case(f"attention_bwd {use}", lambda a=a, out=out: kernels.attention_bwd(*a, **out),
             lambda a=a: kernels.attention_bwd_plain(*a), 3e-2, floor=1.0)
        del a, q, k, v, o, lse, out
    rows = d4 * t * g1
    for name, n_rows, e, n_res in (("layernorm_bwd gene +2 residuals", rows, 1536, 2),
                                   ("layernorm_bwd gene, no residuals", rows, 1536, 0),
                                   ("layernorm_bwd encoder E=512, no residuals", n_gene * length,
                                    512, 0)):
        x, dy = randn(n_rows, e, scale=3.0), randn(n_rows, e)
        res = tuple(randn(n_rows, e) for _ in range(n_res))
        sc = torch.rand(e, generator=gen, device=dev) + 0.5
        case(name, lambda x=x, dy=dy, sc=sc, res=res: kernels.layernorm_bwd(x, dy, sc, res),
             lambda x=x, dy=dy, sc=sc, res=res: kernels.layernorm_bwd_plain(x, dy, sc, res), 3e-2,
             floor=1.0)
        del x, dy, res


if __name__ == "__main__":
    sys.exit(main())
