"""Times the attention forward and backward, ``gemm_dgrad``, ``gemm_wgrad``,
the LayerNorm forward and backward, the masked mean pool, the vcf2exp
forward and a training step at the main paths' shapes on the card:
``python -m variantformer_tpu_torch.kernel_bench [--label L] [--group G]``.

Cases of ``--group fwd``: the attention's three uses (the window encoder's
self-attention over 1536 CRE windows, the gene stack's self-attention and
its cross-attention to 384 CRE slots, 4 genes x 54 tissues), the CRE
stack's self- and cross-attention (4 donors x 384 slots), the encoder's
self-attention at head dim 128 and the cross-attention to 1024 CRE slots
(past the one-chunk key limit), each at mixed key counts (0, 1 and short
rows, as ``chip_smoke.py`` checks them) and at the main path's full ones,
and the three uses at full key counts with ``for_backward`` (the
statistics variant the training forwards take); ``gemm_dgrad`` at
the gene qkv shape with a residual and at a ragged encoder shape;
``layernorm`` at [43416, 1536] and [307200, 512] and ``masked_mean_pool``
at [1536, 200, 512], as ``chip_smoke.py`` times them; and
``seq2gene_forward`` at full v4_pcg width (random weights and tokens from a
seed, 4 genes x 54 tissues, the batch shapes of ``chip_smoke.py``'s vcf2exp
run). Of ``--group bwd``: the attention backward's four uses as the
training path calls them (gene self and the encoder's self-attention over
400 gene windows writing bf16 slices of one d(QKV); gene cross with 384
CRE slots and with one writing f32 slices of one d(K|V)) and the gene
cross-attention to 1024 CRE slots; the LayerNorm backward at [43416, 1536]
with two residual cotangents and with none, and at [80000, 512];
``gemm_wgrad`` at the training step's shapes whose rows the plan splits,
and at the unsplit gene qkv, into a non-zero buffer; and one
``make_seq2gene_train_step`` step at full v4_pcg width (2 genes x 54
tissues, CRE tokenizer frozen, Adam).
Of ``--group cre``: the CRE stack's kernel chain against its plain loop at
full v4_pcg width, 4 donors x 384 and x 96 CRE slots, and the vcf2exp
forward, each with its plain version's time and the kernels a call of each
puts on the card. ``--group all`` (the default) runs ``fwd`` and ``bwd``.
``--profile`` adds each case's device time, in all and by kernel
(``torch.profiler``). Each case is first
held against its plain version (3e-2 of max(max |plain|, 1) for the
attention, its backward, the LayerNorm and its backward and the pool, one
bf16 ulp for the GEMM, 1e-3 of max |plain| for the weight gradient, 6e-2
of max |plain| for the forward's predictions and pooled embeddings; the
step's loss within 2e-2 of the plain versions'), then timed by CUDA events:
the mean of ``--iters`` calls after one warm-up. The attention cases also
print their bound (the larger of their operations at the bf16 peak and
their bytes at 3.35 TB/s) and one ``scaled_dot_product_attention`` call's
time (forward, or forward and backward through autograd).

The script uses only the entry points' and wrappers' signatures, so it can
time another tree's kernels in the same call for comparison: copy it into
that tree's ``variantformer_tpu_torch/`` and run ``python -m
variantformer_tpu_torch.kernel_bench --label parent`` from that tree's
root (a tree whose attention refuses 1024 keys skips those cases).
``--outputs DIR`` keeps the outputs of the LayerNorm, of every attention
forward case (the serving output; out, lse and out32 of the
``for_backward`` ones) and of the gene cross-attention's backward at 384
keys and at one under ``DIR/<label>/`` and prints, for each other label
already there, whether each output is the same bits and its max abs
difference. Prints the card's name and power limit, one JSON line per
case, the attention's host launches by softmax variant in the vcf2exp
forward (where the tree counts them), and a last JSON line with every
case's ms.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

# N=1536 CRE windows of 200 tokens, 8 heads of 64; 4 x 54 gene rows of 201,
# 32 heads of 48; cross K/V of 4 donors x 384 CRE slots (1024 past the
# one-chunk key limit).
N_CRE, LENGTH, D4, T, G1, C, C_LONG = 1536, 200, 4, 54, 201, 384, 1024
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM


def attn_bound_ms(lens, len_div, kv_div, b, sq, sk, heads, hd, dkv_size=None, stats=False):
    """The least time of one attention call (or, with ``dkv_size``, its
    backward) with these key counts: the larger of its products at the bf16
    peak and its bytes at the memory rate, each input read and each output
    written once (as ``chip_smoke.py`` counts them; with ``stats`` the
    forward also writes the f32 output and the log-sum-exp)."""
    keys = [min(n, sk) if n > 0 else sk for n in lens]
    e = heads * hd
    flops = 4.0 * heads * hd * sq * sum(keys[i // len_div] for i in range(b))
    kv_elems = sum(keys[(r * kv_div) // len_div] for r in range(b // kv_div)) * e
    nbytes = 2.0 * 2 * b * sq * e + 2 * 2.0 * kv_elems
    if stats:
        nbytes += 4.0 * b * sq * e + 4.0 * b * heads * sq
    if dkv_size is not None:  # + dO, the f32 output, lse; dq, dk, dv written
        flops *= 2.5
        nbytes = (2.0 * 3 * b * sq * e + 4.0 * b * sq * e + 2.0 * 2 * (b // kv_div) * sk * e
                  + dkv_size * 2.0 * (b // kv_div) * sk * e + 4.0 * b * heads * sq)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def sdpa(torch, q, k, v, kv_len, slopes, scale, heads, kv_div, len_div, do=None):
    """One ``scaled_dot_product_attention`` call on the same function (ALiBi
    and the key mask as a bf16 additive bias); with ``do``, its forward and
    backward through autograd."""
    import torch.nn.functional as F

    from variantformer_tpu_torch.ops.attention import MASK_VALUE

    b, sq, e = q.shape
    hd, sk = e // heads, k.shape[1]
    bias = torch.zeros((b, heads, sq, sk), device=q.device)
    if slopes is not None:
        pos = torch.arange(max(sq, sk), device=q.device, dtype=torch.float32)
        bias = bias - slopes[None, :, None, None] * (pos[:sq, None] - pos[None, :sk]).abs()
    valid = torch.arange(sk, device=q.device)[None, :] < kv_len.repeat_interleave(len_div)[:, None]
    bias = torch.where(valid[:, None, None, :], bias, MASK_VALUE).to(q.dtype)
    split = lambda z: z.reshape(z.shape[0], -1, heads, hd).transpose(1, 2)
    qq, kk, vv = (split(z.contiguous()) for z in (q, k, v))
    if do is None:
        return lambda: F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(kv_div, 0), vv.repeat_interleave(kv_div, 0),
            attn_mask=bias, scale=scale)
    qq, kk, vv = (z.detach().requires_grad_(True) for z in (qq, kk, vv))
    dout = split(do)

    def run():
        out = F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(kv_div, 0), vv.repeat_interleave(kv_div, 0),
            attn_mask=bias, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)

    return run


def takes_long_keys(kernels) -> bool:
    """Whether this tree's attention walks keys past the one-chunk limit."""
    return hasattr(kernels, "key_chunks")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--group", choices=("fwd", "bwd", "cre", "all"), default="all")
    parser.add_argument("--profile", action="store_true",
                        help="also print each case's device time, in all and by kernel "
                             "(torch.profiler)")
    parser.add_argument("--outputs", type=Path, default=None,
                        help="keep some cases' outputs here and compare them with other "
                             "labels' outputs kept there")
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

    def keep(name, out):
        """Saves ``out`` under --outputs and compares it with the other
        labels' outputs of the same case."""
        outs = out if isinstance(out, (tuple, list)) else (out,)
        slug = re.sub(r"[^A-Za-z0-9]+", "_", name)
        mine = args.outputs / re.sub(r"[^A-Za-z0-9]+", "_", args.label)
        mine.mkdir(parents=True, exist_ok=True)
        torch.save([o.cpu() for o in outs], mine / f"{slug}.pt")
        for other in sorted(args.outputs.iterdir()):
            if other == mine or not (other / f"{slug}.pt").exists():
                continue
            theirs = torch.load(other / f"{slug}.pt")
            for i, (a, b) in enumerate(zip(outs, theirs)):
                a = a.cpu()
                print(json.dumps({"label": args.label, "case": name, "output": i,
                                  "vs": other.name, "same_bits": bool(torch.equal(a, b)),
                                  "max_abs_diff": (a.float() - b.float()).abs().max().item()}))

    def launches(fn) -> int:
        """Kernels, copies and sets one call of ``fn`` puts on the card
        (torch.profiler's device events)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)

    def case(name, fn, plain, tol, floor=0.0, bound_ms=None, library=None, kept=False,
             with_plain=False):
        out = fn()
        rel = check(name, out, plain(), tol, floor)
        if kept and args.outputs is not None:
            keep(name, out)
        del out
        ms = time_ms(fn)
        results[name] = ms
        line = {"label": args.label, "case": name, "ms": ms, "rel_err": rel}
        if bound_ms is not None:
            line["bound_ms"] = bound_ms
        if library is not None:
            line["library_ms"] = time_ms(library)
        if with_plain:  # the plain version's time, and the kernels of a call of each
            line["plain_ms"] = time_ms(plain)
            line["launches"], line["plain_launches"] = launches(fn), launches(plain)
        if args.profile:
            us = by_kernel(fn)
            line["device_ms"] = sum(us.values()) / 1e3
            line["device_us_by_kernel"] = us
        print(json.dumps(line))

    if args.group in ("fwd", "all"):
        forward_cases(torch, kernels, randn, ints, gen, case)
    if args.group in ("bwd", "all"):
        backward_cases(torch, kernels, randn, ints, gen, case)
    if args.group == "cre":
        cre_stack_cases(torch, randn, case)
        vcf2exp_forward_case(torch, gen, case, with_plain=True)
    print(json.dumps({"label": args.label, "ms": results}))
    return 0


def forward_cases(torch, kernels, randn, ints, gen, case):
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    n_cre, length, d4, t, g1, c = N_CRE, LENGTH, D4, T, G1, C
    enc_mixed = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                              dtype=torch.int32)
    enc_mixed[:4] = ints([0, 1, 2, length])
    cre_lens, cre_full = ints([c, 300, 1, 2]), ints([c] * d4)
    # use, B, Sq, K/V rows, Sk, H, head dim, ALiBi, cross layout, kv_div, len_div,
    # mixed and full key counts
    uses = (
        ("encoder self", n_cre, length, n_cre, length, 8, 64, True, False, 1, 1,
         enc_mixed, ints([length] * n_cre)),
        ("gene self", d4 * t, g1, d4 * t, g1, 32, 48, True, False, 1, t,
         ints([201, 150, 1, 77]), ints([g1] * d4)),
        ("gene cross", d4 * t, g1, d4, c, 32, 48, False, True, t, t,
         ints([384, 300, 1, 2]), ints([c] * d4)),
        ("CRE self", d4, c, d4, c, 32, 48, True, False, 1, 1, cre_lens, cre_full),
        ("CRE cross", d4, c, d4, c, 32, 48, False, True, 1, 1, cre_lens, cre_full),
        ("encoder self hd=128", n_cre, length, n_cre, length, 4, 128, True, False, 1, 1,
         enc_mixed, ints([length] * n_cre)),
        ("gene cross C=1024", d4 * t, g1, d4, C_LONG, 32, 48, False, True, t, t,
         ints([1024, 700, 1, 512]), ints([C_LONG] * d4)),
    )
    # The uses whose for_backward outputs (out, lse, out32) are timed and kept:
    # the training forwards' calls.
    stats_uses = ("encoder self", "gene self", "gene cross")
    for use, b, sq, kv_rows, sk, heads, hd, alibi, cross, kv_div, len_div, mixed, full in uses:
        e = heads * hd
        if not cross:
            qkv = randn(b, sq, 3 * e, scale=2.0)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            kvt = randn(kv_rows, sk, 2 * e, scale=2.0)
            q, k, v = randn(b, sq, e, scale=2.0), kvt[..., :e], kvt[..., e:]
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        for suffix, lens in (("", mixed), (", full lengths", full)):
            name = f"attention {use}{suffix}"
            if sk > C and not takes_long_keys(kernels):
                print(json.dumps({"case": name, "skipped": "this tree refuses Sk > 768"}))
                continue
            a = (q, k, v, lens, slopes, hd ** -0.5, heads, kv_div, len_div)
            bound = lambda stats=False: attn_bound_ms(lens.tolist(), len_div, kv_div, b, sq, sk,
                                                      heads, hd, stats=stats)
            case(name, lambda a=a: kernels.attention(*a),
                 lambda a=a: kernels.attention_plain(*a), 3e-2, bound_ms=bound(),
                 library=sdpa(torch, *a), kept=True)
            if use in stats_uses and suffix:
                case(f"{name}, for_backward", lambda a=a: kernels.attention(*a, for_backward=True),
                     lambda a=a: kernels.attention_plain(*a, for_backward=True), 3e-2,
                     floor=1.0, bound_ms=bound(stats=True), kept=True)
        del q, k, v

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
             lambda x=x, sc=sc, bi=bi: kernels.layernorm_plain(x, sc, bi), 3e-2, floor=1.0,
             bound_ms=4.0 * rows * e / PEAK_BYTES * 1e3,
             library=lambda x=x, sc=sc, bi=bi: torch.nn.functional.layer_norm(
                 x, (e,), sc.to(x.dtype), bi.to(x.dtype), 1e-5), kept=True)
        del x
    x = randn(n_cre, length, 512)
    tok_len = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                            dtype=torch.int32)
    tok_len[:3] = ints([0, 1, length])
    case("masked_mean_pool cre-window", lambda: kernels.masked_mean_pool(x, tok_len),
         lambda: kernels.masked_mean_pool_plain(x, tok_len), 3e-2, floor=1.0)
    del x
    vcf2exp_forward_case(torch, gen, case)


def vcf2exp_forward_case(torch, gen, case, with_plain=False):
    """``seq2gene_forward`` at full v4_pcg width and depth on one batch of
    4 genes x 54 tissues (384 CRE and 200 gene windows of 200 tokens a
    gene), random weights from seed 0 and random tokens and lengths; with
    ``with_plain`` also the plain forward's time and both forwards' kernel
    counts."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward, seq2gene_forward_plain

    cfg = ModelConfig()
    d, t = D4, T
    batch = random_batch(torch, gen, cfg, d)
    params = init_seq2gene(cfg, 0, device="cuda")

    def run(fwd):
        with torch.inference_mode():
            out = fwd(params, batch, cfg)
        return out.pred_expression, out.pooled_embedding

    kernels = sys.modules["variantformer_tpu_torch.ops.kernels"]
    variants = getattr(kernels, "ATTN_VARIANTS", None)
    if variants is not None:
        kernels.reset_launches()
    case(f"vcf2exp forward, {d} genes x {t} tissues", lambda: run(seq2gene_forward),
         lambda: run(seq2gene_forward_plain), 6e-2, with_plain=with_plain)
    if variants is not None:  # the attention's host launches by softmax variant
        print(json.dumps({"case": f"vcf2exp forward, {d} genes x {t} tissues",
                          "attention_variants": {f"alibi={int(k.alibi)} stats={int(k.stats)}": n
                                                 for k, n in variants.items()}}))
    del params
    torch.cuda.empty_cache()


def cre_stack_bound_ms(d, c, e, f, layers):
    """The least time of the CRE stack's work at [d, c, e] (counted as
    ``vfx_bench/flops.least_time`` counts it): per layer and operation the
    larger of its products at the bf16 peak and its bytes at the memory
    rate, each input read and each output written once, in bf16."""
    rows, pairs = d * c, d * c * c
    ops = lambda flops, nbytes: max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    linear = lambda k, n: ops(2.0 * rows * k * n, 2.0 * (rows * k + k * n + rows * n))
    attention = ops(4.0 * pairs * e, 2.0 * e * 4 * rows)
    rowwise = lambda w_in, w_out: ops(0.0, 2.0 * rows * (w_in + w_out))
    layer = (rowwise(e, e) + linear(e, 3 * e) + attention + linear(e, e)  # self
             + rowwise(e, e) + linear(e, e) + linear(e, 2 * e) + attention + linear(e, e)  # cross
             + rowwise(e, e) + linear(e, f) + rowwise(f, f // 2) + linear(f // 2, e))  # FFN
    return layers * layer * 1e3


def cre_stack_cases(torch, randn, case):
    """The CRE stack (``ops/cre_stack.py``) at full v4_pcg width and depth,
    4 donors x 384 and x 96 CRE slots, every slot valid, random weights from
    seed 0: the kernel chain against the plain loop ``core.cre_loop``, with
    both times, both kernel counts and the least time of the work."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models import core
    from variantformer_tpu_torch.models.init import ParamInit
    from variantformer_tpu_torch.ops import cre_stack as CS
    from variantformer_tpu_torch.ops.alibi import alibi_slopes
    from variantformer_tpu_torch.ops.fused_modulator import pack_gene_layers

    dev = torch.device("cuda")
    m = ModelConfig().seq2gene
    e, heads, f, layers = m.emb_dim, m.num_heads, m.ffn_hidden_dim, m.num_layers - 1
    spec = core.AttnSpec(heads, e // heads)
    tree = ParamInit(0, dev, torch.bfloat16).context_layer_stack(layers, e, f)
    packed = pack_gene_layers(tree, heads, torch.bfloat16)
    slopes = torch.from_numpy(alibi_slopes(heads)).to(dev)
    for c in (C, 96):
        x, ctx = randn(D4, c, e), randn(D4, c, e)
        lens = torch.full((D4,), c, dtype=torch.int32, device=dev)
        loop = lambda x=x, ctx=ctx, lens=lens: core.cre_loop(tree, x, ctx, lens, slopes, spec,
                                                             x.dtype)
        with torch.inference_mode():
            case(f"cre_stack D={D4} C={c}",
                 lambda x=x, ctx=ctx, lens=lens: CS.cre_stack(x, ctx, lens, packed, slopes,
                                                              heads, spec.head_dim),
                 loop, 3e-2, floor=1.0, bound_ms=cre_stack_bound_ms(D4, c, e, f, layers),
                 with_plain=True)
        del x, ctx
    del tree, packed
    torch.cuda.empty_cache()


def random_batch(torch, gen, cfg, d):
    """A seq2gene batch of ``d`` genes (384 CRE and 200 gene windows of 200
    tokens a gene, 54 tissues) of random tokens and lengths."""
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    dev = torch.device("cuda")
    c, g, length, t = C, 200, LENGTH, T
    ints = lambda lo, hi, *s: torch.randint(lo, hi, s, generator=gen, device=dev,
                                           dtype=torch.int32)
    vocab = cfg.window_encoder.vocab_size
    return Seq2GeneBatch(
        cre_tokens=ints(0, vocab, d, c, length), cre_tok_len=ints(1, length + 1, d, c),
        cre_count=torch.full((d,), c, device=dev, dtype=torch.int32),
        cre_labels=ints(0, 9, d, c), gene_tokens=ints(0, vocab, d, g, length),
        gene_tok_len=ints(1, length + 1, d, g),
        gene_count=torch.full((d,), g, device=dev, dtype=torch.int32),
        tissue_ids=torch.arange(t, device=dev, dtype=torch.int32),
    )


def train_step_case(torch, gen, case):
    """One ``make_seq2gene_train_step`` step at full v4_pcg width and depth
    on 2 genes x 54 tissues (random weights from seed 0, random tokens and
    log1p-TPM labels), the CRE tokenizer frozen and the gene tokenizer
    trained, Adam at lr 1e-4, as ``chip_smoke.py``'s fit runs it; the first
    step's loss held against the plain versions' at the same state."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import (
        TrainState,
        make_seq2gene_train_step,
        seq2gene_loss_fn,
    )

    dev = torch.device("cuda")
    cfg = ModelConfig()
    batch = random_batch(torch, gen, cfg, 2)
    targets = torch.rand((2, T), generator=gen, device=dev) * 5.0
    mask = torch.ones((2, T), dtype=torch.bool, device=dev)
    params = init_seq2gene(cfg, 0, device="cuda")
    opt = make_optimizer(params, learning_rate=1e-4, train_gene_tokenizer=True)
    step = make_seq2gene_train_step(cfg, opt, freeze_tokenizers=True, train_gene_tokenizer=True)
    with torch.no_grad():
        plain_loss = seq2gene_loss_fn(params, batch, targets, mask, cfg, stop_cre_grads=True,
                                      plain=True)
    state = TrainState(params, opt, 0)
    case(f"seq2gene train step, 2 genes x {T} tissues",
         lambda: step(state, batch, targets, mask)[1], lambda: plain_loss, 2e-2)
    del params, opt, state
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
        # the training step's 2 genes
        ("gene cross C=1024", 2 * t, g1, 2, C_LONG, 32, 48, False, t, t, ints([1024, 700])),
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
        do = randn(b, sq, e)
        if sk > C and not takes_long_keys(kernels):  # the same draws as a tree that takes it
            print(json.dumps({"case": f"attention_bwd {use}",
                              "skipped": "this tree refuses Sk > 576"}))
            continue
        _, lse, o = kernels.attention(q, k, v, lens, slopes, hd ** -0.5, heads, kv_div, len_div,
                                      for_backward=True)
        a = (q, k, v, o, lse, do, lens, slopes, hd ** -0.5, heads, kv_div, len_div)
        # the cotangents' buffers as the training path hands them over
        if kv_div == 1:
            dqkv = torch.empty((b, sq, 3 * e), dtype=torch.bfloat16, device=dev)
            out = dict(dq=dqkv[..., :e], dk=dqkv[..., e:2 * e], dv=dqkv[..., 2 * e:])
        else:
            dkv = torch.empty((kv_rows, sk, 2 * e), dtype=torch.float32, device=dev)
            out = dict(dk=dkv[..., :e], dv=dkv[..., e:])
        case(f"attention_bwd {use}", lambda a=a, out=out: kernels.attention_bwd(*a, **out),
             lambda a=a: kernels.attention_bwd_plain(*a), 3e-2, floor=1.0,
             bound_ms=attn_bound_ms(lens.tolist(), len_div, kv_div, b, sq, sk, heads, hd,
                                    2 if kv_div == 1 else 4),
             library=sdpa(torch, q, k, v, lens, slopes, hd ** -0.5, heads, kv_div, len_div,
                          do=a[5]),
             kept=use in ("gene cross C=384", "gene cross C=1"))
        del a, q, k, v, o, lse, do, out
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
    # The weight gradients whose rows the plan splits, at a training step's
    # shapes (2 genes: 2 x 54 x 201 gene rows; 400 x 200 gene-window
    # tokens), and the unsplit gene qkv, into a non-zero buffer.
    for label, n_rows, k, n in (("gene qkv", 2 * t * g1, 1536, 4608),
                                ("gene out-proj", 2 * t * g1, 1536, 1536),
                                ("gene ffn_in", 2 * t * g1, 1536, 2048),
                                ("gene ffn_out", 2 * t * g1, 1024, 1536),
                                ("encoder out-proj", n_gene * length, 512, 512),
                                ("encoder ffn_out", n_gene * length, 1024, 512)):
        x, dy = randn(n_rows, k), randn(n_rows, n)
        acc = torch.randn((k, n), generator=gen, device=dev)
        want = kernels.gemm_wgrad_plain(x, dy, out=acc.clone())
        plan = kernels.gemm_plan(k, n, n_rows, split=True)
        case(f"gemm_wgrad {label} R={n_rows} K={k} N={n}, {plan.splits} splits",
             lambda x=x, dy=dy, acc=acc: kernels.gemm_wgrad(x, dy, out=acc),
             lambda want=want: want, 1e-3,
             bound_ms=max(2.0 * n_rows * k * n / PEAK_BF16_FLOPS,
                          (2.0 * n_rows * (k + n) + 8.0 * k * n) / PEAK_BYTES) * 1e3)
        del x, dy, acc, want
    train_step_case(torch, gen, case)


if __name__ == "__main__":
    sys.exit(main())
