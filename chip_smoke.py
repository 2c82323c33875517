#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (``python3 chip_smoke.py``).

1. Prints the card's name and power limit and builds the CUDA kernels from
   ``variantformer_tpu_torch/csrc`` with nvcc for sm_90a; where
   ``cuobjdump`` is present, counts the ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA load) instructions of the built GEMM and probe libraries.
2. Runs the capability probes (``python -m variantformer_tpu_torch.probes``
   on the card, counting their kernels' launches) and holds each probe
   kernel against its plain version; then holds the TMA + wgmma GEMM
   (``gemm_bf16``, ``gemm_wgrad``) on one tile, 2 x 2 tiles, ragged edges
   and split rows into a non-zero buffer before anything is timed; here and
   at the main-path shapes ``gemm_bf16`` within one bf16 ulp of max |plain|
   and ``gemm_wgrad`` within 1e-3 of it.
3. Holds every kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (bf16): each shared forward kernel alone, the
   whole window-encoder stack (E=512, 8 layers, L=200, ragged tok_len with
   0 and 1) and the whole gene stack (E=1536, 25 layers, T=54, G1=201 and a
   short G1, C=384 and C=1) within 3e-2 of max |plain|; then each backward
   kernel alone (transposed GEMMs, attention backward for the gene self-
   and cross-attention and the encoder, layernorm/geglu/pool backward,
   column sums), and the whole-stack backwards (#3 encoder, #5 + #6 gene
   stack, by rel L2 < 5e-2 per gradient against torch autograd of the plain
   stacks, with exact zeros on pad rows and masked CRE slots). Each is timed
   beside its plain version and, where one PyTorch call computes the same
   function, that call; the redesigned GEMMs also print the time their
   ``wmma`` predecessor recorded in ``PERF.md``.
4. Writes a synthetic genome (one 1.5 Mb chr1, 4 genes with full 300 kb
   windows, 384 CREs each, a donor VCF of SNPs) and runs
   ``VCFProcessor(device="cuda").predict`` for 4 genes x 54 tissues at full
   v4_pcg width with random weights from a seed, counting the kernels'
   launches; then holds the same batch through the plain versions on the
   card at 5e-2 (pred) / 6e-2 (embeddings) of max |plain|, and profiles one
   forward by kernel.
5. Trains at full v4_pcg width and depth through the normal entry points:
   ``TrainingShardWriter`` shards for the 4 genes (1 donor, 54 log1p-TPM
   labels from the seed), ``make_optimizer`` (Adam, lr 1e-4, gene tokenizer
   trained, CRE tokenizer frozen), ``make_seq2gene_train_step`` and ``fit``
   for 2 epochs of 2 steps over batches of 2 genes, with checkpoints and
   ``load_train_state``; counts every kernel's launches, requires finite
   losses, moved parameters and a bit-identical CRE tokenizer; times and
   profiles one step; and holds one step's gradients at 1 gene x 54 tissues
   against the plain versions (rel L2 < 5e-2 per leaf), from the initial
   state and after the fit.
6. Prints a ``{"kernels": [...]}`` line, then the device line last.

Exits non-zero, before any result, when there is no CUDA device; any
failed phase raises.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
STACK_TOL = 3e-2
GEMM_TOL = 2.0 ** -7  # gemm_bf16 and the bf16 product probe: one bf16 ulp of max |plain|
WGRAD_TOL = 1e-3      # gemm_wgrad, f32 sums in another order
PRED_TOL, EMB_TOL = 5e-2, 6e-2
SEED = 0
ITERS = 5  # timed calls per kernel measurement, after one warm-up


def bound_ms(flops: float, nbytes: float, flops_peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / flops_peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, name, out, ref, tol, valid=None, floor=0.0):
    """max |out - ref| must stay within tol * max(max |ref|, floor) (over
    ``valid``); ``floor`` is the scale of an output that is 0 in exact
    arithmetic (a single key's dQ) and only rounding noise here."""
    o, r = out.float(), ref.float()
    if valid is not None:
        o, r = o[valid], r[valid]
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (o - r).abs().max().item()
    scale = r.abs().max().item()
    rel = err / max(scale, floor, 1e-30)
    print(f"check {name}: max_abs_err={err:.6g} max|plain|={scale:.6g} "
          f"rel={rel:.6g} tol={tol}")
    if not rel <= tol:
        raise AssertionError(f"{name}: rel error {rel:.4g} > {tol}")
    return err


class Checks:
    """Runs each kernel against its plain version and keeps one record per
    ported kernel for the final ``kernels`` line."""

    def __init__(self, torch, iters: int):
        self.torch = torch
        self.iters = iters
        self.records: dict[str, dict] = {}

    def run(self, name, kernel_fn, plain_fn, library_fn, flops, nbytes, tol=STACK_TOL,
            valid=None, record=None, flops_peak=PEAK_BF16_FLOPS, meta=None, zeros=None,
            floor=0.0):
        torch = self.torch
        out = kernel_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        if isinstance(out, (tuple, list)):
            err = max(compare(torch, f"{name} [{i}]", o, r, tol, valid, floor)
                      for i, (o, r) in enumerate(zip(out, ref)))
        else:
            err = compare(torch, name, out, ref, tol, valid, floor)
        if zeros is not None:
            zeros(out)
        del out, ref
        ms = time_ms(torch, kernel_fn, self.iters)
        plain_ms = time_ms(torch, plain_fn, self.iters)
        lib_ms = time_ms(torch, library_fn, self.iters) if library_fn else None
        b_ms, b_by = bound_ms(flops, nbytes, flops_peak)
        rec = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
        }
        print(f"time {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms} "
              f"bound_ms={b_ms:.4f} ({b_by}) flops={flops:.4g} bytes={nbytes:.4g}")
        if record is not None:
            self.records[record] = {**(meta or {}), **rec}
        return rec


def attn_cost(lens, len_div, kv_div, b, sq, sk, heads, hd):
    """Operations and bytes of one attention call with this run's lengths:
    query row i reads the keys before kv_len[i // len_div] (all Sk when 0),
    K/V row r serves query rows r*kv_div .. r*kv_div + kv_div - 1."""
    keys = [min(n, sk) if n > 0 else sk for n in lens]
    e = heads * hd
    flops = 4.0 * heads * hd * sq * sum(keys[i // len_div] for i in range(b))
    kv_bytes = 2 * 2.0 * e * sum(keys[(r * kv_div) // len_div] for r in range(b // kv_div))
    return flops, 2.0 * 2 * b * sq * e + kv_bytes


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# The times of the wmma GEMM that gemm_sm90.cu replaced, as PERF.md records
# them (an NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's as
# text; the shapes it did not record read "not recorded".
WMMA_GEMM_MS = {
    "gemm_bf16 gene qkv": 3.1149,
    "gemm_wgrad gene qkv": 3.9788,
    "gemm_wgrad encoder qkv, 80000 rows, into a buffer": 0.9883,
}


def print_vs_wmma(name: str, rec: dict) -> None:
    old = WMMA_GEMM_MS.get(name)
    print(f"gemm vs wmma {name}: {rec['ms']:.4f} ms now; the wmma kernel (PERF.md): "
          + (f"{old} ms" if old else "not recorded"))


def probe_path(torch) -> dict:
    """The capability probes through their entry point on the card
    (``variantformer_tpu_torch.probes.main``); returns the launch counts."""
    from variantformer_tpu_torch import probes
    from variantformer_tpu_torch.ops import kernels

    kernels.reset_launches()
    rc = probes.main([])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"capability probes: exit code {rc}")
    for name in PROBE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched by the probes")
    print(f"probe launches {json.dumps({k: launches[k] for k in PROBE_KERNELS})}")
    return launches


def probe_checks(torch, checks: "Checks") -> None:
    """Each probe kernel against its plain version on the probes' inputs:
    exact for the f32 slices and the head sum, within one bf16 ulp of the
    largest value for the wgmma product."""
    from variantformer_tpu_torch import probes
    from variantformer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    x = probes.probe_input((16, 192), torch.float32, dev)
    scale = torch.arange(1, 5, dtype=x.dtype, device=dev).repeat_interleave(48)
    meta = {"shape": "[16,192] f32"}
    checks.run("probe_48slice", lambda: kernels.probe_48slice(x),
               lambda: kernels.probe_48slice_plain(x), lambda: torch.mul(x, scale),
               float(x.numel()), 2 * 4.0 * x.numel(), tol=0.0, record="probe_48slice",
               flops_peak=PEAK_F32_FLOPS, meta=meta)
    checks.run("probe_3dreshape", lambda: kernels.probe_3dreshape(x),
               lambda: kernels.probe_3dreshape_plain(x), lambda: torch.sum(x.view(16, 4, 48), 1),
               3.0 * 16 * 48, 4.0 * (x.numel() + 16 * 48), tol=0.0, record="probe_3dreshape",
               flops_peak=PEAK_F32_FLOPS, meta={"shape": "[16,192] -> [16,48] f32"})
    xb = probes.probe_input((32, 192), torch.bfloat16, dev)
    checks.run("probe_48slice_bf16_matmul", lambda: kernels.probe_48slice_bf16_matmul(xb),
               lambda: kernels.probe_48slice_bf16_matmul_plain(xb),
               lambda: torch.einsum("rhd,chd->rhc", xb.view(32, 4, 48),
                                    xb[:16].view(16, 4, 48)).reshape(32, 64),
               4 * 2.0 * 32 * 16 * 48, 2.0 * (xb.numel() + 32 * 64), tol=GEMM_TOL,
               record="probe_48slice_bf16_matmul",
               meta={"shape": "[32,192] -> [32,64] bf16, 4 heads of 48"})


def gemm_unit_checks(torch) -> None:
    """The TMA + wgmma GEMM before anything is timed: each layout on one
    tile, on 2 x 2 tiles, with ragged M, N and K, and the weight gradient
    with its rows split, added into a non-zero buffer."""
    from variantformer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(torch.bfloat16)
    # tiles of 128 x 256: one tile, 2 x 2 tiles, ragged M, N and K, a part tile
    for m, k, n in ((128, 64, 256), (256, 128, 512), (200, 72, 264), (128, 64, 128),
                    (256, 128, 1024), (136, 64, 776), (1000, 512, 1536)):
        a, w, bias, res = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n), randn(m, n)
        for r in (None, res):
            compare(torch, f"gemm_bf16 M={m} K={k} N={n}{' +res' if r is not None else ''} "
                    f"{kernels.gemm_plan(m, n, k)}", kernels.gemm(a, w, bias, r),
                    kernels.gemm_plain(a, w, bias, r), GEMM_TOL)
    for rows, k, n in ((64, 128, 128), (128, 256, 512), (200, 136, 264), (64, 128, 1024),
                       (200, 264, 1544), (20000, 256, 1536)):
        x, dy = randn(rows, k), randn(rows, n)
        acc = torch.randn((k, n), generator=gen, device=dev)
        plan = kernels.gemm_plan(k, n, rows, split=True)
        compare(torch, f"gemm_wgrad R={rows} K={k} N={n} into a buffer {plan}",
                kernels.gemm_wgrad(x, dy, out=acc.clone()),
                kernels.gemm_wgrad_plain(x, dy, out=acc.clone()), WGRAD_TOL)
    require(plan.splits > 1, "the last wgrad unit check must split its rows")


def sass_counts(lib_dir: str) -> None:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the built GEMM
    and probe libraries, where the toolkit has cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found; instruction counts skipped")
        return
    for lib, need in (("gemm_sm90.so", ("HGMMA", "UTMALDG")), ("probes.so", ("HGMMA",))):
        sass = subprocess.run([tool, "-sass", str(Path(lib_dir) / lib)], check=True,
                              capture_output=True, text=True).stdout
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in ("HGMMA", "UTMALDG", "HMMA")}
        print(f"sass {lib}: {json.dumps(counts)}")
        for op in need:
            require(counts[op] > 0, f"{lib}: no {op} instruction")


def kernel_checks(torch, checks: Checks) -> None:
    import torch.nn.functional as F

    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes
    from variantformer_tpu_torch.ops.attention import MASK_VALUE
    from variantformer_tpu_torch.ops.fused_encoder import (
        fused_window_encoder,
        fused_window_encoder_plain,
        pack_encoder_layers,
    )
    from variantformer_tpu_torch.ops.fused_modulator import (
        fused_gene_modulator,
        fused_gene_modulator_plain,
        pack_gene_layers,
    )
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import ParamInit

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(bf)
    cfg = ModelConfig()
    we, mc = cfg.window_encoder, cfg.seq2gene
    e_enc, e_mod, ffn = we.embedding_dim, mc.emb_dim, mc.ffn_hidden_dim

    # Main-path shapes of the 4-gene batch: CRE windows 4 x 384, gene
    # windows 4 x 200, L = 200; gene rows 4 x 54 x 201.
    n_cre, length = 4 * 384, 200
    rows_enc = n_cre * length
    d4, t, g1, c = 4, 54, 201, 384
    rows_mod = d4 * t * g1

    # --- gemm_bf16 ---------------------------------------------------------
    def gemm_case(name, m, k, n, residual, record=None):
        a = randn(m, k)
        w = randn(k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1)
        res = randn(m, n) if residual else None
        lib = (lambda: torch.addmm(bias, a, w)) if not residual else None
        nbytes = 2.0 * (m * k + k * n + m * n + n + (m * n if residual else 0))
        rec = checks.run(
            name, lambda: kernels.gemm(a, w, bias, res),
            lambda: kernels.gemm_plain(a, w, bias, res), lib, 2.0 * m * n * k, nbytes,
            tol=GEMM_TOL, record=record,
            meta={"shape": f"[{m},{k}]x[{k},{n}]" + (" +res" if residual else "")},
        )
        print_vs_wmma(name, rec)

    gemm_case("gemm_bf16 gene qkv", rows_mod, e_mod, 3 * e_mod, False, record="gemm_bf16")
    gemm_case("gemm_bf16 gene ffn_out+res", rows_mod, ffn // 2, e_mod, True)
    gemm_case("gemm_bf16 cre-window ffn_in", rows_enc, e_enc, 2048, False)
    gemm_case("gemm_bf16 ragged M", 333 * 200 + 7, e_enc, 3 * e_enc, True)

    # --- layernorm -----------------------------------------------------------
    for name, rows, e, rec in (("layernorm gene", rows_mod, e_mod, "layernorm"),
                               ("layernorm cre-window", rows_enc, e_enc, None)):
        x = randn(rows, e, scale=3.0)
        sc = torch.rand(e, generator=gen, device=dev) + 0.5
        bi = torch.randn(e, generator=gen, device=dev) * 0.1
        checks.run(
            name, lambda: kernels.layernorm(x, sc, bi),
            lambda: kernels.layernorm_plain(x, sc, bi),
            lambda: F.layer_norm(x, (e,), sc.to(bf), bi.to(bf), 1e-5),
            8.0 * rows * e, 2.0 * 2 * rows * e + 8.0 * e, record=rec,
            flops_peak=PEAK_F32_FLOPS, meta={"shape": f"[{rows},{e}]"},
        )
        del x

    # --- geglu ---------------------------------------------------------------
    f = randn(rows_mod, ffn, scale=2.0)
    checks.run(
        "geglu gene", lambda: kernels.geglu(f), lambda: kernels.geglu_plain(f), None,
        30.0 * rows_mod * ffn / 2, 2.0 * (rows_mod * ffn + rows_mod * ffn / 2),
        record="geglu", flops_peak=PEAK_F32_FLOPS, meta={"shape": f"[{rows_mod},{ffn}]"},
    )
    del f

    # --- masked_mean_pool ----------------------------------------------------
    x = randn(n_cre, length, e_enc)
    tok_len = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                            dtype=torch.int32)
    tok_len[:3] = torch.tensor([0, 1, length], device=dev, dtype=torch.int32)
    checks.run(
        "masked_mean_pool cre-window", lambda: kernels.masked_mean_pool(x, tok_len),
        lambda: kernels.masked_mean_pool_plain(x, tok_len), None,
        float(tok_len.sum().item()) * e_enc,
        2.0 * (float(tok_len.sum().item()) * e_enc + n_cre * e_enc),
        record="masked_mean_pool", flops_peak=PEAK_F32_FLOPS,
        meta={"shape": f"[{n_cre},{length},{e_enc}]"},
    )
    del x

    # --- attention (three uses) ---------------------------------------------
    def sdpa(q, k, v, kv_len, slopes, scale, heads, kv_div, len_div):
        """One PyTorch call on the same function (float ALiBi + mask bias)."""
        b, sq, hd_all = q.shape
        hd = hd_all // heads
        kk = k.repeat_interleave(kv_div, 0)
        vv = v.repeat_interleave(kv_div, 0)
        sk = kk.shape[1]
        lens = kv_len.repeat_interleave(len_div)
        bias = torch.zeros((b, heads, sq, sk), device=dev, dtype=torch.float32)
        if slopes is not None:
            pos = torch.arange(max(sq, sk), device=dev, dtype=torch.float32)
            dist = (pos[:sq, None] - pos[None, :sk]).abs()
            bias = bias - slopes[None, :, None, None] * dist
        valid = torch.arange(sk, device=dev)[None, :] < lens[:, None]
        bias = torch.where(valid[:, None, None, :], bias, MASK_VALUE).to(bf)
        split = lambda z: z.reshape(b, -1, heads, hd).transpose(1, 2)
        qq, kk, vv = split(q), split(kk), split(vv)
        return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias, scale=scale)

    def attn_case(name, b, sq, kv_rows, sk, heads, hd, kv_len, alibi, kv_div, len_div,
                  record=None):
        e = heads * hd
        if kv_div == 1:
            qkv = randn(b, sq, 3 * e, scale=2.0)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            q = randn(b, sq, e, scale=2.0)
            kvt = randn(kv_rows, sk, 2 * e, scale=2.0)
            k, v = kvt[..., :e], kvt[..., e:]
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        scale = hd ** -0.5
        args = (q, k, v, kv_len, slopes, scale, heads, kv_div, len_div)
        flops, nbytes = attn_cost(kv_len.tolist(), len_div, kv_div, b, sq, sk, heads, hd)
        checks.run(
            name, lambda: kernels.attention(*args), lambda: kernels.attention_plain(*args),
            sdpa(*args), flops, nbytes, record=record,
            meta={"shape": f"B={b} H={heads} Sq={sq} Sk={sk} hd={hd}"},
        )

    enc_len = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                            dtype=torch.int32)
    enc_len[:4] = torch.tensor([0, 1, 2, length], device=dev, dtype=torch.int32)
    attn_case("attention encoder self", n_cre, length, n_cre, length, we.num_heads,
              e_enc // we.num_heads, enc_len, True, 1, 1)
    gene_len = torch.tensor([201, 150, 1, 77], device=dev, dtype=torch.int32)
    attn_case("attention gene self", d4 * t, g1, d4 * t, g1, mc.num_heads,
              e_mod // mc.num_heads, gene_len, True, 1, t, record="attention")
    cre_len = torch.tensor([384, 300, 1, 2], device=dev, dtype=torch.int32)
    attn_case("attention gene cross", d4 * t, g1, d4, c, mc.num_heads,
              e_mod // mc.num_heads, cre_len, False, t, t)

    # --- window-encoder stack (K1) -------------------------------------------
    ini = ParamInit(SEED + 1, dev, torch.float32)
    enc_layers = ini.plain_layer_stack(we.num_layers, e_enc, we.ffn_hidden_dim)
    enc_packed = pack_encoder_layers(enc_layers, we.num_heads, bf)
    enc_slopes = torch.from_numpy(alibi_slopes(we.num_heads)).to(dev)
    enc_w_bytes = sum(v.numel() * v.element_size() for v in enc_packed.values())

    def encoder_case(name, n, record=None):
        x = randn(n, length, e_enc)
        lens = torch.randint(1, length + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        lens[:3] = torch.tensor([0, 1, length], device=dev, dtype=torch.int32)
        args = (x, lens, enc_packed, enc_slopes, (e_enc // we.num_heads) ** -0.5, we.num_heads)
        rows = n * length
        gemm_flops = 2.0 * rows * (e_enc * 3 * e_enc + e_enc * e_enc
                                   + e_enc * we.ffn_hidden_dim + we.ffn_hidden_dim // 2 * e_enc)
        a_flops, _ = attn_cost(lens.tolist(), 1, 1, n, length, length, we.num_heads,
                               e_enc // we.num_heads)
        flops = we.num_layers * (gemm_flops + a_flops)
        nbytes = 2.0 * (rows * e_enc + n * e_enc) + 4.0 * n + enc_w_bytes
        checks.run(
            name, lambda: fused_window_encoder(*args), lambda: fused_window_encoder_plain(*args),
            None, flops, nbytes, record=record,
            meta={"shape": f"N={n} L={length} E={e_enc} layers={we.num_layers}"},
        )

    encoder_case("fused_window_encoder ragged N=333", 333)
    encoder_case("fused_window_encoder cre windows N=1536", n_cre, record="fused_window_encoder")

    # --- gene stack (K2) ------------------------------------------------------
    mod_layers = ini.context_layer_stack(mc.num_layers, e_mod, ffn)
    mod_packed = pack_gene_layers(mod_layers, mc.num_heads, bf)
    del mod_layers
    mod_slopes = torch.from_numpy(alibi_slopes(mc.num_heads)).to(dev)
    mod_w_bytes = sum(v.numel() * v.element_size() for v in mod_packed.values())
    hd = e_mod // mc.num_heads

    def modulator_case(name, d, g1_, c_, gene_lens, cre_lens, record=None):
        gene_stream = randn(d, t, g1_, e_mod)
        cre = randn(mc.num_layers, d, c_, e_mod)
        gl = torch.tensor(gene_lens, device=dev, dtype=torch.int32)
        cl = torch.tensor(cre_lens, device=dev, dtype=torch.int32)
        args = (gene_stream, cre, gl, cl, mod_packed, mod_slopes, hd ** -0.5, mc.num_heads)
        rows = d * t * g1_
        gemm_flops = 2.0 * rows * (e_mod * 3 * e_mod + 3 * e_mod * e_mod
                                   + e_mod * ffn + ffn // 2 * e_mod)
        ckv_flops = 2.0 * d * c_ * e_mod * 2 * e_mod
        sa, _ = attn_cost(gene_lens, t, 1, d * t, g1_, g1_, mc.num_heads, hd)
        ca, _ = attn_cost(cre_lens, t, t, d * t, g1_, c_, mc.num_heads, hd)
        flops = mc.num_layers * (gemm_flops + ckv_flops + sa + ca)
        nbytes = 2.0 * (2 * rows * e_mod + mc.num_layers * d * c_ * e_mod) + mod_w_bytes
        valid = torch.zeros((d, t, g1_), dtype=torch.bool, device=dev)
        for i, n in enumerate(gene_lens):
            valid[i, :, :n] = True
        checks.run(
            name, lambda: fused_gene_modulator(*args), lambda: fused_gene_modulator_plain(*args),
            None, flops, nbytes, valid=valid, record=record,
            meta={"shape": f"D={d} T={t} G1={g1_} C={c_} E={e_mod} layers={mc.num_layers}"},
        )

    modulator_case("fused_gene_modulator D=2 G1=201 C=384", 2, g1, c, [201, 120], [384, 1])
    modulator_case("fused_gene_modulator D=2 short G1=37 C=1", 2, 37, 1, [37, 5], [1, 1])
    modulator_case("fused_gene_modulator main path D=4", d4, g1, c, [201, 201, 150, 201],
                   [384, 384, 300, 384], record="fused_gene_modulator")


GRAD_TOL = 5e-2  # rel L2 per gradient leaf: the JAX package's bound for its bf16 Pallas backward


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def compare_grads(torch, name, got: dict, want: dict, tol=GRAD_TOL, floors=None) -> float:
    """Every gradient within rel L2 ``tol`` of its yardstick; returns the
    largest absolute difference. ``floors`` maps a gradient that is 0 in
    exact arithmetic (both sides are rounding noise) to the key of a live
    gradient of the same kind whose norm scales its error instead."""
    floors = floors or {}
    worst, err = 0.0, 0.0
    for key, w in want.items():
        g = got[key]
        require(g is not None and torch.isfinite(g).all(), f"{name} {key}: missing or non-finite")
        r = rel_l2(g, w)
        if key in floors:
            r = ((g.float() - w.float()).norm() / want[floors[key]].float().norm()).item()
        worst = max(worst, r)
        err = max(err, (g.float() - w.float()).abs().max().item())
        require(r < tol, f"{name} {key}: rel L2 {r:.4g} >= {tol}")
    print(f"check {name}: {len(want)} gradients, worst rel L2 {worst:.6g} (tol {tol}), "
          f"max_abs_err {err:.6g}")
    return err


def require_zero(t, name: str) -> None:
    peak = t.float().abs().max().item() if t.numel() else 0.0
    require(peak == 0.0, f"{name}: {peak} where exactly 0 is required")


def attn_bwd_cost(lens, len_div, kv_div, b, sq, sk, heads, hd):
    """Backward of one attention call: the score and dP products, dV, dQ
    and dK (five products where the forward has two); bytes: q, k, v, o,
    dO and the log-sum-exp read once, dq, dk, dv written once."""
    flops, _ = attn_cost(lens, len_div, kv_div, b, sq, sk, heads, hd)
    e = heads * hd
    nbytes = 2.0 * (4 * b * sq * e + 4 * (b // kv_div) * sk * e) + 4.0 * b * heads * sq
    return 2.5 * flops, nbytes


def backward_checks(torch, checks: Checks) -> None:
    """The backward kernels of the training path against their plain
    versions at main-path shapes, then the whole-stack backwards (#3, #4,
    #5 + #6) against torch autograd of the plain stacks."""
    import torch.nn.functional as F

    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import ParamInit
    from variantformer_tpu_torch.ops import fused_encoder as FE
    from variantformer_tpu_torch.ops import fused_modulator as FM
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes
    from variantformer_tpu_torch.ops.attention import MASK_VALUE

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(bf)
    cfg = ModelConfig()
    we, mc = cfg.window_encoder, cfg.seq2gene
    e_enc, e_mod, ffn = we.embedding_dim, mc.emb_dim, mc.ffn_hidden_dim
    hd_enc, hd_mod = e_enc // we.num_heads, e_mod // mc.num_heads
    # Training shapes: a batch of 2 genes is 400 gene windows of L = 200 in
    # the gene tokenizer; the kernel checks take the 4-gene rows of the
    # serving batch, 4 x 54 x 201 = 43416, the largest the gene stack sees.
    n_gene, length = 400, 200
    d4, t, g1, c = 4, 54, 201, 384
    rows = d4 * t * g1

    # --- gemm_dgrad, gemm_wgrad ---------------------------------------------
    x = randn(rows, e_mod)
    dy = randn(rows, 3 * e_mod)
    w = randn(e_mod, 3 * e_mod, scale=e_mod ** -0.5)
    res = randn(rows, e_mod)
    flops = 2.0 * rows * e_mod * 3 * e_mod
    checks.run(
        "gemm_dgrad gene qkv", lambda: kernels.gemm_dgrad(dy, w, res),
        lambda: kernels.gemm_dgrad_plain(dy, w, res), lambda: torch.addmm(res, dy, w.t()),
        flops, 2.0 * (rows * 3 * e_mod + e_mod * 3 * e_mod + 2 * rows * e_mod),
        record="gemm_dgrad", meta={"shape": f"[{rows},{3 * e_mod}]x[{e_mod},{3 * e_mod}]^T +res"},
    )
    wgrad_bytes = 2.0 * (rows * e_mod + rows * 3 * e_mod) + 4.0 * e_mod * 3 * e_mod
    rec = checks.run(
        "gemm_wgrad gene qkv", lambda: kernels.gemm_wgrad(x, dy),
        lambda: kernels.gemm_wgrad_plain(x, dy), lambda: torch.matmul(x.t(), dy),
        flops, wgrad_bytes, tol=WGRAD_TOL,
        record="gemm_wgrad", meta={"shape": f"[{rows},{e_mod}]^Tx[{rows},{3 * e_mod}] f32 out"},
    )
    print_vs_wmma("gemm_wgrad gene qkv", rec)
    acc = torch.randn((e_mod, 3 * e_mod), generator=gen, device=dev)
    rec = checks.run(
        "gemm_wgrad gene qkv, into a buffer",
        lambda: kernels.gemm_wgrad(x, dy, out=acc.clone()),
        lambda: kernels.gemm_wgrad_plain(x, dy, out=acc.clone()), None,
        flops, wgrad_bytes + 4.0 * e_mod * 3 * e_mod, tol=WGRAD_TOL,
    )
    print_vs_wmma("gemm_wgrad gene qkv, into a buffer", rec)
    del dy, w, res, acc
    xe, dye = randn(n_gene * length, e_enc), randn(n_gene * length, 3 * e_enc)
    acc = torch.randn((e_enc, 3 * e_enc), generator=gen, device=dev)
    name = "gemm_wgrad encoder qkv, 80000 rows, into a buffer"
    rec = checks.run(
        name, lambda: kernels.gemm_wgrad(xe, dye, out=acc.clone()),
        lambda: kernels.gemm_wgrad_plain(xe, dye, out=acc.clone()), None,
        2.0 * n_gene * length * e_enc * 3 * e_enc,
        2.0 * n_gene * length * 4 * e_enc + 8.0 * e_enc * 3 * e_enc, tol=WGRAD_TOL,
    )
    require(kernels.gemm_plan(e_enc, 3 * e_enc, n_gene * length, split=True).splits > 1,
            f"{name}: the rows are not split")
    print_vs_wmma(name, rec)
    dm = randn(333 * 200 + 7, 2 * e_enc)
    we1 = randn(e_enc, 2 * e_enc, scale=e_enc ** -0.5)
    checks.run(
        "gemm_dgrad ragged M", lambda: kernels.gemm_dgrad(dm, we1),
        lambda: kernels.gemm_dgrad_plain(dm, we1), None,
        2.0 * dm.shape[0] * e_enc * 2 * e_enc, 2.0 * dm.shape[0] * 3 * e_enc,
    )
    del xe, dye, acc, dm

    # --- attention_bwd (three uses) ------------------------------------------
    def sdpa_fwd_bwd(q, k, v, do, kv_len, slopes, scale, heads, kv_div, len_div):
        """SDPA forward + backward through autograd: one PyTorch call each way."""
        b, sq, e = q.shape
        hd = e // heads
        sk = k.shape[1]
        lens = kv_len.repeat_interleave(len_div)
        bias = torch.zeros((b, heads, sq, sk), device=dev, dtype=torch.float32)
        if slopes is not None:
            pos = torch.arange(max(sq, sk), device=dev, dtype=torch.float32)
            bias = bias - slopes[None, :, None, None] * (pos[:sq, None] - pos[None, :sk]).abs()
        valid = torch.arange(sk, device=dev)[None, :] < lens[:, None]
        bias = torch.where(valid[:, None, None, :], bias, MASK_VALUE).to(bf)
        split = lambda z: z.reshape(z.shape[0], -1, heads, hd).transpose(1, 2)
        qq, kk, vv = (split(z.contiguous()).detach().requires_grad_(True) for z in (q, k, v))
        dout = split(do)

        def run():
            out = F.scaled_dot_product_attention(
                qq, kk.repeat_interleave(kv_div, 0), vv.repeat_interleave(kv_div, 0),
                attn_mask=bias, scale=scale)
            return torch.autograd.grad(out, (qq, kk, vv), dout)

        return run

    def attn_bwd_case(name, b, sq, kv_rows, sk, heads, hd, lens, alibi, kv_div, len_div,
                      record=None):
        e = heads * hd
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        if kv_div == 1:
            qkv = randn(b, sq, 3 * e, scale=2.0)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            q = randn(b, sq, e, scale=2.0)
            kvt = randn(kv_rows, sk, 2 * e, scale=2.0)
            k, v = kvt[..., :e], kvt[..., e:]
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        scale = hd ** -0.5
        _, lse, o = kernels.attention(q, k, v, kv_len, slopes, scale, heads, kv_div, len_div,
                                      for_backward=True)
        do = randn(b, sq, e)
        args = (q, k, v, o, lse, do, kv_len, slopes, scale, heads, kv_div, len_div)
        # keys past a K/V row's length get exactly zero dK, dV (rows with no
        # valid key average V, so only their dK is zero)
        kv_lens = [[lens[(r * kv_div + j) // len_div] for j in range(kv_div)]
                   for r in range(kv_rows)]

        def zeros(out):
            _, dk, dv = out
            for r, group in enumerate(kv_lens):
                if min(group) > 0:
                    require_zero(dk[r, max(group):], f"{name} dk past kv_len, row {r}")
                    require_zero(dv[r, max(group):], f"{name} dv past kv_len, row {r}")
                elif max(group) == 0:
                    require_zero(dk[r], f"{name} dk of a row with no valid key, row {r}")

        flops, nbytes = attn_bwd_cost(lens, len_div, kv_div, b, sq, sk, heads, hd)
        checks.run(
            name, lambda: kernels.attention_bwd(*args), lambda: kernels.attention_bwd_plain(*args),
            sdpa_fwd_bwd(q, k, v, do, kv_len, slopes, scale, heads, kv_div, len_div),
            flops, nbytes, record=record, zeros=zeros, floor=1.0,
            meta={"shape": f"B={b} H={heads} Sq={sq} Sk={sk} hd={hd} kv_div={kv_div}"},
        )

    gl4 = [201, 150, 1, 77]
    attn_bwd_case("attention_bwd gene self", d4 * t, g1, d4 * t, g1, mc.num_heads, hd_mod,
                  gl4, True, 1, t, record="attention_bwd")
    attn_bwd_case("attention_bwd gene cross C=384", d4 * t, g1, d4, c, mc.num_heads, hd_mod,
                  [384, 300, 1, 2], False, t, t)
    attn_bwd_case("attention_bwd gene cross C=1", d4 * t, g1, d4, 1, mc.num_heads, hd_mod,
                  [1, 1, 1, 1], False, t, t)
    enc_lens = torch.randint(2, length + 1, (n_gene,), generator=gen, device=dev).tolist()
    enc_lens[:4] = [0, 1, 2, length]
    attn_bwd_case("attention_bwd encoder self", n_gene, length, n_gene, length, we.num_heads,
                  hd_enc, enc_lens, True, 1, 1)

    # --- layernorm_bwd, geglu_bwd, masked_mean_pool_bwd, colsum ---------------
    x = randn(rows, e_mod, scale=3.0)
    dy, r1, r2 = randn(rows, e_mod), randn(rows, e_mod), randn(rows, e_mod)
    sc = torch.rand(e_mod, generator=gen, device=dev) + 0.5
    bi = torch.randn(e_mod, generator=gen, device=dev) * 0.1
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [e_mod], sc.to(bf), bi.to(bf), 1e-5)
    checks.run(
        "layernorm_bwd gene +2 residuals", lambda: kernels.layernorm_bwd(x, dy, sc, (r1, r2)),
        lambda: kernels.layernorm_bwd_plain(x, dy, sc, (r1, r2)),
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [e_mod], mean, rstd, sc.to(bf), bi.to(bf), [True, True, True]),
        14.0 * rows * e_mod, 2.0 * 5 * rows * e_mod + 16.0 * e_mod, record="layernorm_bwd",
        flops_peak=PEAK_F32_FLOPS, meta={"shape": f"[{rows},{e_mod}] +2 residuals"},
    )
    del x, dy, r1, r2, mean, rstd
    f = randn(rows, ffn, scale=2.0)
    dmm = randn(rows, ffn // 2)
    checks.run(
        "geglu_bwd gene", lambda: kernels.geglu_bwd(f, dmm), lambda: kernels.geglu_bwd_plain(f, dmm),
        None, 40.0 * rows * ffn / 2, 2.0 * (2 * rows * ffn + rows * ffn / 2),
        record="geglu_bwd", flops_peak=PEAK_F32_FLOPS, meta={"shape": f"[{rows},{ffn}]"},
    )
    del f, dmm
    dpool = randn(n_gene, e_enc)
    tok_len = torch.tensor(enc_lens, device=dev, dtype=torch.int32)

    def pool_zeros(dx):
        for i, n in enumerate(enc_lens):
            require_zero(dx[i, n:], f"masked_mean_pool_bwd past tok_len, window {i}")

    checks.run(
        "masked_mean_pool_bwd gene windows",
        lambda: kernels.masked_mean_pool_bwd(dpool, tok_len, length),
        lambda: kernels.masked_mean_pool_bwd_plain(dpool, tok_len, length), None,
        float(sum(enc_lens)) * e_enc, 2.0 * (n_gene * e_enc + n_gene * length * e_enc),
        record="masked_mean_pool_bwd", flops_peak=PEAK_F32_FLOPS, zeros=pool_zeros,
        meta={"shape": f"[{n_gene},{e_enc}] -> [{n_gene},{length},{e_enc}]"},
    )
    xc = randn(rows, 3 * e_mod)
    checks.run(
        "colsum gene dqkv", lambda: kernels.colsum(xc), lambda: kernels.colsum_plain(xc),
        lambda: torch.sum(xc, 0, dtype=torch.float32), float(rows) * 3 * e_mod,
        2.0 * rows * 3 * e_mod + 4.0 * 3 * e_mod, record="colsum", flops_peak=PEAK_F32_FLOPS,
        meta={"shape": f"[{rows},{3 * e_mod}]"},
    )
    del xc

    # --- #3: the window-encoder stack's recompute backward --------------------
    ini = ParamInit(SEED + 3, dev, torch.float32)
    enc_slopes = torch.from_numpy(alibi_slopes(we.num_heads)).to(dev)
    enc_scale = hd_enc ** -0.5
    layers = ini.plain_layer_stack(we.num_layers, e_enc, we.ffn_hidden_dim)
    leaves = [FE.get_leaf(layers, p).requires_grad_(True) for p in FE.LEAVES]
    lens = list(enc_lens)
    lens[-8:] = [0] * 8  # pad windows of a short gene
    tok_len = torch.tensor(lens, device=dev, dtype=torch.int32)
    xg = randn(n_gene, length, e_enc).requires_grad_(True)
    cot = randn(n_gene, e_enc)
    out = FE.fused_window_encoder_diff(xg, tok_len, layers, enc_slopes, enc_scale, we.num_heads)
    got = torch.autograd.grad(out, [xg] + leaves, cot)
    packed_p = FE.pack_encoder_layers(layers, we.num_heads, bf)
    ref = FE.fused_window_encoder_plain(xg, tok_len, packed_p, enc_slopes, enc_scale,
                                        we.num_heads)
    want = torch.autograd.grad(ref, [xg] + leaves, cot)
    names = ["x"] + ["/".join(p) for p in FE.LEAVES]
    compare_grads(torch, "fused_window_encoder backward vs autograd of the plain stack",
                  dict(zip(names, got)), dict(zip(names, want)))
    for i, n in enumerate(lens):
        require_zero(got[0][i, n:], f"encoder dx past tok_len, window {i}")
    print(f"check encoder backward: dx exactly 0 past tok_len in all {n_gene} windows "
          f"({lens.count(0)} pad windows)")
    del out, got, ref, want, packed_p
    with torch.no_grad():
        packed = FE.pack_encoder_layers(layers, we.num_heads, bf)
        xsave: list = []
        FE._chain(kernels.KERNELS, xg.detach(), tok_len, packed, enc_slopes, enc_scale,
                  we.num_heads, xsave)
        bwd_args = (cot, xsave, tok_len, packed, enc_slopes, enc_scale, we.num_heads)
        n_rows = n_gene * length
        a_flops, _ = attn_bwd_cost(lens, 1, 1, n_gene, length, length, we.num_heads, hd_enc)
        gemm_flops = 2.0 * n_rows * (e_enc * 3 * e_enc + e_enc * e_enc
                                     + e_enc * we.ffn_hidden_dim + we.ffn_hidden_dim // 2 * e_enc)
        # recompute (all but FFN-out) + dgrad and wgrad of every projection
        rec_flops = gemm_flops - 2.0 * n_rows * we.ffn_hidden_dim // 2 * e_enc + a_flops / 2.5
        w_bytes = sum(v.numel() * v.element_size() for v in packed.values())
        checks.run(
            "fused_window_encoder_bwd (8 layer calls)",
            lambda: FE.fused_window_encoder_bwd(*bwd_args)[0],
            lambda: FE.fused_window_encoder_bwd_plain(*bwd_args)[0], None,
            we.num_layers * (rec_flops + 2 * gemm_flops + a_flops),
            we.num_layers * 2.0 * n_rows * e_enc + 2.0 * n_rows * e_enc + 3 * w_bytes,
            record="fused_window_encoder_bwd",
            meta={"shape": f"N={n_gene} L={length} E={e_enc} layers={we.num_layers}"},
        )
        del xsave, bwd_args
    del layers, leaves, xg

    # --- #4, #5, #6: the gene stack's checkpointing forward and backward ------
    mod_slopes = torch.from_numpy(alibi_slopes(mc.num_heads)).to(dev)
    mod_scale = hd_mod ** -0.5
    layers = ini.context_layer_stack(mc.num_layers, e_mod, ffn)
    leaves = [FE.get_leaf(layers, p).requires_grad_(True) for p in FM.LEAVES]
    names = ["gene_stream", "cre_intermediates"] + ["/".join(p) for p in FM.LEAVES]

    def stack_case(label, d, g1_, c_, gene_lens, cre_lens, floors=None):
        gs = randn(d, t, g1_, e_mod).requires_grad_(True)
        cre = randn(mc.num_layers, d, c_, e_mod).requires_grad_(True)
        gl = torch.tensor(gene_lens, device=dev, dtype=torch.int32)
        cl = torch.tensor(cre_lens, device=dev, dtype=torch.int32)
        cot = randn(d, t, g1_, e_mod)
        for i, n in enumerate(gene_lens):
            cot[i, :, n:] = 0  # pad gene rows carry no loss
        out = FM.fused_gene_modulator_diff(gs, cre, gl, cl, layers, mod_slopes, mod_scale,
                                           mc.num_heads)
        got = torch.autograd.grad(out, [gs, cre] + leaves, cot)
        del out
        packed_p = FM.pack_gene_layers(layers, mc.num_heads, bf)
        ref = FM.fused_gene_modulator_plain(gs, cre, gl, cl, packed_p, mod_slopes, mod_scale,
                                            mc.num_heads)
        want = torch.autograd.grad(ref, [gs, cre] + leaves, cot)
        del ref, packed_p
        compare_grads(torch, f"fused_gene_modulator backward {label} vs autograd of the plain "
                      "stack", dict(zip(names, got)), dict(zip(names, want)), floors=floors)
        for i, (n, m) in enumerate(zip(gene_lens, cre_lens)):
            require_zero(got[0][i, :, n:], f"modulator d gene_stream on pad gene rows, donor {i}")
            require_zero(got[1][:, i, m:], f"modulator d cre on masked CRE slots, donor {i}")
        print(f"check modulator backward {label}: exact 0 on pad gene rows and masked CRE slots")

    stack_case("D=2 G1=201 C=384", 2, g1, c, [201, 120], [384, 300])
    # With one CRE slot the cross-attention output is that slot's V whatever
    # the query, so the cross-Q path (norm2, cross/wq) has a zero gradient in
    # exact arithmetic: its noise is measured against the live gradients of
    # the cross out-projection and norm3.
    dead = {"norm2/scale": "norm3/scale", "norm2/bias": "norm3/bias",
            "cross/wq/w": "cross/out/w", "cross/wq/b": "cross/out/b"}
    stack_case("D=2 short G1=37 C=1", 2, 37, 1, [37, 5], [1, 1], floors=dead)

    with torch.no_grad():
        d2 = 2
        packed = FM.pack_gene_layers(layers, mc.num_heads, bf)
        del layers, leaves
        gs = randn(d2, t, g1, e_mod)
        cre = randn(mc.num_layers, d2, c, e_mod)
        gene_lens, cre_lens = [201, 120], [384, 300]
        gl = torch.tensor(gene_lens, device=dev, dtype=torch.int32)
        cl = torch.tensor(cre_lens, device=dev, dtype=torch.int32)
        valid = torch.zeros((d2, t, g1), dtype=torch.bool, device=dev)
        for i, n in enumerate(gene_lens):
            valid[i, :, :n] = True
        r2 = d2 * t * g1
        sa_flops, _ = attn_cost(gene_lens, t, 1, d2 * t, g1, g1, mc.num_heads, hd_mod)
        ca_flops, _ = attn_cost(cre_lens, t, t, d2 * t, g1, c, mc.num_heads, hd_mod)
        proj = lambda *widths: 2.0 * r2 * sum(a * b for a, b in widths)
        w_bytes = sum(v.numel() * v.element_size() for v in packed.values())
        fwd_args = (gs, cre, gl, cl, packed, mod_slopes, mod_scale, mc.num_heads)
        layer_flops = (proj((e_mod, 3 * e_mod), (e_mod, e_mod), (e_mod, e_mod), (e_mod, e_mod),
                            (e_mod, ffn), (ffn // 2, e_mod))
                       + 2.0 * d2 * c * e_mod * 2 * e_mod + sa_flops + ca_flops)
        checks.run(
            "fused_gene_modulator_fwd_save D=2",
            lambda: FM.fused_gene_modulator_fwd_save(*fwd_args)[0],
            lambda: FM._chain(kernels.PLAIN, *fwd_args, saves=[]), None,
            mc.num_layers * layer_flops,
            2.0 * (2 * r2 * e_mod + mc.num_layers * (d2 * c * e_mod + 2 * r2 * e_mod)) + w_bytes,
            valid=valid, record="fused_gene_modulator_fwd_save",
            meta={"shape": f"D={d2} T={t} G1={g1} C={c} E={e_mod} layers={mc.num_layers}"},
        )
        _, saves = FM.fused_gene_modulator_fwd_save(*fwd_args)
        i = mc.num_layers - 1
        xl, hl, ckv = (s.clone() for s in saves[i])
        del saves
        grads = {k: torch.zeros(packed[k].shape, dtype=torch.float32, device=dev)
                 for k in FM.PACKED}
        dnext = randn(r2, e_mod)
        dnext.view(d2, t, g1, e_mod)[~valid] = 0
        dckv = torch.zeros((d2, c, 2 * e_mod), dtype=torch.float32, device=dev)

        def bwd1(ops):
            dh = FM._bwd1(ops, i, hl, ckv, dnext, cl, packed, grads, dckv, mod_scale,
                          mc.num_heads, t, g1)
            return dh, dckv.clone()

        ca_bwd, _ = attn_bwd_cost(cre_lens, t, t, d2 * t, g1, c, mc.num_heads, hd_mod)
        phase1 = proj((e_mod, e_mod), (e_mod, e_mod), (e_mod, ffn))
        checks.run(
            "fused_gene_modulator_bwd1 (one layer)", lambda: bwd1(kernels.KERNELS),
            lambda: bwd1(kernels.PLAIN), None,
            phase1 + 2 * (phase1 + proj((ffn // 2, e_mod))) + ca_flops + ca_bwd,
            2.0 * (3 * r2 * e_mod + d2 * c * 2 * e_mod) + 4.0 * d2 * c * 2 * e_mod
            + 3 * 2.0 * (3 * e_mod * e_mod + e_mod * ffn + ffn // 2 * e_mod),
            record="fused_gene_modulator_bwd1",
            meta={"shape": f"D={d2} T={t} G1={g1} C={c} E={e_mod}"},
        )
        dh = bwd1(kernels.KERNELS)[0]
        sa_bwd, _ = attn_bwd_cost(gene_lens, t, 1, d2 * t, g1, g1, mc.num_heads, hd_mod)
        phase0 = proj((e_mod, 3 * e_mod))
        checks.run(
            "fused_gene_modulator_bwd0 (one layer)",
            lambda: FM._bwd0(kernels.KERNELS, i, xl, dh, dnext, gl, packed, grads, mod_slopes,
                             mod_scale, mc.num_heads, t, g1),
            lambda: FM._bwd0(kernels.PLAIN, i, xl, dh, dnext, gl, packed, grads, mod_slopes,
                             mod_scale, mc.num_heads, t, g1), None,
            phase0 + 2 * (phase0 + proj((e_mod, e_mod))) + sa_flops + sa_bwd,
            2.0 * 4 * r2 * e_mod + 3 * 2.0 * 4 * e_mod * e_mod, record="fused_gene_modulator_bwd0",
            meta={"shape": f"D={d2} T={t} G1={g1} E={e_mod}"},
        )


# ---------------------------------------------------------------------------
# Synthetic genome of the main path
# ---------------------------------------------------------------------------

GENES = (  # (gene_id, start, end, strand): each gene window is a full 300 kb
    ("GENE1.1", 10_000, 320_000, "+"),
    ("GENE2.1", 340_000, 650_000, "+"),
    ("GENE3.1", 680_000, 990_000, "-"),
    ("GENE4.1", 1_010_000, 1_320_000, "-"),
)
CHR_LEN = 1_500_000
CRES_PER_GENE = 384
N_SNPS = 400


def write_genome(root: Path, seed: int):
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.utils.bgzf import write_bgzf
    from variantformer_tpu_torch.utils.constants import REF_CRES

    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, CHR_LEN)].tobytes().decode()
    with open(root / "genome.fa", "w") as fh:
        fh.write(">chr1 synthetic\n")
        for i in range(0, CHR_LEN, 60):
            fh.write(seq[i:i + 60] + "\n")
    pd.DataFrame(
        [{"gene_id": g, "gene_name": g.split(".")[0], "chromosome": "chr1",
          "start": s, "end": e, "strand": st} for g, s, e, st in GENES]
    ).to_csv(root / "gencode.csv", index=False)
    cre_maps = {}
    for g, s, e, _ in GENES:
        starts = np.sort(rng.choice(np.arange(s, e - 400, 400), CRES_PER_GENE, replace=False))
        lens = rng.integers(150, 350, CRES_PER_GENE)
        names = rng.integers(0, len(REF_CRES), CRES_PER_GENE)
        cre_maps[g] = pd.DataFrame({
            "chromosome": "chr1", "start_cre": starts, "end_cre": starts + lens,
            "cre_name": [REF_CRES[i] for i in names],
        })
    positions = np.sort(rng.choice(np.arange(1, CHR_LEN + 1), N_SNPS, replace=False))
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=chr1>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDONOR"]
    for pos in positions:
        ref = seq[pos - 1]
        alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
        gt = "0|1" if rng.random() < 0.6 else "1|1"
        lines.append(f"chr1\t{pos}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t{gt}")
    write_bgzf(str(root / "donor.vcf.gz"), ("\n".join(lines) + "\n").encode())
    (root / "tissues.yaml").write_text("".join(f"tissue{i}: {i}\n" for i in range(63)))
    return cre_maps


# The kernels of the vcf2exp path; their launches are read on its run. Every
# other kernel belongs to the training path and is read on the fit run.
SERVING_KERNELS = ("gemm_bf16", "attention", "layernorm", "geglu", "masked_mean_pool",
                   "fused_window_encoder", "fused_gene_modulator")
# The capability probes' kernels; their launches are read on the probe run.
PROBE_KERNELS = ("probe_48slice", "probe_3dreshape", "probe_48slice_bf16_matmul")


def genome_sources(root: Path, cre_maps: dict):
    from variantformer_tpu_torch.api.vcfprocessor import DataSources

    return DataSources(
        fasta_path=str(root / "genome.fa"), gencode_path=str(root / "gencode.csv"),
        tissue_vocab_path=str(root / "tissues.yaml"), cre_map_provider=cre_maps.get,
    ).resolve_defaults()


def serving_path(torch, root: Path, cre_maps: dict) -> dict:
    """vcf2exp for 4 genes x 54 tissues through ``VCFProcessor.predict``,
    held against the plain versions; returns the path's launch counts."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward_plain
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    sources = genome_sources(root, cre_maps)
    cfg = ModelConfig()
    proc = VCFProcessor(sources=sources, config=cfg, device="cuda")
    proc.set_params(init_seq2gene(cfg, SEED, device="cuda"))
    tissues = ",".join(f"tissue{i}" for i in range(54))
    query = pd.DataFrame({"gene_id": [g for g, *_ in GENES], "tissues": tissues})
    vcf = str(root / "donor.vcf.gz")

    kernels.reset_launches()
    t0 = time.perf_counter()
    result = proc.predict(vcf, query, batch_size=4)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"predict: {len(result)} genes x 54 tissues in {predict_s:.3f} s "
          f"(host pipeline included); launches {json.dumps(launches)}")

    preds = np.stack(result["predicted_expression"].to_list())
    embs = np.stack(result["embeddings"].to_list())
    require(preds.shape == (4, 54), f"pred shape {preds.shape}")
    require(embs.shape == (4, 54, cfg.seq2gene.emb_dim), f"embedding shape {embs.shape}")
    require(np.isfinite(preds).all() and np.isfinite(embs).all(), "non-finite output")
    require((preds >= 0).all(), "softplus head gave a negative prediction")
    for name in SERVING_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the vcf2exp path")

    # The same batch again: the forward alone, and through the plain versions.
    builder = GeneSampleBuilder(
        cfg=cfg.dataset, fasta=FastaReader(sources.fasta_path), tokenizer=proc.tokenizer,
        gencode=proc.get_genes(), cre_map_provider=cre_maps.get, vcf=VCFReader(vcf),
    )
    t0 = time.perf_counter()
    batch = pack_samples([builder.build(g) for g, *_ in GENES], list(range(54)))
    host_s = time.perf_counter() - t0
    print("batch shapes: " + ", ".join(
        f"{n}={tuple(np.shape(v))}" for n, v in batch._asdict().items() if v is not None))
    fwd = lambda: proc._forward(batch)
    out = fwd()
    require(np.allclose(out.pred_expression.cpu().numpy(), preds), "predict != _forward")
    fwd_ms = time_ms(torch, fwd, 3)
    dev_batch = proc._to_device(batch)
    with torch.inference_mode():
        plain = seq2gene_forward_plain(proc._params, dev_batch, cfg)
        plain_ms = time_ms(torch, lambda: seq2gene_forward_plain(proc._params, dev_batch, cfg), 2)
    compare(torch, "vcf2exp pred vs plain", out.pred_expression, plain.pred_expression,
            PRED_TOL)
    compare(torch, "vcf2exp embeddings vs plain", out.pooled_embedding,
            plain.pooled_embedding, EMB_TOL)
    print(f"vcf2exp forward (4 genes x 54 tissues, bf16): {fwd_ms:.3f} ms on the card, "
          f"{4 / (fwd_ms / 1e3):.4f} genes/s; plain forward {plain_ms:.3f} ms; "
          f"host build+pack {host_s:.3f} s; predict end to end {4 / predict_s:.4f} genes/s")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile(torch, fwd, "vcf2exp forward")
    return launches


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def training_path(torch, root: Path, cre_maps: dict) -> dict:
    """seq2gene training at full v4_pcg width and depth through the normal
    entry points: shard writer -> make_optimizer -> make_seq2gene_train_step
    -> fit (2 epochs of 2 steps, batches of 2 genes x 54 tissues, with
    checkpoints); then one step's time and profile, and one step's
    gradients against the plain versions at D=1. Returns the fit run's
    launch counts."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.config import ModelConfig, PrecisionPolicy
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.data.train_pipeline import TrainingShardWriter
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.train.loop import (
        fit,
        load_train_state,
        make_seq2gene_eval_loss,
        seq2gene_shard_batches,
    )
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import (
        TrainState,
        make_seq2gene_train_step,
        seq2gene_loss_fn,
    )
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    cfg = ModelConfig()
    sources = genome_sources(root, cre_maps)
    builder = GeneSampleBuilder(
        cfg=cfg.dataset, fasta=FastaReader(sources.fasta_path),
        tokenizer=BPETokenizer.from_file(sources.bpe_vocab_path),
        gencode=pd.read_csv(sources.gencode_path), cre_map_provider=cre_maps.get,
        vcf=VCFReader(str(root / "donor.vcf.gz")),
    )
    rng = np.random.default_rng(SEED)
    genes = [g for g, *_ in GENES]
    tissues = list(range(54))
    expression = pd.DataFrame([
        {"gene_id": g, "donor": "DONOR", "tissue": f"tissue{t}", "TPM": tpm, "FPKM": tpm}
        for g in genes for t, tpm in zip(tissues, np.expm1(rng.uniform(0.0, 5.0, 54)))
    ])
    vocab = {f"tissue{i}": i for i in range(63)}
    shard_dir = root / "shards"
    t0 = time.perf_counter()
    written = TrainingShardWriter({"DONOR": builder}, expression, vocab, shard_dir).build_all(
        genes, ["DONOR"], max_workers=4)
    require(len(written) == 4, f"{len(written)} shards written")
    print(f"training shards: {len(written)} (gene, donor) samples x 54 log1p-TPM labels in "
          f"{time.perf_counter() - t0:.2f} s")

    params = init_seq2gene(cfg, SEED, device="cuda")
    n_params = sum(t.numel() for _, t in named_leaves(params))
    opt = make_optimizer(params, learning_rate=1e-4, train_gene_tokenizer=True)
    step = make_seq2gene_train_step(cfg, opt, freeze_tokenizers=True, train_gene_tokenizer=True)
    n_train = sum(t.numel() for g in opt.param_groups for t in g["params"])
    print(f"parameters {n_params} ({n_train} trained; CRE tokenizer frozen)")
    train_b = seq2gene_shard_batches(shard_dir, tissues, batch_size=2)
    eval_loss = make_seq2gene_eval_loss(
        cfg, seq2gene_shard_batches(shard_dir, tissues, batch_size=2, shuffle=False))
    # Parity: one batch of one gene x 54 tissues, the gradients of one step
    # through the kernels and through the plain versions, from the initial
    # state here and from the trained state after the fit.
    batch1 = next(iter(seq2gene_shard_batches(shard_dir, tissues, batch_size=1,
                                              shuffle=False)(0)))
    cfg32 = dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))

    def grads(c, plain: bool):
        trained = [(k, t) for k, t in named_leaves(params) if t.requires_grad]
        opt.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        loss = seq2gene_loss_fn(params, *batch1, c, stop_cre_grads=True, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        out = {k: t.grad.cpu() for k, t in trained if t.grad is not None}
        opt.zero_grad(set_to_none=True)
        return float(loss.detach()), out, peak

    def parity(label: str, exact: bool) -> None:
        """Every trained leaf within rel L2 5e-2 of the plain versions' bf16
        gradient. With ``exact``, a leaf whose gradient bf16 cannot resolve
        (the plain bf16 gradient itself strays from the f32 one) may instead
        stay no further from the f32 gradient than 1.25x the plain's."""
        loss_k, got, peak_k = grads(cfg, False)
        loss_p, want, peak_p = grads(cfg, True)
        print(f"training parity, {label} (1 gene x 54 tissues): loss {loss_k:.6f} through the "
              f"kernels, {loss_p:.6f} through the plain versions; peak device memory "
              f"{peak_k:.2f} / {peak_p:.2f} GiB")
        require(abs(loss_k - loss_p) <= 2e-2 * abs(loss_p), "training parity: loss")
        require(set(got) == set(want), "training parity: different gradient sets")
        rels = {k: rel_l2(got[k], want[k]) for k in want}
        worst = sorted(rels, key=rels.get, reverse=True)[:6]
        print("training parity, worst leaves (rel L2 to the plain bf16): " + ", ".join(
            f"{k} {rels[k]:.4g} (|grad| {want[k].norm().item():.3g})" for k in worst))
        if not exact:
            compare_grads(torch, f"training parity, {label} (every trained leaf)", got, want)
            return
        loss_32, f32, _ = grads(cfg32, True)
        resolved = []
        for k, r in rels.items():
            require(torch.isfinite(got[k]).all(), f"training parity: {k} non-finite")
            if r < GRAD_TOL:
                continue
            r_k, r_p = rel_l2(got[k], f32[k]), rel_l2(want[k], f32[k])
            resolved.append(f"{k}: kernels {r_k:.4g}, plain bf16 {r_p:.4g} from f32")
            require(r_k <= max(GRAD_TOL, 1.25 * r_p),
                    f"training parity: {k} rel L2 {r:.4g} to the plain bf16, {r_k:.4g} to f32 "
                    f"(plain bf16 {r_p:.4g})")
        print(f"check training parity, {label}: {len(rels)} gradients, {len(rels) - len(resolved)}"
              f" within rel L2 {GRAD_TOL} of the plain bf16; held to the f32 gradient (loss "
              f"{loss_32:.6f}) instead: {'; '.join(resolved) or 'none'}")

    parity("initial state", exact=False)
    leaf = dict(named_leaves(params))
    watched = ("gene_layers/ffn_in/w", "cre_layers/mixer/wqkv/w", "tissue_heads/w1",
               "gene_tokenizer/layers/ffn_in/w", "gene_tokenizer/token_embedding")
    before = {k: leaf[k].detach().clone() for k in watched}
    frozen = [(k, t.detach().clone()) for k, t in named_leaves(params["cre_tokenizer"])]
    losses = []

    def logged_step(state, *args):
        state, loss = step(state, *args)
        losses.append(float(loss))
        return state, loss

    ckpt = root / "ckpt"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = fit(TrainState(params, opt, 0), logged_step, train_b, eval_loss=eval_loss, epochs=2,
              ckpt_dir=ckpt)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"fit: 2 epochs, {len(losses)} steps in {fit_s:.2f} s (eval and checkpoints "
          f"included); losses {losses}; history {json.dumps(res.history)}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"fit launches {json.dumps(launches)}")
    require(len(losses) == 4 and all(np.isfinite(losses)), f"losses {losses}")
    require(all(np.isfinite(h["val_loss"]) for h in res.history), "non-finite eval loss")
    for k in watched:
        require(not torch.equal(leaf[k], before[k]), f"{k} did not move")
    for k, t in frozen:
        require(torch.equal(dict(named_leaves(params["cre_tokenizer"]))[k], t),
                f"frozen cre_tokenizer/{k} changed")
    print(f"moved: {', '.join(watched)}; cre_tokenizer bit-identical ({len(frozen)} leaves)")
    for name in set(kernels.LAUNCHES) - set(PROBE_KERNELS):
        require(launches[name] > 0, f"kernel {name} was not launched on the training path")
    del before, frozen
    probe = leaf["gene_layers/ffn_in/w"].detach().clone()
    with torch.no_grad():
        leaf["gene_layers/ffn_in/w"].add_(1.0)
    t0 = time.perf_counter()
    restored = load_train_state(ckpt / "last", res.state)
    require(restored.step == res.state.step == 4, f"restored step {restored.step}")
    require(torch.equal(leaf["gene_layers/ffn_in/w"], probe), "checkpoint did not restore")
    print(f"load_train_state(last/): step {restored.step} restored with the parameters in "
          f"{time.perf_counter() - t0:.2f} s")
    del probe

    # One step's device time and profile, batch of 2 genes x 54 tissues.
    batch = next(iter(train_b(0)))
    state = restored
    one = lambda: step(state, *batch)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, one, 3)
    print(f"train step (2 genes x 54 tissues, bf16, full v4_pcg): {step_ms:.3f} ms on the card, "
          f"{2 / (step_ms / 1e3):.4f} samples/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile(torch, one, "train step")
    parity("after the fit and 4 more steps", exact=True)

    return launches


# Device function name (substring) -> the kernel group it belongs to.
KERNEL_FUNCTIONS = {
    "gemm_sm90_kernel<0": "gemm_bf16",
    "gemm_sm90_kernel<1": "gemm_wgrad",
    "dgrad_kernel": "gemm_dgrad",
    "attention_kernel": "attention",
    "delta_kernel": "attention_bwd",
    "dkv_kernel": "attention_bwd",
    "dq_kernel": "attention_bwd",
    "layernorm_kernel": "layernorm",
    "layernorm_bwd_kernel": "layernorm_bwd",
    "column_partial_kernel": "layernorm_bwd + colsum",
    "column_final_kernel": "layernorm_bwd + colsum",
    "geglu_kernel": "geglu",
    "geglu_bwd_kernel": "geglu_bwd",
    "masked_mean_pool_kernel": "masked_mean_pool",
    "masked_mean_pool_bwd_kernel": "masked_mean_pool_bwd",
}


def profile(torch, fn, label: str) -> None:
    """Device time of one call of ``fn`` by kernel group (torch.profiler):
    the port's kernels by name; everything else (cuBLAS and the elementwise
    work of the plain-PyTorch layers, the optimizer, autograd glue) as
    'other', with its largest entries. The busy share is that device time
    over the host's wall time of one call without the profiler, whose
    start-up would otherwise dominate the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict[str, list] = {}
    others = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        group = next((g for f, g in KERNEL_FUNCTIONS.items() if f in ev.key), "other")
        acc = groups.setdefault(group, [0.0, 0])
        acc[0] += ev.self_device_time_total
        acc[1] += ev.count
        if group == "other":
            others.append((ev.self_device_time_total, ev.count, ev.key))
    total = sum(us for us, _ in groups.values())
    print(f"profile {label}: device time {total / 1e3:.3f} ms; one call {wall_us / 1e3:.3f} ms "
          f"wall (busy {total / max(wall_us, 1e-9):.4f})")
    for group, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile {label} {group}: {us / 1e3:.3f} ms in {n} launches "
              f"({us / max(total, 1e-9):.4f} of device time)")
    for us, n, key in sorted(others, reverse=True)[:8]:
        print(f"profile {label} other: {us / 1e3:.3f} ms in {n} launches: {key[:90]}")


FWD_K1 = "variantformer_tpu/ops/fused_encoder.py:319"
FWD_K2 = "variantformer_tpu/ops/fused_modulator.py:483"
BWD_K3 = "variantformer_tpu/ops/fused_encoder.py:804"
FWD_K4 = "variantformer_tpu/ops/fused_modulator.py:996"
BWD_K5 = "variantformer_tpu/ops/fused_modulator.py:1071"
BWD_K6 = "variantformer_tpu/ops/fused_modulator.py:1159"
REPLACES = {
    "fused_window_encoder": FWD_K1,
    "fused_gene_modulator": FWD_K2,
    "fused_window_encoder_bwd": BWD_K3,
    "fused_gene_modulator_fwd_save": FWD_K4,
    "fused_gene_modulator_bwd1": BWD_K5,
    "fused_gene_modulator_bwd0": BWD_K6,
    "gemm_bf16": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, BWD_K6)),
    "attention": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, BWD_K6)),
    "layernorm": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, BWD_K6)),
    "geglu": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5)),
    "masked_mean_pool": FWD_K1,
    "gemm_dgrad": " + ".join((BWD_K3, BWD_K5, BWD_K6)),
    "gemm_wgrad": " + ".join((BWD_K3, BWD_K5, BWD_K6)),
    "attention_bwd": " + ".join((BWD_K3, BWD_K5, BWD_K6)),
    "layernorm_bwd": " + ".join((BWD_K3, BWD_K5, BWD_K6)),
    "geglu_bwd": " + ".join((BWD_K3, BWD_K5)),
    "masked_mean_pool_bwd": BWD_K3,
    "colsum": " + ".join((BWD_K3, BWD_K5, BWD_K6)),
    "probe_48slice": "scripts/mosaic_capability_probe.py:29",
    "probe_3dreshape": "scripts/mosaic_capability_probe.py:49",
    "probe_48slice_bf16_matmul": "scripts/mosaic_capability_probe.py:79",
}
_CSRC = "variantformer_tpu_torch/csrc/"
SOURCE = {
    "fused_window_encoder": "variantformer_tpu_torch/ops/fused_encoder.py",
    "fused_gene_modulator": "variantformer_tpu_torch/ops/fused_modulator.py",
    "fused_window_encoder_bwd": "variantformer_tpu_torch/ops/fused_encoder.py",
    "fused_gene_modulator_fwd_save": "variantformer_tpu_torch/ops/fused_modulator.py",
    "fused_gene_modulator_bwd1": "variantformer_tpu_torch/ops/fused_modulator.py",
    "fused_gene_modulator_bwd0": "variantformer_tpu_torch/ops/fused_modulator.py",
    "gemm_bf16": _CSRC + "gemm_sm90.cu",
    "gemm_dgrad": _CSRC + "gemm.cu",
    "gemm_wgrad": _CSRC + "gemm_sm90.cu",
    "attention": _CSRC + "attention.cu",
    "attention_bwd": _CSRC + "attention_bwd.cu",
    "layernorm": _CSRC + "rowwise.cu",
    "layernorm_bwd": _CSRC + "rowwise.cu",
    "geglu": _CSRC + "rowwise.cu",
    "geglu_bwd": _CSRC + "rowwise.cu",
    "masked_mean_pool": _CSRC + "rowwise.cu",
    "masked_mean_pool_bwd": _CSRC + "rowwise.cu",
    "colsum": _CSRC + "rowwise.cu",
    "probe_48slice": _CSRC + "probes.cu",
    "probe_3dreshape": _CSRC + "probes.cu",
    "probe_48slice_bf16_matmul": _CSRC + "probes.cu",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from variantformer_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    info = kernels.build()
    print(f"nvcc build: {info['seconds']:.2f} s into {info['dir']}")
    for src, log in info["ptxas"].items():
        for line in log.splitlines():
            low = line.lower()
            if "registers" in line or "spill" in line or "error" in low or "warning" in low:
                print(f"ptxas {src}: {line.strip()}")
    sass_counts(info["dir"])

    t0 = time.perf_counter()
    probe = probe_path(torch)
    checks = Checks(torch, ITERS)
    probe_checks(torch, checks)
    gemm_unit_checks(torch)
    print(f"probe and GEMM unit checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernel_checks(torch, checks)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    backward_checks(torch, checks)
    print(f"backward checks: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="vf_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        cre_maps = write_genome(root, SEED)
        print(f"genome written in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        serve = serving_path(torch, root, cre_maps)
        print(f"vcf2exp path: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train = training_path(torch, root, cre_maps)
        print(f"training path: {time.perf_counter() - t0:.1f} s")

    rows = []
    runs = {"probe": probe, "vcf2exp": serve, "train": train}
    for name, rec in checks.records.items():
        path = ("probe" if name in PROBE_KERNELS else
                "vcf2exp" if name in SERVING_KERNELS else "train")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": runs[path][name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"], "path": path,
            "train_launches": train[name],
        })
    missing = set(kernels.LAUNCHES) - {r["name"] for r in rows}
    require(not missing, f"no measured record for {missing}")
    print(json.dumps({"kernels": rows}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
