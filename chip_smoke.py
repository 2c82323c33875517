#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (``python3 chip_smoke.py``).

1. Prints the card's name and power limit and builds the CUDA kernels from
   ``variantformer_tpu_torch/csrc`` with nvcc for sm_90a.
2. Holds every kernel against its plain PyTorch version on the card, at the
   shapes of the main path (bf16): each shared kernel alone, the whole
   window-encoder stack (E=512, 8 layers, L=200, ragged tok_len with 0 and
   1, N not a multiple of any tile) and the whole gene stack (E=1536, 25
   layers, T=54, G1=201 and a short G1, C=384 and C=1, D=2). The error
   bound is 3e-2 of max |plain|. Each is timed beside its plain version and,
   where one PyTorch call computes the same function, that call.
3. Writes a synthetic genome (one 1.5 Mb chr1, 4 genes with full 300 kb
   windows, 384 CREs each, a donor VCF of SNPs) and runs
   ``VCFProcessor(device="cuda").predict`` for 4 genes x 54 tissues at full
   v4_pcg width with random weights from a seed, counting the kernels'
   launches; then holds the same batch through the plain versions on the
   card at 5e-2 (pred) / 6e-2 (embeddings) of max |plain|.
4. Prints a ``{"kernels": [...]}`` line, then the device line last.

Exits non-zero, before any result, when there is no CUDA device; any
failed phase raises.
"""

from __future__ import annotations

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


def compare(torch, name, out, ref, tol, valid=None):
    """max |out - ref| must stay within tol * max |ref| (over ``valid``)."""
    o, r = out.float(), ref.float()
    if valid is not None:
        o, r = o[valid], r[valid]
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (o - r).abs().max().item()
    scale = r.abs().max().item()
    rel = err / max(scale, 1e-30)
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
            valid=None, record=None, flops_peak=PEAK_BF16_FLOPS, meta=None):
        torch = self.torch
        out = kernel_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        err = compare(torch, name, out, ref, tol, valid)
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


def kernel_checks(torch) -> Checks:
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
    checks = Checks(torch, ITERS)
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
        checks.run(
            name, lambda: kernels.gemm(a, w, bias, res),
            lambda: kernels.gemm_plain(a, w, bias, res), lib, 2.0 * m * n * k, nbytes,
            record=record,
            meta={"shape": f"[{m},{k}]x[{k},{n}]" + (" +res" if residual else "")},
        )

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
    return checks


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


def main_path(torch) -> dict:
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.api.vcfprocessor import DataSources, VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward_plain
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    with tempfile.TemporaryDirectory(prefix="vf_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        cre_maps = write_genome(root, SEED)
        print(f"genome written in {time.perf_counter() - t0:.2f} s")
        sources = DataSources(
            fasta_path=str(root / "genome.fa"), gencode_path=str(root / "gencode.csv"),
            tissue_vocab_path=str(root / "tissues.yaml"), cre_map_provider=cre_maps.get,
        )
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
        for name in kernels.LAUNCHES:
            require(launches[name] > 0, f"kernel {name} was not launched on the main path")

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
        profile_forward(torch, fwd)
        return launches


# Device function name (substring) -> the kernel record it belongs to.
KERNEL_FUNCTIONS = {
    "gemm_bf16_kernel": "gemm_bf16",
    "attention_kernel": "attention",
    "layernorm_kernel": "layernorm",
    "geglu_kernel": "geglu",
    "masked_mean_pool_kernel": "masked_mean_pool",
}


def profile_forward(torch, fwd) -> None:
    """Device time of one vcf2exp forward by kernel (torch.profiler): the
    port's kernels by name; everything else (cuBLAS and the elementwise work
    of the plain-PyTorch layers: CRE stack, maps, cross K/V, heads) as
    'other', with its largest entries. The busy share is that device time
    over the host's wall time of one forward run without the profiler,
    whose start-up would otherwise dominate the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
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
    print(f"profile: device time {total / 1e3:.3f} ms; one forward {wall_us / 1e3:.3f} ms wall "
          f"(busy {total / max(wall_us, 1e-9):.4f})")
    for group, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile {group}: {us / 1e3:.3f} ms in {n} launches "
              f"({us / max(total, 1e-9):.4f} of device time)")
    for us, n, key in sorted(others, reverse=True)[:8]:
        print(f"profile other: {us / 1e3:.3f} ms in {n} launches: {key[:90]}")


REPLACES = {
    "fused_window_encoder": "variantformer_tpu/ops/fused_encoder.py:319",
    "fused_gene_modulator": "variantformer_tpu/ops/fused_modulator.py:483",
    "gemm_bf16": "variantformer_tpu/ops/fused_encoder.py:319 + variantformer_tpu/ops/fused_modulator.py:483",
    "attention": "variantformer_tpu/ops/fused_encoder.py:319 + variantformer_tpu/ops/fused_modulator.py:483",
    "layernorm": "variantformer_tpu/ops/fused_encoder.py:319 + variantformer_tpu/ops/fused_modulator.py:483",
    "geglu": "variantformer_tpu/ops/fused_encoder.py:319 + variantformer_tpu/ops/fused_modulator.py:483",
    "masked_mean_pool": "variantformer_tpu/ops/fused_encoder.py:319",
}
SOURCE = {
    "fused_window_encoder": "variantformer_tpu_torch/ops/fused_encoder.py",
    "fused_gene_modulator": "variantformer_tpu_torch/ops/fused_modulator.py",
    "gemm_bf16": "variantformer_tpu_torch/csrc/gemm.cu",
    "attention": "variantformer_tpu_torch/csrc/attention.cu",
    "layernorm": "variantformer_tpu_torch/csrc/rowwise.cu",
    "geglu": "variantformer_tpu_torch/csrc/rowwise.cu",
    "masked_mean_pool": "variantformer_tpu_torch/csrc/rowwise.cu",
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
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"ptxas {src}: {line.strip()}")

    t0 = time.perf_counter()
    checks = kernel_checks(torch)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    launches = main_path(torch)
    rows = []
    for name, rec in checks.records.items():
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"],
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
