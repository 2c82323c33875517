#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (``python3 chip_smoke.py``).

1. Prints the card's name and power limit and builds the CUDA kernels from
   ``variantformer_tpu_torch/csrc`` with nvcc for sm_90a; where
   ``cuobjdump`` is present, counts the ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA load) instructions of the built GEMM, attention, attention
   backward and probe libraries (the attention libraries must hold no
   ``HMMA``: no wmma), the ``HGMMA``, ``I2F`` and ``MUFU.EX2`` of each
   attention forward instantiation (no int-to-float conversion in the key
   walk without ALiBi, none per score with it), and the LayerNorm forward's
   global loads (the register-resident kernel's all 16 bytes wide); fails
   where ptxas reports the attention forward's wgmma serialised (C7520).
2. Runs the capability probes (``python -m variantformer_tpu_torch.probes``
   on the card, counting their kernels' launches) and holds each probe
   kernel against its plain version; then holds the TMA + wgmma GEMM
   (``gemm_bf16``, ``gemm_dgrad``, ``gemm_wgrad``) on one tile, 2 x 2 tiles,
   ragged edges and split rows into a non-zero buffer, and the TMA + wgmma
   attention on one query tile, the ragged last tile, kv_len 0, 1 and Sk,
   a split cross-attention, one key and four consumer warpgroups, each
   with and without ALiBi, its serving and its ``for_backward`` outputs
   (every softmax variant the wrapper launches), and the TMA + wgmma
   attention backward
   at Sk 1, 63, 64, 65 and 384, kv_len 0 and 1, kv_div 1 and 54 (split
   over blocks), head dim 48 and 64, dk/dv in bf16 and f32 (3e-2 of max
   |plain| per output, exact zeros past kv_len; at Sk 1, where dq and dk are
   rounding noise, those within 8x the plain version's noise too); both
   past their key caps, walked in key chunks (Sk 577 to 2048, kv_div 1 and
   54, head dim 48 and 64, kv_len 0, 1, Sk, mid-chunk and at a chunk
   boundary), and the chunked walk forced at the main path's 384 keys
   against the one-chunk launch (the same bits); both at head dim 128 (two
   64-column boxes a head tile: Sk 1, 63, 64, 65, 200, 384 and 704, kv_len
   0, 1 and Sk, kv_div 1 and 54, and the walk forced into 128-key chunks at
   the encoder's 200 keys, the same bits as one launch); the LayerNorm
   forward on 1 and 7 rows, the main paths' shapes and the general kernel
   (E=1000); and
   ``gemm_wgrad`` twice at every split shape (the same bits), before
   anything is timed;
   here and at
   the main-path shapes ``gemm_bf16`` and ``gemm_dgrad`` within one bf16
   ulp of max |plain| and ``gemm_wgrad`` within 1e-3 of it.
3. Holds every kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (bf16): each shared forward kernel alone, the
   whole window-encoder stack (E=512, 8 layers, L=200, ragged tok_len with
   0 and 1), the whole gene stack (E=1536, 25 layers, T=54, G1=201 and a
   short G1, C=384 and C=1) and the CRE stack's chain (``vfx_torch::cre_stack``
   against ``cre_stack_plain``: E=1536, 24 layers of 32 heads of 48, D=4
   C=384 with 384 / 300 / 1 / 2 valid slots, then 7 layers at head dims 32,
   96 and 128 on 64, 128 and 128 lanes; one chain launch a call) within
   3e-2 of max |plain| (the attention also alone at the CRE stack's self
   and cross shapes); then each backward
   kernel alone (transposed GEMMs, attention backward for the gene self-
   and cross-attention (C=384 and C=1) and the encoder, layernorm backward
   with and without residuals at E=1536 and at E=512, geglu/pool backward,
   column sums), and the whole-stack backwards (#3 encoder, #5 + #6 gene
   stack, by rel L2 < 5e-2 per gradient against torch autograd of the plain
   stacks, with exact zeros on pad rows and masked CRE slots). Each is timed
   beside its plain version and, where one PyTorch call computes the same
   function, that call; the redesigned GEMMs and the attention (each of its
   three uses at the checks' mixed lengths and at the main path's full
   ones) also print the time their ``wmma`` predecessor recorded in
   ``PERF.md``, and the redesigned backward kernels the time their
   predecessors (the ``wmma`` attention backward, the two-pass LayerNorm
   backward) recorded there.
4. The wide heads path (``wide_heads_path``): window encoders at head dims
   96 (H=4, E=384, packed to 128 lanes) and 128 (H=4, E=512), 8 layers,
   N=1536 windows of L=200: #1 and one backward through #3 driven with the
   launch counts read, the forward within 3e-2 of max |plain| and every
   gradient within rel L2 5e-2 of torch autograd of the plain stack; then
   #1, #3 and the head-dim-128 attention and attention backward timed
   beside their plain versions (and SDPA).
   Then the graphs path (``graphs_path``): at full v4_pcg width,
   ``seq2gene_forward`` with the inference ops replayed as CUDA graphs
   (``ops/graphs.py``) gives the bits of their eager chains on forward_d4's
   batch (D=4, C=384, G=200, T=54, every window full) and on three sweep
   shapes (C, G) = (64, 128), (192, 200) and (384, 200) with ragged counts
   and token lengths, and on the VEP ref-once path (``return_streams``:
   the final gene and CRE streams, which a later replay leaves as they
   were); a weight swap captures anew; the ``GRAPHS`` counters, each
   shape's capture ms (the capturing call less a replaying one), the
   forward's seconds eager and replayed, and its peak memory (allocated and
   reserved) eager and replayed are printed.
5. Writes a synthetic genome (one 1.5 Mb chr1, 4 genes with full 300 kb
   windows, 384 CREs each, a donor VCF of SNPs), indexes the VCF with the
   port's ``write_tbi`` and requires the indexed query to equal the scan on
   every gene and CRE window; runs ``VCFProcessor(device="cuda").predict``
   for 4 genes x 54 tissues at full v4_pcg width with random weights from a
   seed on the native host engines, counting the kernels' launches and the
   native calls; builds the same batch on the native and on the Python host
   engines (timed; the same leaves); then holds it through the plain
   versions on the card at 5e-2 (pred) / 6e-2 (embeddings) of max |plain|,
   and profiles one forward by kernel (``load_model`` of the same seeded
   weights as a reference-layout ``.pth`` runs in the launchers path, 10).
   Then VEP (full width, its depth cut to 8 gene / 7 CRE / 4 window-encoder
   layers): ``create_vcf_from_variant`` merges 3 records into the donor
   VCF (its ``.tbi`` query equal to the scan, a new record replacing the
   donor's); ``VariantProcessor(device="cuda").predict`` scores 6 variants
   (every variant type on both strands; five rows of 54 tissues, one of 2)
   against the 4 genes for the merged VCF's sample and REF_HG38 (the local
   consensus: no artifacts, and a remote fetch fails at once) with the
   ref-once cache and the window-dedup pools, counting the launches per
   dispatch and the native calls; one triple and one pair dispatch of the
   run are held against the plain versions at 5e-2 / 6e-2 of max |plain|;
   the run is held against itself with the ref-once cache off, the pools
   off and 4 variants a dispatch (printing whether the bits are equal); the
   forward of a triple (D=3) and a pair (D=2) at T=54 is timed by CUDA
   events and profiled, with the host's time to launch it. The kernel
   checks hold the two forward stacks at full depth at
   the VEP shapes too (the pools' 448 and 264 rows, D=3 and D=2 at T=54,
   D=3 at T=2).
   Then the sweeps (``sweep_path``): ``genome_wide_expression`` of the 4
   genes once (a warm-up dispatch), then 8 times over at batch_size 4
   (genes/s, ``wall_s``, stages; the rows against
   the vcf2exp ``predict``'s within 5e-2, with a same-bits line) and once
   at batch_size 3 (the trailing gene padded: two dispatches at D=3);
   ``saturation_scan`` of 12 positions x 3 alts in one CRE of GENE1.1 at
   54 tissues (the reference dispatch, 4 full and 1 padded, all at D=16;
   rows, one reference per tissue, finite log2fc, hom edits that move
   expression); ``ADriskFromVCF``
   of the 4 genes at one tissue each over a seeded 300-tree ensemble (every
   risk in [0, 1] and the ensemble's value on the returned embedding); the
   report writers (their sizes); the live app on a thread (GET /, a POST of
   GENE1.1 at every tissue, the same POST cached, an in-silico edit that
   changes the values, an unknown gene refused with HTTP 400; each
   request's seconds). With the path's launch counts read (per phase and
   dispatch): one scan dispatch against the plain versions at 5e-2 / 6e-2,
   the AD-risk embeddings at 6e-2, the live values against ``predict`` and
   three scan rows against ``VariantProcessor.predict`` within 5e-2; a scan
   dispatch timed by CUDA events and profiled; a genome-wide dispatch
   traced by ``device_trace`` (the trace names ``gemm_bf16`` launches) and
   the host's launch of it timed with the card idle, alone and beside 4
   build threads; and ``torch_predict_margin`` on 65 536 rows x 1536
   features against ``raw_margin`` (rtol 1e-4 / atol 1e-5), timed. The
   kernel checks hold the two forward stacks at the sweeps' shapes too (the
   scan's 6144 CRE and 3200 gene windows, D=16 T=54, D=1 T=63 for the live
   app, D=1 T=1 for AD risk).
   Then serving export (``export_path``) at full width (2 gene, 1 CRE and
   1 window-encoder layers: the traces' time grows with depth) on the
   vcf2exp batch: ``export_forward`` of the kernel route (``fused2``, the
   ``vfx_torch`` ops) and the plain one (``xla``), each artifact's seconds
   and bytes (far below the weights'), ``load_exported`` and one call of
   each on the card, the same bits as the eager ``seq2gene_forward`` /
   ``seq2gene_forward_plain``, #1 launched twice and #2 once by the kernel
   route's call (the ``serving`` launches), each call timed beside the eager
   forward; and the bench (``python -m variantformer_tpu_torch.bench`` in a
   subprocess: its JSON line, and ``seq2gene_flops`` at D=4 over its median
   time as a share of 989 TFLOP/s).
6. Trains at full v4_pcg width and depth through the normal entry points:
   ``TrainingShardWriter`` shards for the 4 genes (1 donor, 54 log1p-TPM
   labels from the seed), ``make_optimizer`` (Adam, lr 1e-4, gene tokenizer
   trained, CRE tokenizer frozen), ``make_seq2gene_train_step`` and ``fit``
   for 1 epoch of 2 steps over batches of 2 genes, then one
   ``save_train_state`` and ``load_train_state`` of the whole state; counts every kernel's launches, requires finite
   losses, moved parameters and a bit-identical CRE tokenizer; times and
   profiles one step; and holds one step's gradients at 1 gene x 54 tissues
   against the plain versions (rel L2 < 5e-2 per leaf), from the initial
   state and after the fit; and the gradients of two identical steps from
   the same state, the same bits on every leaf.
7. The model variants (``variants_path``), at full v4_pcg width and 8 gene /
   7 CRE / 4 window-encoder layers:
   ``VCFProcessor.predict`` of the 4 genes x 54 tissues with (a)
   ``use_context`` tokenizers, (b) max pooling, (c) cross-only gene layers,
   (d) cross-only with the stack residual, (e) 48 gene heads of head dim 32
   (padded to 64 lanes in the packs); each launches the whole-stack
   wrappers its route names (the JAX package's rules) and no other, and
   matches ``seq2gene_forward_plain`` at 5e-2 / 6e-2 of max |plain|; one
   forward of each timed; kernel #1 held at (c)'s CRE windows and #2 at
   (a)'s and (e)'s weights (3e-2); one train step each of (a), (c) and (e)
   at 1 gene x 54 tissues (gene tokenizer trained, remat), gradients within
   rel L2 5e-2 per leaf of the plain versions' ((e)'s gene tokenizer
   gradient nonzero), peak memory printed.
8. seq2reg training (``seq2reg_path``) at the released tokenizer width (E
   512, 8 heads, vocabulary 500, 63 tissues, 11 classes) and 4 layers:
   ``Seq2RegShardWriter`` shards of the genome's 1536 CREs for 2 tissues
   (seeded labels, consensus sequences), ``make_optimizer("adamw")``,
   ``make_seq2reg_train_step`` and ``fit`` over an epoch and a resumed
   second one with the eval loss and metrics, for ``use_context`` False and
   True; focal + dual losses with ``plateau="step"`` and 2 micro-steps an
   update; the k=2 update against one AdamW update on the mean gradient
   (rel 1e-6); windows/s a step and peak memory. No hand-written kernel
   launches there.
9. The mesh path (``mesh_path``, ``variantformer_tpu_torch/parallel``): a
   world of one on NCCL runs ``VCFProcessor.use_mesh`` with the donor and
   the tissue partitions on the vcf2exp batch at full v4_pcg width and the
   cut depth of the two-process phase (the unmeshed bits) and the donor
   partition's training step at D=2 (gradients within rel L2 5e-2 of the
   single-device step's, the same bits twice), every kernel of #1-#6
   launched there; then two processes on the card over gloo at that depth: the collectives on CUDA tensors, both partitions, the
   layered route split over a model axis of 2, one donor-partition step
   and two ZeRO-1 steps with a ``state_dict`` between them, each against
   one process.
10. The launchers path (``launchers_path``,
   ``variantformer_tpu_torch/scripts``): ``launch_genome_wide`` in real mode
   at full v4_pcg on an artifacts directory under the downloader's names (a
   world of one on NCCL in this process: ``load_model`` gives every leaf the
   written bf16 bits, #1 and #2 launch, the rows within 5e-2 of vcf2exp's
   ``predict``; and two processes on the card over gloo, started before it,
   genes [2, 2], their rows within 5e-2 of the world of one's), and
   ``launch_train`` (a world of one on NCCL at full v4_pcg from its seeded
   init, #1 and #3-#6 launched, so that the two worlds of one launch #1-#6;
   and two processes over gloo at the mesh path's cut depth from a port
   checkpoint, started before it, each epoch's loss within 1e-3 of a world
   of one's). The artifacts directory stays for the notebooks path.
11. The examples path (``examples_path``): every example flow in synthetic
   mode on the card (the AD-risk pair only where scikit-learn is installed;
   a line names them otherwise), the launches of each read; vcf2exp against
   the plain forward at 5e-2 / 6e-2.
12. The notebooks path (``notebooks_path``): the port's notebooks run in
   this process by ``scripts/run_notebook.py``, in synthetic mode on the
   card (a cell needing a module missing here, and the AD-risk pair without
   scikit-learn, named and left to the CPU tests; a minimal
   ``IPython.display`` where IPython is missing), each notebook's launches
   read, vcf2exp against the plain forward at 5e-2 / 6e-2; then the vcf2exp
   notebook in real mode at full v4_pcg on the launchers path's artifacts,
   its frame the bits of ``predict``, with ``load_model``'s seconds.
Every path records each forward's CRE route (``seq2gene._cre_chain``): an
inference path requires the chain in every forward, a training step the
loop, and each path one ``cre_stack`` launch a chain route. A path that
requires a kernel to have run counts its host launches and, for the kernels
of the inference ops' chains, the replays of those ops' graphs
(``kernel_ran``).
13. Prints the phase times, a ``{"kernels": [...]}`` line (each kernel's
   launches on its own path, and on the training, variants, seq2reg,
   serving export, mesh, launchers, examples and notebooks paths), then the
   device line last.

Exits non-zero, before any result, when there is no CUDA device; any
failed phase raises.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent  # the checkout's root
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
STACK_TOL = 3e-2
GEMM_TOL = 2.0 ** -7  # gemm_bf16, gemm_dgrad, the bf16 product probe: one bf16 ulp of max |plain|
WGRAD_TOL = 1e-3      # gemm_wgrad, f32 sums in another order
PRED_TOL, EMB_TOL = 5e-2, 6e-2
SEED = 0
ITERS = 5  # timed calls per kernel measurement, after one warm-up
# Timed calls of a plain version (the yardstick, 7-14x slower than its
# kernel), after the comparison's own call warmed it up.
PLAIN_ITERS = 2


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, flops_peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / flops_peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int, warm: bool = True) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up
    (none when ``warm`` is false: the caller has just run ``fn``)."""
    if warm:
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


NOISE_FACTOR = 8  # an output that is only rounding noise: within 8x the plain version's


def compare_noise(torch, name, out, ref) -> float:
    """An output that is 0 in exact arithmetic (dq and dk over a single
    key, where P = 1 and dP - delta cancels): the kernel's and the plain
    version's values are both rounding noise, and the kernel's may differ
    from the plain version's by at most NOISE_FACTOR x max |plain|, the
    plain version's own noise (on top of ``compare``'s check)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    noise = r.abs().max().item()
    print(f"check {name} (rounding noise): max_abs_err={err:.6g} max|plain|={noise:.6g} "
          f"limit={NOISE_FACTOR} x max|plain|")
    if not err <= NOISE_FACTOR * noise:
        raise AssertionError(f"{name}: max_abs_err {err:.4g} > {NOISE_FACTOR} x the plain "
                             f"version's noise {noise:.4g}")
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
            floor=0.0, noise=()):
        """``noise``: the indices of outputs that are 0 in exact arithmetic,
        also held by ``compare_noise``."""
        torch = self.torch
        out = kernel_fn()
        torch.cuda.synchronize()
        ref = plain_fn()
        if isinstance(out, (tuple, list)):
            err = max(compare(torch, f"{name} [{i}]", o, r, tol, valid, floor)
                      for i, (o, r) in enumerate(zip(out, ref)))
            for i in noise:
                compare_noise(torch, f"{name} [{i}]", out[i], ref[i])
        else:
            err = compare(torch, name, out, ref, tol, valid, floor)
        if zeros is not None:
            zeros(out)
        del out, ref
        ms = time_ms(torch, kernel_fn, self.iters)
        plain_ms = time_ms(torch, plain_fn, PLAIN_ITERS, warm=False)
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


# The CRE stack's route of every seq2gene forward in this process since the
# last ``reset_launches`` (True: the op ``vfx_torch::cre_stack``), recorded
# by ``record_cre_routes``.
CRE_ROUTES: list = []


def record_cre_routes() -> None:
    """Record each forward's CRE route (``seq2gene._cre_chain``) in CRE_ROUTES."""
    from variantformer_tpu_torch.models import seq2gene

    decide = seq2gene._cre_chain

    def recorded(*args, **kwargs):
        CRE_ROUTES.append(bool(decide(*args, **kwargs)))
        return CRE_ROUTES[-1]

    seq2gene._cre_chain = recorded


def reset_launches() -> None:
    """Zero the kernels' launch counters and the recorded CRE routes."""
    from variantformer_tpu_torch.ops import kernels

    kernels.reset_launches()
    CRE_ROUTES.clear()


# The kernels of each inference op's chain: a replay of the op's CUDA graph
# runs them with no host launch counted (ops/graphs.py).
GRAPH_KERNELS = {
    "fused_window_encoder": ("gemm_bf16", "attention", "layernorm", "geglu", "masked_mean_pool"),
    "cre_stack": ("gemm_bf16", "attention", "layernorm", "geglu"),
    "fused_gene_modulator": ("gemm_bf16", "attention", "layernorm", "geglu"),
}


def kernel_ran(launches: dict, name: str) -> bool:
    """Whether ``name`` ran since the last ``reset_launches``: launched from
    the host (``launches``), or, for a kernel of an inference op's chain,
    replayed in a graph of that op."""
    from variantformer_tpu_torch.ops import kernels

    return launches.get(name, 0) > 0 or any(
        kernels.GRAPHS[op]["replays"] > 0 for op, names in GRAPH_KERNELS.items() if name in names)


def require_cre_chain(label: str, launches: dict, want: str = "chain") -> None:
    """Since the last ``reset_launches``: one ``cre_stack`` launch for each
    forward that took the chain, and ``want`` "chain" (every forward took
    it, an inference path), "loop" (none did: training) or "some" (training
    beside inference) or "any" (the counts only)."""
    chain, n = CRE_ROUTES.count(True), len(CRE_ROUTES)
    print(f"{label}: the CRE stack took the kernel chain in {chain} of {n} forwards; "
          f"cre_stack launched {launches.get('cre_stack', 0)} times")
    require(launches.get("cre_stack", 0) == chain,
            f"{label}: {launches.get('cre_stack', 0)} cre_stack launches for {chain} chain routes")
    ok = {"chain": n > 0 and chain == n, "loop": chain == 0, "some": chain > 0,
          "any": True}[want]
    require(ok, f"{label}: the CRE stack took the chain in {chain} of {n} forwards "
                f"(wanted: {want})")


def sdpa_bias(torch, q, k, kv_len, slopes, heads, kv_div, len_div):
    """The attention's ALiBi and key mask as one additive bf16 bias [B, H,
    Sq, Sk] for ``scaled_dot_product_attention``."""
    from variantformer_tpu_torch.ops.attention import MASK_VALUE

    dev = q.device
    b, sq, _ = q.shape
    sk = k.shape[1]
    lens = kv_len.repeat_interleave(len_div)
    bias = torch.zeros((b, heads, sq, sk), device=dev, dtype=torch.float32)
    if slopes is not None:
        pos = torch.arange(max(sq, sk), device=dev, dtype=torch.float32)
        bias = bias - slopes[None, :, None, None] * (pos[:sq, None] - pos[None, :sk]).abs()
    valid = torch.arange(sk, device=dev)[None, :] < lens[:, None]
    return torch.where(valid[:, None, None, :], bias, MASK_VALUE).to(torch.bfloat16)


def sdpa_call(torch, q, k, v, kv_len, slopes, scale, heads, kv_div, len_div):
    """One PyTorch call on the attention's function (float ALiBi + mask
    bias), the ``library_ms`` yardstick."""
    import torch.nn.functional as F

    b, _, e = q.shape
    bias = sdpa_bias(torch, q, k, kv_len, slopes, heads, kv_div, len_div)
    split = lambda z: z.reshape(z.shape[0], -1, heads, e // heads).transpose(1, 2)
    qq = split(q)
    kk, vv = split(k.repeat_interleave(kv_div, 0)), split(v.repeat_interleave(kv_div, 0))
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bias, scale=scale)


def sdpa_fwd_bwd_call(torch, q, k, v, do, kv_len, slopes, scale, heads, kv_div, len_div):
    """SDPA forward + backward through autograd: one PyTorch call each way
    (the attention backward's ``library_ms`` yardstick)."""
    import torch.nn.functional as F

    e = q.shape[2]
    bias = sdpa_bias(torch, q, k, kv_len, slopes, heads, kv_div, len_div)
    split = lambda z: z.reshape(z.shape[0], -1, heads, e // heads).transpose(1, 2)
    qq, kk, vv = (split(z.contiguous()).detach().requires_grad_(True) for z in (q, k, v))
    dout = split(do)

    def run():
        out = F.scaled_dot_product_attention(
            qq, kk.repeat_interleave(kv_div, 0), vv.repeat_interleave(kv_div, 0),
            attn_mask=bias, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)

    return run


# The times of the wmma kernels that gemm_sm90.cu and attention_sm90.cu
# replaced, as PERF.md records them (an NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's as text; the shapes they did not record read
# "not recorded".
WMMA_MS = {
    "gemm_bf16 gene qkv": 3.1149,
    "gemm_wgrad gene qkv": 3.9788,
    "gemm_wgrad encoder qkv, 80000 rows, into a buffer": 0.9883,
    "gemm_dgrad gene qkv": 2.8832,
    "gemm_dgrad ragged M": 0.3577,
    "attention encoder self": 2.8064,
    "attention gene self": 2.1347,
    "attention gene cross": 2.4536,
    # the wmma attention at full lengths (kernel_bench.py on its tree)
    "attention encoder self, full lengths": 4.7595,
    "attention gene self, full lengths": 3.0125,
    "attention gene cross, full lengths": 4.0881,
}


# The times of the attention and LayerNorm backward kernels that
# attention_bwd_sm90.cu and the one-pass layernorm_bwd replaced (the wmma
# attention backward, the two-pass LayerNorm backward), as PERF.md records
# them (an NVIDIA H100 80GB HBM3 at 700 W).
REPLACED_BWD_MS = {
    "attention_bwd gene self": 5.3992,
    "attention_bwd gene cross C=384": 6.6785,
    "attention_bwd gene cross C=1": 2.7430,
    "attention_bwd encoder self": 2.2159,
    "layernorm_bwd gene +2 residuals": 0.4159,
    # timed by kernel_bench.py --group bwd on the tree that still had them
    "layernorm_bwd gene, no residuals": 0.2933,
    "layernorm_bwd encoder E=512, no residuals": 0.1998,
}


def print_vs(name: str, rec: dict, earlier: dict = WMMA_MS,
             kernel: str = "the wmma kernel") -> None:
    """This run's time beside the replaced kernel's, as PERF.md records it."""
    old = earlier.get(name)
    print(f"vs {name}: {rec['ms']:.4f} ms now; {kernel} (PERF.md): "
          + (f"{old} ms" if old else "not recorded"))


def probe_path(torch) -> dict:
    """The capability probes through their entry point on the card
    (``variantformer_tpu_torch.probes.main``); returns the launch counts."""
    from variantformer_tpu_torch import probes
    from variantformer_tpu_torch.ops import kernels

    reset_launches()
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
    # gemm_dgrad: dY [m, n] W[k, n]^T, tiles over (m, k), contraction n
    for m, k, n in ((128, 256, 64), (256, 512, 128), (200, 264, 72), (136, 776, 64),
                    (1000, 1536, 512)):
        dy, w, res = randn(m, n), randn(k, n, scale=n ** -0.5), randn(m, k)
        for r in (None, res):
            compare(torch, f"gemm_dgrad M={m} K={k} N={n}{' +res' if r is not None else ''} "
                    f"{kernels.gemm_plan(m, k, n)}", kernels.gemm_dgrad(dy, w, r),
                    kernels.gemm_dgrad_plain(dy, w, r), GEMM_TOL)
    for rows, k, n in ((64, 128, 128), (128, 256, 512), (200, 136, 264), (64, 128, 1024),
                       (200, 264, 1544), (20000, 256, 1536)):
        x, dy = randn(rows, k), randn(rows, n)
        acc = torch.randn((k, n), generator=gen, device=dev)
        plan = kernels.gemm_plan(k, n, rows, split=True)
        compare(torch, f"gemm_wgrad R={rows} K={k} N={n} into a buffer {plan}",
                kernels.gemm_wgrad(x, dy, out=acc.clone()),
                kernels.gemm_wgrad_plain(x, dy, out=acc.clone()), WGRAD_TOL)
    require(plan.splits > 1, "the last wgrad unit check must split its rows")


def attn_inputs(torch, randn, b, sq, kv_rows, sk, heads, hd, kv_div, cross=False):
    """q, k, v as the main paths lay them out: column slices of one fused
    QKV projection (self-attention), or contiguous queries and the slices of
    a donor-shared K|V (cross-attention; ``cross`` at kv_div 1, the CRE
    stack's)."""
    e = heads * hd
    if kv_div == 1 and not cross:
        qkv = randn(b, sq, 3 * e, scale=2.0)
        return qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    kvt = randn(kv_rows, sk, 2 * e, scale=2.0)
    return randn(b, sq, e, scale=2.0), kvt[..., :e], kvt[..., e:]


def attention_unit_checks(torch) -> None:
    """The TMA + wgmma attention before anything is timed: one query tile
    at each head width, the ragged last tile, kv_len 0, 1 and Sk, a
    donor-shared K/V split over blocks, a single key and four consumer
    warpgroups at each head width; each with and without ALiBi, so that
    every softmax variant the wrapper launches (ALiBi on and off,
    statistics on and off) runs at both block shapes: the serving output
    within 3e-2 of max |plain|, and the ``for_backward`` outputs (lse over
    the rows with a valid key, the renormalised f32 output) within the same
    bound."""
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(torch.bfloat16)
    before = attn_variants()
    # name, B, H, head_dim, Sq, Sk, kv_div, len_div, kv_len
    for name, b, heads, hd, sq, sk, kv_div, len_div, lens in (
        ("one tile hd=64", 1, 8, 64, 64, 64, 1, 1, [64]),
        ("one tile hd=48", 1, 4, 48, 64, 64, 1, 1, [64]),
        ("ragged last tile", 3, 8, 64, 200, 200, 1, 1, [200, 137, 65]),
        ("kv_len 0, 1, Sk", 6, 32, 48, 201, 201, 1, 2, [0, 1, 201]),
        ("cross kv_div=27", 54, 32, 48, 201, 384, 27, 27, [384, 0]),
        ("cross Sk=1", 4, 32, 48, 201, 1, 2, 2, [1, 1]),
        ("four consumers hd=64", 3, 8, 64, 130, 320, 1, 1, [320, 257, 0]),
    ):
        q, k, v = attn_inputs(torch, randn, b, sq, b // kv_div, sk, heads, hd, kv_div)
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        plan = kernels.attention_plan(b, heads, sq, sk, kv_div, head_dim=hd)
        for slopes in (torch.from_numpy(alibi_slopes(heads)).to(dev), None):
            args = (q, k, v, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
            label = (f"attention {name} B={b} H={heads} hd={hd} Sq={sq} Sk={sk} "
                     f"{'ALiBi' if slopes is not None else 'no ALiBi'} {plan}")
            compare(torch, label, kernels.attention(*args), kernels.attention_plain(*args),
                    STACK_TOL)
            got = kernels.attention(*args, for_backward=True)
            want = kernels.attention_plain(*args, for_backward=True)
            live = kv_len.repeat_interleave(len_div) > 0
            compare(torch, f"{label} for_backward out", got[0], want[0], STACK_TOL)
            compare(torch, f"{label} for_backward lse", got[1], want[1], STACK_TOL, valid=live)
            compare(torch, f"{label} for_backward out32", got[2], want[2], STACK_TOL)
    ran = {k: n - before[k] for k, n in attn_variants().items()}
    print(f"attention unit checks: launches by variant {json.dumps(ran)}")
    require(min(ran.values()) > 0, f"attention variants not all launched: {ran}")


def require_zero(t, name: str) -> None:
    peak = t.float().abs().max().item() if t.numel() else 0.0
    require(peak == 0.0, f"{name}: {peak} where exactly 0 is required")


def attn_bwd_zeros(name, lens, kv_rows, kv_div, len_div):
    """The exact zeros of an attention backward's (dq, dk, dv): keys past
    every kv_len of a K/V row's query rows get zero dK and dV; a K/V row
    whose query rows have no valid key gets zero dK (they average V)."""
    groups = [[lens[(r * kv_div + j) // len_div] for j in range(kv_div)] for r in range(kv_rows)]

    def zeros(out):
        _, dk, dv = out
        for r, group in enumerate(groups):
            if min(group) > 0:
                require_zero(dk[r, max(group):], f"{name} dk past kv_len, row {r}")
                require_zero(dv[r, max(group):], f"{name} dv past kv_len, row {r}")
            elif max(group) == 0:
                require_zero(dk[r], f"{name} dk of a row with no valid key, row {r}")

    return zeros


def attn_bwd_buffers(torch, b, sq, kv_rows, sk, e, kv_div, dtype):
    """(dq, dk, dv) buffers as the main paths hand them over: slices of one
    bf16 d(QKV) for a self-attention, slices of one d(K|V) of ``dtype`` for
    a cross-attention (dq then defaults); f32 self-attention cotangents
    default too."""
    dev = torch.device("cuda")
    if kv_div == 1 and sq == sk and dtype == torch.bfloat16:
        dqkv = torch.empty((b, sq, 3 * e), dtype=dtype, device=dev)
        return dqkv[..., :e], dqkv[..., e:2 * e], dqkv[..., 2 * e:]
    if kv_div == 1 and dtype == torch.float32:
        return None, None, None
    dkv = torch.empty((kv_rows, sk, 2 * e), dtype=dtype, device=dev)
    return None, dkv[..., :e], dkv[..., e:]


def attention_bwd_unit_checks(torch) -> None:
    """The TMA + wgmma attention backward before anything is timed: one key
    tile at each head width, Sk 63, 64, 65 and 384, kv_len 0 and 1, a
    donor-shared K/V (kv_div 54) split over blocks at Sk 384, 65 and 1, a
    self-attention split over blocks, dk/dv in bf16 and f32; each output
    within 3e-2 of max(max |plain|, 1) and exact zeros past kv_len; at Sk =
    1, where dq and dk are 0 in exact arithmetic, those also within
    NOISE_FACTOR x the plain version's rounding noise (``compare_noise``)."""
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(torch.bfloat16)
    f32, bf = torch.float32, torch.bfloat16
    # name, B, H, head_dim, Sq, Sk, kv_div, len_div, kv_len, ALiBi, dk/dv type
    for name, b, heads, hd, sq, sk, kv_div, len_div, lens, alibi, dtype in (
        ("one tile hd=64", 1, 8, 64, 64, 64, 1, 1, [64], True, f32),
        ("one tile hd=48", 1, 4, 48, 64, 64, 1, 1, [64], True, bf),
        ("Sk=63", 3, 8, 64, 63, 63, 1, 1, [63, 40, 1], True, f32),
        ("Sk=65 kv_len 0", 3, 8, 48, 65, 65, 1, 1, [65, 64, 0], True, bf),
        ("kv_len 0, 1, Sk", 6, 32, 48, 201, 201, 1, 2, [0, 1, 201], True, bf),
        ("self split over blocks", 1, 1, 64, 200, 200, 1, 1, [150], True, f32),
        ("cross kv_div=54 Sk=384", 108, 32, 48, 201, 384, 54, 54, [384, 0], False, f32),
        ("cross kv_div=54 Sk=65", 108, 8, 64, 70, 65, 54, 54, [1, 65], False, bf),
        ("cross kv_div=54 Sk=1", 108, 32, 48, 201, 1, 54, 54, [1, 1], False, f32),
        ("cross kv_div=54 Sk=1 bf16", 108, 32, 48, 201, 1, 54, 54, [1, 0], False, bf),
    ):
        e = heads * hd
        kv_rows = b // kv_div
        q, k, v = attn_inputs(torch, randn, b, sq, kv_rows, sk, heads, hd, kv_div)
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        _, lse, o = kernels.attention(q, k, v, kv_len, slopes, hd ** -0.5, heads, kv_div,
                                      len_div, for_backward=True)
        do = randn(b, sq, e)
        args = (q, k, v, o, lse, do, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
        dq, dk, dv = attn_bwd_buffers(torch, b, sq, kv_rows, sk, e, kv_div, dtype)
        got = kernels.attention_bwd(*args, dq=dq, dk=dk, dv=dv)
        torch.cuda.synchronize()
        want = kernels.attention_bwd_plain(*args)
        plan = kernels.attention_bwd_plan(b, heads, sq, sk, kv_div)
        label = (f"attention_bwd {name} B={b} H={heads} hd={hd} Sq={sq} Sk={sk} kv_div={kv_div} "
                 f"dk/dv {str(got[1].dtype)[6:]} {plan}")
        for i, part in enumerate(("dq", "dk", "dv")):
            compare(torch, f"{label} {part}", got[i], want[i], STACK_TOL, floor=1.0)
            if sk == 1 and part != "dv":
                compare_noise(torch, f"{label} {part}", got[i], want[i])
        attn_bwd_zeros(label, lens, kv_rows, kv_div, len_div)(got)


def attention_chunk_checks(torch) -> None:
    """The attention forward and backward past their key caps (the forward
    holds at most ATTN_MAX_KEYS keys of K and V, the dQ pass
    ATTN_BWD_MAX_KEYS), walked in key chunks: Sk 577 to 2048, kv_div 1 and
    54, head dim 48 and 64, kv_len 0, 1, Sk, mid-chunk and exactly at a
    chunk boundary; each output, serving and ``for_backward``, within 3e-2
    of max |plain| (the backward's of max(max |plain|, 1)) and exact zeros
    past kv_len. Then the chunked
    walk forced at the main path's 384 keys (chunks of 128) against the
    one-chunk launch: the same bits, forward and backward."""
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(torch.bfloat16)
    f32, bf = torch.float32, torch.bfloat16
    # name, B, H, head_dim, Sq, Sk, kv_div, len_div, kv_len, ALiBi, dk/dv type
    cases = (
        ("self Sk=577", 2, 4, 48, 577, 577, 1, 1, [577, 0], True, bf),
        ("self Sk=640", 2, 8, 64, 640, 640, 1, 1, [640, 1], True, f32),
        ("cross Sk=769 at the chunk boundary", 108, 4, 48, 201, 769, 54, 54, [769, 448], False,
         f32),
        ("cross Sk=832 mid-chunk", 108, 4, 64, 130, 832, 54, 54, [700, 0], False, bf),
        ("self Sk=1024 at the chunk boundary", 3, 4, 64, 1024, 1024, 1, 1, [1024, 512, 1], True,
         bf),
        ("cross Sk=1024", 108, 8, 48, 201, 1024, 54, 54, [1024, 300], False, f32),
        ("self Sk=2048 mid-chunk", 2, 2, 64, 2048, 2048, 1, 1, [2048, 1500], True, f32),
        ("cross Sk=2048 at the forward's chunk boundary", 108, 4, 48, 201, 2048, 54, 54,
         [704, 0], False, f32),
        ("cross Sk=2048 at the dQ chunk boundary", 108, 2, 64, 70, 2048, 54, 54, [1536, 1],
         False, bf),
    )
    for name, b, heads, hd, sq, sk, kv_div, len_div, lens, alibi, dtype in cases:
        e = heads * hd
        kv_rows = b // kv_div
        q, k, v = attn_inputs(torch, randn, b, sq, kv_rows, sk, heads, hd, kv_div)
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        args = (q, k, v, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
        plan = kernels.attention_plan(b, heads, sq, sk, kv_div)
        bplan = kernels.attention_bwd_plan(b, heads, sq, sk, kv_div)
        require(plan.chunks > 1 or bplan.dq_chunks > 1, f"{name}: no chunked walk")
        label = (f"attention chunks {name} B={b} H={heads} hd={hd} Sq={sq} kv_div={kv_div} "
                 f"({plan.chunks} x {plan.chunk_keys} keys; dQ {bplan.dq_chunks} x "
                 f"{bplan.dq_chunk_keys})")
        compare(torch, f"{label} serving out", kernels.attention(*args),
                kernels.attention_plain(*args), STACK_TOL)
        got = kernels.attention(*args, for_backward=True)
        want = kernels.attention_plain(*args, for_backward=True)
        live = kv_len.repeat_interleave(len_div) > 0
        compare(torch, f"{label} out", got[0], want[0], STACK_TOL)
        compare(torch, f"{label} lse", got[1], want[1], STACK_TOL, valid=live)
        compare(torch, f"{label} out32", got[2], want[2], STACK_TOL)
        _, lse, o = got
        del got, want
        do = randn(b, sq, e)
        bargs = (q, k, v, o, lse, do, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
        dq, dk, dv = attn_bwd_buffers(torch, b, sq, kv_rows, sk, e, kv_div, dtype)
        got = kernels.attention_bwd(*bargs, dq=dq, dk=dk, dv=dv)
        torch.cuda.synchronize()
        want = kernels.attention_bwd_plain(*bargs)
        for i, part in enumerate(("dq", "dk", "dv")):
            compare(torch, f"{label} backward {part}", got[i], want[i], STACK_TOL, floor=1.0)
        attn_bwd_zeros(label, lens, kv_rows, kv_div, len_div)(got)
        del q, k, v, o, lse, do, got, want, dq, dk, dv

    # The main path's gene cross-attention (384 keys, one chunk) and its
    # single CRE slot: the chunked walk forced at 128 keys gives the same bits.
    for sk, lens in ((384, [384, 300, 1, 2]), (1, [1, 1, 1, 1])):
        b, heads, hd, sq, kv_div = 216, 32, 48, 201, 54
        e = heads * hd
        q, k, v = attn_inputs(torch, randn, b, sq, b // kv_div, sk, heads, hd, kv_div)
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        args = (q, k, v, kv_len, None, hd ** -0.5, heads, kv_div, kv_div)
        one = kernels.attention(*args, for_backward=True)
        forced = kernels.attention(*args, for_backward=True, max_keys=128)
        do = randn(b, sq, e)
        bargs = (q, k, v, one[2], one[1], do, kv_len, None, hd ** -0.5, heads, kv_div, kv_div)
        bone = kernels.attention_bwd(*bargs)
        bforced = kernels.attention_bwd(*bargs, max_keys=128)
        chunks = (kernels.attention_plan(b, heads, sq, sk, kv_div, max_keys=128).chunks,
                  kernels.attention_bwd_plan(b, heads, sq, sk, kv_div, max_keys=128).dq_chunks)
        require(kernels.attention_plan(b, heads, sq, sk, kv_div).chunks == 1
                and kernels.attention_bwd_plan(b, heads, sq, sk, kv_div).dq_chunks == 1,
                f"Sk={sk}: the main path's call is chunked")
        for part, x, y in zip(("out", "lse", "out32", "dq", "dk", "dv"), (*one, *bone),
                              (*forced, *bforced)):
            require(torch.equal(x, y), f"attention Sk={sk} {part}: chunks of 128 keys differ "
                                       "from the one-chunk launch")
        print(f"check attention Sk={sk} (gene cross, kv_div={kv_div}): forward and backward "
              f"walked in {chunks[0]} / {chunks[1]} chunks of 128 keys give the one-chunk "
              "launch's bits (out, lse, out32, dq, dk, dv)")
        del q, k, v, one, forced, do, bone, bforced


def attention_wide_checks(torch) -> None:
    """The attention forward and backward at head dim 128 (two 64-column TMA
    boxes a head tile; ATTN_MAX_KEYS_WIDE and ATTN_BWD_MAX_KEYS_WIDE keys a
    launch) before anything is timed: Sk 1, 63, 64, 65 and 200 (the
    encoder's windows), kv_len 0, 1 and Sk, kv_div 1 and 54, dk/dv in bf16
    and f32, and Sk 384 and 704 past the one-launch caps (key chunks); the
    serving output with and without ALiBi and the ``for_backward`` ones,
    each within 3e-2 of max |plain| (the backward's of max(max |plain|,
    1)), exact zeros past kv_len, and at Sk 1 dq and dk within
    NOISE_FACTOR x the plain version's noise. Then the chunked walk forced at
    Sk=200 (chunks of 128 keys) against the one-launch call: the same bits,
    forward and backward."""
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(torch.bfloat16)
    f32, bf = torch.float32, torch.bfloat16
    hd = 128
    # name, B, H, Sq, Sk, kv_div, len_div, kv_len, ALiBi, dk/dv type
    cases = (
        ("cross Sk=1", 108, 4, 201, 1, 54, 54, [1, 1], False, f32),
        ("Sk=63", 3, 4, 63, 63, 1, 1, [63, 40, 1], True, f32),
        ("Sk=64 kv_len 0", 3, 4, 64, 64, 1, 1, [64, 0, 1], True, bf),
        ("Sk=65", 3, 8, 65, 65, 1, 1, [65, 64, 0], True, bf),
        ("encoder windows Sk=200 kv_len 0, 1, Sk", 64, 4, 200, 200, 1, 1,
         [0, 1, 200] + [17 + 3 * i for i in range(61)], True, bf),
        ("cross kv_div=54 Sk=200", 108, 4, 70, 200, 54, 54, [200, 0], False, f32),
        ("self Sk=384 past the caps", 2, 4, 384, 384, 1, 1, [384, 321], True, f32),
        ("cross kv_div=54 Sk=704 past the caps", 108, 2, 130, 704, 54, 54, [704, 320], False, bf),
    )
    for name, b, heads, sq, sk, kv_div, len_div, lens, alibi, dtype in cases:
        e = heads * hd
        kv_rows = b // kv_div
        q, k, v = attn_inputs(torch, randn, b, sq, kv_rows, sk, heads, hd, kv_div)
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        args = (q, k, v, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
        plan = kernels.attention_plan(b, heads, sq, sk, kv_div, head_dim=hd)
        bplan = kernels.attention_bwd_plan(b, heads, sq, sk, kv_div, head_dim=hd)
        label = (f"attention hd=128 {name} B={b} H={heads} Sq={sq} kv_div={kv_div} "
                 f"({plan.chunks} x {plan.chunk_keys} keys, {plan.consumers} consumers; dQ "
                 f"{bplan.dq_chunks} x {bplan.dq_chunk_keys}, dK/dV {bplan.consumers} consumers)")
        for sl in (slopes, None if alibi else torch.from_numpy(alibi_slopes(heads)).to(dev)):
            sargs = (q, k, v, kv_len, sl, hd ** -0.5, heads, kv_div, len_div)
            compare(torch, f"{label} serving out {'ALiBi' if sl is not None else 'no ALiBi'}",
                    kernels.attention(*sargs), kernels.attention_plain(*sargs), STACK_TOL)
        got = kernels.attention(*args, for_backward=True)
        torch.cuda.synchronize()
        want = kernels.attention_plain(*args, for_backward=True)
        live = kv_len.repeat_interleave(len_div) > 0
        compare(torch, f"{label} out", got[0], want[0], STACK_TOL)
        compare(torch, f"{label} lse", got[1], want[1], STACK_TOL, valid=live)
        compare(torch, f"{label} out32", got[2], want[2], STACK_TOL)
        _, lse, o = got
        del got, want
        do = randn(b, sq, e)
        bargs = (q, k, v, o, lse, do, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
        dq, dk, dv = attn_bwd_buffers(torch, b, sq, kv_rows, sk, e, kv_div, dtype)
        got = kernels.attention_bwd(*bargs, dq=dq, dk=dk, dv=dv)
        torch.cuda.synchronize()
        want = kernels.attention_bwd_plain(*bargs)
        for i, part in enumerate(("dq", "dk", "dv")):
            compare(torch, f"{label} backward {part}", got[i], want[i], STACK_TOL, floor=1.0)
            if sk == 1 and part != "dv":
                compare_noise(torch, f"{label} backward {part}", got[i], want[i])
        attn_bwd_zeros(label, lens, kv_rows, kv_div, len_div)(got)
        require(sk <= kernels.ATTN_MAX_KEYS_WIDE or (plan.chunks > 1 and bplan.dq_chunks > 1),
                f"{label}: past the caps without key chunks")
        del q, k, v, o, lse, do, got, want, dq, dk, dv

    # The encoder's 200 keys fit one launch; walked in chunks of 128 keys the
    # forward and the dQ pass give its bits.
    b, heads, sq = 64, 4, 200
    e = heads * hd
    q, k, v = attn_inputs(torch, randn, b, sq, b, sq, heads, hd, 1)
    lens = [0, 1, 128, 129, 200] + [3 * i + 5 for i in range(b - 5)]
    kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(heads)).to(dev)
    args = (q, k, v, kv_len, slopes, hd ** -0.5, heads)
    require(kernels.attention_plan(b, heads, sq, sq, head_dim=hd).chunks == 1
            and kernels.attention_bwd_plan(b, heads, sq, sq, head_dim=hd).dq_chunks == 1,
            "hd=128 Sk=200: the encoder's call is chunked")
    one = kernels.attention(*args, for_backward=True)
    forced = kernels.attention(*args, for_backward=True, max_keys=128)
    do = randn(b, sq, e)
    bargs = (q, k, v, one[2], one[1], do, kv_len, slopes, hd ** -0.5, heads)
    bone = kernels.attention_bwd(*bargs)
    bforced = kernels.attention_bwd(*bargs, max_keys=128)
    for part, x, y in zip(("out", "lse", "out32", "dq", "dk", "dv"), (*one, *bone),
                          (*forced, *bforced)):
        require(torch.equal(x, y), f"attention hd=128 Sk=200 {part}: chunks of 128 keys differ "
                                   "from the one-launch call")
    print("check attention hd=128 Sk=200 (encoder self, kv_len 0, 1, 128, 129, 200, ...): "
          "forward and backward walked in 2 / 2 chunks of 128 keys give the one-launch call's "
          "bits (out, lse, out32, dq, dk, dv)")


def layernorm_unit_checks(torch) -> None:
    """The LayerNorm forward before anything is timed: the register-resident
    kernel at the main paths' widths (1536, 512) and at 2048, on 1 and 7
    rows and the main paths' row counts, and the general kernel (E=1000);
    each within 3e-2 of max |plain|, where a bf16 ulp is ~0.4% of it."""
    from variantformer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for rows, e in ((1, 1536), (7, 1536), (43416, 1536), (307200, 512), (7, 512), (1, 2048),
                    (4099, 2048), (7, 1000), (43416, 1000)):
        x = (torch.randn((rows, e), generator=gen, device=dev) * 3.0 + 0.5).to(torch.bfloat16)
        sc = torch.rand(e, generator=gen, device=dev) + 0.5
        bi = torch.randn(e, generator=gen, device=dev) * 0.1
        plan = kernels.layernorm_plan(rows, e)
        compare(torch, f"layernorm [{rows},{e}] {plan}", kernels.layernorm(x, sc, bi),
                kernels.layernorm_plain(x, sc, bi), STACK_TOL)


# The weight gradients whose rows the plan splits, at a training step's
# shapes (2 genes: 2 x 54 x 201 gene rows, 400 x 200 gene-window tokens):
# label, rows, K, N.
WGRAD_SPLIT_SHAPES = (
    ("gene out-proj", 2 * 54 * 201, 1536, 1536),
    ("gene ffn_in", 2 * 54 * 201, 1536, 2048),
    ("gene ffn_out", 2 * 54 * 201, 1024, 1536),
    ("encoder out-proj", 400 * 200, 512, 512),
    ("encoder ffn_out", 400 * 200, 1024, 512),
)


def wgrad_reproducibility_checks(torch) -> None:
    """``gemm_wgrad`` twice on the same inputs into the same non-zero
    buffer at every split shape: the same bits (the splits' partials are
    summed in split order), and within 1e-3 of max |plain|."""
    from variantformer_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for label, rows, k, n in WGRAD_SPLIT_SHAPES:
        x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn((rows, n), generator=gen, device=dev).to(torch.bfloat16)
        acc = torch.randn((k, n), generator=gen, device=dev)
        plan = kernels.gemm_plan(k, n, rows, split=True)
        require(plan.splits > 1, f"gemm_wgrad {label}: the rows are not split")
        first = kernels.gemm_wgrad(x, dy, out=acc.clone())
        second = kernels.gemm_wgrad(x, dy, out=acc.clone())
        require(torch.equal(first, second), f"gemm_wgrad {label}: two calls differ")
        compare(torch, f"gemm_wgrad {label} R={rows} K={k} N={n} {plan}, twice: same bits",
                first, kernels.gemm_wgrad_plain(x, dy, out=acc.clone()), WGRAD_TOL)


def sass_counts(lib_dir: str) -> None:
    """HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync, wmma)
    instructions in the built GEMM, attention and probe libraries, where the
    toolkit has cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found; instruction counts skipped")
        return
    for lib, need in (("gemm_sm90.so", ("HGMMA", "UTMALDG")),
                      ("attention_sm90.so", ("HGMMA", "UTMALDG")),
                      ("attention_bwd_sm90.so", ("HGMMA", "UTMALDG")), ("probes.so", ("HGMMA",))):
        sass = subprocess.run([tool, "-sass", str(Path(lib_dir) / lib)], check=True,
                              capture_output=True, text=True).stdout
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in ("HGMMA", "UTMALDG", "HMMA")}
        print(f"sass {lib}: {json.dumps(counts)}")
        for op in need:
            require(counts[op] > 0, f"{lib}: no {op} instruction")
        require(counts["HMMA"] == 0, f"{lib}: mma.sync (wmma) instructions left")
        if lib == "attention_sm90.so":
            attention_sass_counts(sass)
    # The LayerNorm forward's global loads, by kernel: the register-resident
    # one must read its rows, scale and bias by 16-byte loads only.
    sass = subprocess.run([tool, "-sass", str(Path(lib_dir) / "rowwise.so")], check=True,
                          capture_output=True, text=True).stdout
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if "layernorm_kernel" not in name and "layernorm_rows_kernel" not in name:
            continue
        loads = [line for line in fn.splitlines() if " LDG." in line]
        wide = sum(".128" in line for line in loads)
        print(f"sass rowwise.so {name}: {len(loads)} LDG, {wide} of them LDG.E.128")
        if "layernorm_rows_kernel" in name:
            require(wide == len(loads) > 0, f"{name}: a global load narrower than 16 bytes")


def attention_sass_counts(sass: str) -> None:
    """HGMMA, I2F and MUFU.EX2 of each attention forward instantiation
    (head dim, consumers, chunked, ALiBi, statistics). The key walk runs from
    the first ``WARPGROUP.ARRIVE`` to the last ``WARPGROUP.DEPBAR``; its
    int-to-float conversions (``I2F``, ``I2FP``; ``I2F.RP`` is integer
    division) must be none without ALiBi and fewer than a tile's 32 scores
    with it (one a tile per row half), so that no score pays for one."""
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        m = re.search(r"attention_sm90_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)E", name)
        if not m:
            continue
        hd, nc, chunked, alibi, stats = (int(x) for x in m.groups())
        ops = [line.split("*/", 1)[1].split(";")[0].strip() for line in fn.splitlines()
               if re.search(r"/\*[0-9a-f]{4,}\*/", line)]
        arrive = [i for i, op in enumerate(ops) if op.startswith("WARPGROUP.ARRIVE")]
        depbar = [i for i, op in enumerate(ops) if op.startswith("WARPGROUP.DEPBAR")]
        walk = ops[arrive[0]:depbar[-1] + 1] if arrive and depbar else []
        conv = sum(op.startswith("I2F") and ".RP" not in op.split()[0] for op in walk)
        counts = {"HGMMA": sum(op.startswith("HGMMA") for op in ops),
                  "DEPBAR": len(depbar), "I2F in walk": conv,
                  "MUFU.EX2": sum(op.startswith("MUFU.EX2") for op in ops)}
        print(f"sass attention hd={hd} consumers={nc} chunked={chunked} alibi={alibi} "
              f"stats={stats}: {json.dumps(counts)}")
        require(walk, f"attention hd={hd} consumers={nc}: no wgmma walk found")
        require(conv == 0 if not alibi else conv < 32,
                f"attention hd={hd} consumers={nc} alibi={alibi} stats={stats}: {conv} "
                "int-to-float conversions in the key walk")


def attention_ptxas(log: str) -> None:
    """Registers and spill bytes of each attention forward instantiation,
    from ptxas's report (an entry's properties follow its name)."""
    pat = r"attention_sm90_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)E"
    name = spill = None
    for line in log.splitlines():
        m = re.search(pat, line)
        if m and "Function properties" in line:
            name = "hd={} consumers={} chunked={} alibi={} stats={}".format(*m.groups())
        elif name and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            print(f"ptxas attention {name}: {line.split('Used')[1].split(',')[0].strip()}, "
                  f"{spill}")
            name = None


def attn_variants() -> dict:
    """``kernels.ATTN_VARIANTS`` with printable keys."""
    from variantformer_tpu_torch.ops import kernels

    return {f"alibi={int(k.alibi)} stats={int(k.stats)}": n
            for k, n in kernels.ATTN_VARIANTS.items()}


def kernel_checks(torch, checks: Checks) -> None:
    import torch.nn.functional as F

    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes
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
        print_vs(name, rec)

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
    sdpa = functools.partial(sdpa_call, torch)

    def attn_case(name, b, sq, kv_rows, sk, heads, hd, kv_len, alibi, kv_div, len_div,
                  record, cross=False):
        q, k, v = attn_inputs(torch, randn, b, sq, kv_rows, sk, heads, hd, kv_div, cross)
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev) if alibi else None
        scale = hd ** -0.5
        args = (q, k, v, kv_len, slopes, scale, heads, kv_div, len_div)
        flops, nbytes = attn_cost(kv_len.tolist(), len_div, kv_div, b, sq, sk, heads, hd)
        rec = checks.run(
            name, lambda: kernels.attention(*args), lambda: kernels.attention_plain(*args),
            sdpa(*args), flops, nbytes, record=record,
            meta={"shape": f"B={b} H={heads} Sq={sq} Sk={sk} hd={hd} kv_div={kv_div}, "
                           f"kv_len {'full' if 'full' in name else 'mixed'}"},
        )
        print(f"plan {name}: {kernels.attention_plan(b, heads, sq, sk, kv_div)}")
        print_vs(name, rec)

    # The three uses at the checks' mixed lengths (0, 1 and short rows) and
    # at the main path's full ones (tok_len 200, gene length 201, 384 CREs).
    hd_enc, hd_mod = e_enc // we.num_heads, e_mod // mc.num_heads
    enc_len = torch.randint(1, length + 1, (n_cre,), generator=gen, device=dev,
                            dtype=torch.int32)
    enc_len[:4] = torch.tensor([0, 1, 2, length], device=dev, dtype=torch.int32)
    full = lambda n, v: torch.full((n,), v, device=dev, dtype=torch.int32)
    for suffix, lens in (("", enc_len), (", full lengths", full(n_cre, length))):
        name = "attention encoder self" + suffix
        attn_case(name, n_cre, length, n_cre, length, we.num_heads, hd_enc, lens, True, 1, 1,
                  record=name)
    gene_len = torch.tensor([201, 150, 1, 77], device=dev, dtype=torch.int32)
    for suffix, lens in (("", gene_len), (", full lengths", full(d4, g1))):
        name = "attention gene self" + suffix
        attn_case(name, d4 * t, g1, d4 * t, g1, mc.num_heads, hd_mod, lens, True, 1, t,
                  record=name if suffix else "attention")
    cre_len = torch.tensor([384, 300, 1, 2], device=dev, dtype=torch.int32)
    for suffix, lens in (("", cre_len), (", full lengths", full(d4, c))):
        name = "attention gene cross" + suffix
        attn_case(name, d4 * t, g1, d4, c, mc.num_heads, hd_mod, lens, False, t, t,
                  record=name)
    # a gene with 1024 CREs: past the one-chunk key limit, walked in chunks
    name = "attention gene cross C=1024, full lengths"
    attn_case(name, d4 * t, g1, d4, 1024, mc.num_heads, hd_mod, full(d4, 1024), False, t, t,
              record=name)
    # the CRE stack's two uses: ALiBi self-attention over the q|k|v slices
    # of its fused QKV, and cross-attention of contiguous queries to the
    # K|V slices of its context rows, each over the donor's CRE slots
    for suffix, lens in (("", cre_len), (", full lengths", full(d4, c))):
        for use, alibi in (("self", True), ("cross", False)):
            name = f"attention cre {use}{suffix}"
            attn_case(name, d4, c, d4, c, mc.num_heads, hd_mod, lens, alibi, 1, 1, record=name,
                      cross=use == "cross")

    # --- window-encoder stack (K1) -------------------------------------------
    ini = ParamInit(SEED + 1, dev, torch.float32)
    enc_layers = ini.plain_layer_stack(we.num_layers, e_enc, we.ffn_hidden_dim)
    enc_packed = pack_encoder_layers(enc_layers, we.num_heads, bf)
    enc_slopes = torch.from_numpy(alibi_slopes(we.num_heads)).to(dev)
    enc_w_bytes = sum(v.numel() * v.element_size() for v in enc_packed.values())

    def encoder_case(name, n, record=None, valid=None, meta=None):
        """``valid``: rows past it have tok_len 0 (a dedup pool's padding
        rows, whose outputs are 0 whatever is computed); the bound counts
        the rows before it only."""
        x = randn(n, length, e_enc)
        lens = torch.randint(1, length + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        lens[:3] = torch.tensor([0, 1, length], device=dev, dtype=torch.int32)
        nv = n if valid is None else valid
        lens[nv:] = 0
        args = (x, lens, enc_packed, enc_slopes, (e_enc // we.num_heads) ** -0.5, we.num_heads)
        rows = nv * length
        gemm_flops = 2.0 * rows * (e_enc * 3 * e_enc + e_enc * e_enc
                                   + e_enc * we.ffn_hidden_dim + we.ffn_hidden_dim // 2 * e_enc)
        a_flops, _ = attn_cost(lens[:nv].tolist(), 1, 1, nv, length, length, we.num_heads,
                               e_enc // we.num_heads)
        flops = we.num_layers * (gemm_flops + a_flops)
        nbytes = 2.0 * (rows * e_enc + n * e_enc) + 4.0 * n + enc_w_bytes
        checks.run(
            name, lambda: fused_window_encoder(*args), lambda: fused_window_encoder_plain(*args),
            None, flops, nbytes, record=record,
            meta={"shape": f"N={n} L={length} E={e_enc} layers={we.num_layers}"
                           + (f", {nv} rows with tokens" if valid is not None else ""),
                  **(meta or {})},
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

    def modulator_case(name, d, g1_, c_, gene_lens, cre_lens, record=None, t=t, meta=None):
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
            meta={"shape": f"D={d} T={t} G1={g1_} C={c_} E={e_mod} layers={mc.num_layers}",
                  **(meta or {})},
        )

    modulator_case("fused_gene_modulator D=2 G1=201 C=384", 2, g1, c, [201, 120], [384, 1])
    modulator_case("fused_gene_modulator D=2 short G1=37 C=1", 2, 37, 1, [37, 5], [1, 1])
    modulator_case("fused_gene_modulator main path D=4", d4, g1, c, [201, 201, 150, 201],
                   [384, 384, 300, 384], record="fused_gene_modulator")

    # The VEP path's shapes: the window-dedup pools (C+64 and G+64 rows; a
    # triple's 384 + 2 unique CRE windows and 200 + 2 gene windows, the rest
    # pool padding with tok_len 0), and the gene stack of a ref/het/hom
    # triple (D=3) and a het/hom pair (D=2) at T=54, and a triple at T=2
    # (the cross-attention's kv_div 2; M = 3 x 2 x 201 = 1206 GEMM rows).
    vep = {"path": "vep"}
    for name, n, nv in (("fused_window_encoder vep CRE pool", c + 64, c + 2),
                        ("fused_window_encoder vep gene pool", g1 - 1 + 64, g1 + 1)):
        encoder_case(f"{name} N={n}", n, record=f"{name} N={n}", valid=nv, meta=vep)
    for name, d, t_ in (("fused_gene_modulator vep triple D=3 T=54", 3, t),
                        ("fused_gene_modulator vep pair D=2 T=54", 2, t),
                        ("fused_gene_modulator vep triple D=3 T=2", 3, 2)):
        modulator_case(name, d, g1, c, [g1] * d, [c] * d, record=name, t=t_, meta=vep)

    # The sweeps' shapes: a saturation-scan dispatch of 16 donors (8 het/hom
    # pairs, no pools) encodes 16 x 384 CRE windows and 16 x 200 gene
    # windows and runs the gene stack at D=16 T=54; the live app sends one
    # gene at every tissue of the vocabulary (D=1 T=63), AD risk one tissue a
    # row (D=1 T=1).
    sweeps = {"path": "sweeps"}
    for name, n in (("fused_window_encoder scan CRE windows", 16 * c),
                    ("fused_window_encoder scan gene windows", 16 * (g1 - 1))):
        encoder_case(f"{name} N={n}", n, record=f"{name} N={n}", meta=sweeps)
    for name, d, t_ in (("fused_gene_modulator scan D=16 T=54", 16, t),
                        (f"fused_gene_modulator live D=1 T={VOCAB_TISSUES}", 1, VOCAB_TISSUES),
                        ("fused_gene_modulator ad risk D=1 T=1", 1, 1)):
        modulator_case(name, d, g1, c, [g1] * d, [c] * d, record=name, t=t_, meta=sweeps)
    del mod_packed

    # --- the CRE stack's chain (vfx_torch::cre_stack) --------------------------
    cre_stack_checks(torch, checks, randn)


def cre_stack_checks(torch, checks: Checks, randn) -> None:
    """The op ``vfx_torch::cre_stack`` on the card (the kernel chain) against
    ``cre_stack_plain`` (the chain on the kernels' plain versions) at full
    width, 4 donors x 384 CRE slots with 384 / 300 / 1 / 2 valid, over the
    valid rows: the main path's 24 layers of 32 heads of 48, then at the
    variants path's 7 layers each other head-dim class the route admits
    (48 heads of 32 on 64 lanes, 16 of 96 on 128 lanes, 12 of 128); one
    chain launch a call."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import ParamInit
    from variantformer_tpu_torch.ops import cre_stack as CS
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes
    from variantformer_tpu_torch.ops.fused_encoder import head_lanes
    from variantformer_tpu_torch.ops.fused_modulator import PACKED, pack_gene_layers

    dev = torch.device("cuda")
    mc = ModelConfig().seq2gene
    e, ffn, d, c = mc.emb_dim, mc.ffn_hidden_dim, 4, 384
    lens = [384, 300, 1, 2]
    cre_len = torch.tensor(lens, device=dev, dtype=torch.int32)
    ini = ParamInit(SEED + 2, dev, torch.float32)
    for heads, layers, record in ((mc.num_heads, mc.num_layers - 1, "cre_stack"),
                                  (48, 7, "cre_stack hd=32 (64 lanes) 7 layers"),
                                  (16, 7, "cre_stack hd=96 (128 lanes) 7 layers"),
                                  (12, 7, "cre_stack hd=128 7 layers")):
        hd = e // heads
        packed = pack_gene_layers(ini.context_layer_stack(layers, e, ffn), heads,
                                  torch.bfloat16)
        x, ctx = randn(d, c, e), randn(d, c, e)
        slopes = torch.from_numpy(alibi_slopes(heads)).to(dev)
        args = (x, ctx, cre_len, packed, slopes, heads, hd)
        rows = d * c
        gemm_flops = 2.0 * rows * (7 * e * e + e * ffn + ffn // 2 * e)
        sa, _ = attn_cost(lens, 1, 1, d, c, c, heads, hd)
        flops = layers * (gemm_flops + 2 * sa)
        w_bytes = sum(packed[k].numel() * packed[k].element_size() for k in PACKED)
        nbytes = 2.0 * rows * e * (layers + 2) + w_bytes
        valid = torch.zeros((layers + 1, d, c), dtype=torch.bool, device=dev)
        for i, n in enumerate(lens):
            valid[:, i, :n] = True
        before = kernels.LAUNCHES["cre_stack"]
        with torch.inference_mode():
            rec = checks.run(
                record, lambda: CS.cre_stack(*args), lambda: CS.cre_stack_plain(*args), None,
                flops, nbytes, valid=valid, record=record,
                meta={"shape": f"D={d} C={c} E={e} H={heads} hd={hd} layers={layers}, "
                               f"cre_len {lens}"},
            )
        calls = kernels.LAUNCHES["cre_stack"] - before
        require(calls == ITERS + 2, f"{record}: {calls} chain launches for {ITERS + 2} calls")
        print(f"cre_stack chain vs plain, hd {hd} on {head_lanes(hd)} lanes, {layers} "
              f"layers: max abs err {rec['max_abs_err']:.6g}; {card()}")
        del packed, x, ctx, valid


def graphs_path(torch) -> dict:
    """The inference ops replayed as CUDA graphs against their eager chains
    at full v4_pcg width (the module docstring's graphs path). Returns the
    record it prints."""
    from variantformer_tpu_torch import bench
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward
    from variantformer_tpu_torch.ops import graphs, kernels

    cfg = ModelConfig()
    dev = torch.device("cuda")
    vocab, length, t = cfg.window_encoder.vocab_size, cfg.dataset.max_length, 54
    params = bench.packed_params(cfg, init_seq2gene(cfg, SEED, device=dev,
                                                    dtype=torch.bfloat16))
    outputs = ("pred_expression", "pooled_embedding")
    streams = outputs + ("gene_stream", "cre_stream")

    def batch_at(c: int, g: int, seed: int, ragged: bool):
        b = bench.example_batch(4, c, g, length, t, vocab, rng_seed=seed, device=dev)
        if not ragged:
            return b
        gen = torch.Generator(device=dev).manual_seed(seed)
        as_int = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        return b._replace(
            cre_count=as_int([c, max(c - 17, 1), 16, c // 2]),
            gene_count=as_int([g, g - 50, 1, g // 3]),
            cre_tok_len=torch.randint(1, length + 1, (4, c), generator=gen, device=dev,
                                      dtype=torch.int32),
            gene_tok_len=torch.randint(1, length + 1, (4, g), generator=gen, device=dev,
                                       dtype=torch.int32))

    class Eager:
        """Each op's chain as it is, in place of the graph cache."""

        def run(self, op, chain, inputs, weights, scalars):
            return chain(*inputs)

    def forward(p, batch, graphed: bool, names=outputs) -> tuple[dict, float, int, int]:
        """One forward: its outputs, seconds (synchronised) and peak memory
        allocated and reserved."""
        cache = graphs.CACHE
        if not graphed:
            graphs.CACHE = Eager()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = seq2gene_forward(p, batch, cfg, return_streams="gene_stream" in names)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            graphs.CACHE = cache
        return ({n: getattr(out, n) for n in names}, secs, torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved())

    def same_bits(label: str, got: dict, want: dict) -> None:
        for name in want:
            require(torch.equal(got[name], want[name]),
                    f"graphs {label}: {name} replayed differs from the eager chain's")

    def graph_counts() -> dict:
        return {op: dict(c) for op, c in kernels.GRAPHS.items()}

    def captures() -> int:
        return sum(c["captures"] for c in kernels.GRAPHS.values())

    reset_launches()
    shapes = {}
    for label, c, g, ragged in (("forward_d4", 384, 200, False),
                                ("sweep C=64 G=128", 64, 128, True),
                                ("sweep C=192 G=200", 192, 200, True),
                                ("sweep C=384 G=200", 384, 200, True)):
        batch = batch_at(c, g, SEED + c + g, ragged)
        want, eager_s, eager_alloc, eager_res = forward(params, batch, False)
        # the process's first forward runs each op once eagerly; each first
        # sighting of a signature is then a capture and a replay
        calls = 3 if label == "forward_d4" else 2
        rec = {"eager_s": eager_s, "eager_peak_alloc": eager_alloc,
               "eager_peak_reserved": eager_res, "calls": []}
        for k in range(calls):
            before = captures()
            got, secs, alloc, res = forward(params, batch, True)
            same_bits(f"{label} call {k}", got, want)
            rec["calls"].append({"s": secs, "captures": captures() - before,
                                 "peak_alloc": alloc, "peak_reserved": res})
        rec["capture_ms"] = 1e3 * (rec["calls"][-2]["s"] - rec["calls"][-1]["s"])
        require(rec["calls"][-1]["captures"] == 0, f"graphs {label}: the last call captured")
        shapes[label] = rec
        print(f"graphs {label}: replayed = eager bits ({', '.join(outputs)}); forward "
              f"{eager_s * 1e3:.2f} ms eager, {rec['calls'][-1]['s'] * 1e3:.2f} ms replayed, "
              f"capture {rec['capture_ms']:.2f} ms ({rec['calls'][-2]['captures']} graphs); "
              f"peak memory allocated {eager_alloc / 2**30:.3f} / "
              f"{rec['calls'][-1]['peak_alloc'] / 2**30:.3f} GiB, reserved "
              f"{eager_res / 2**30:.3f} / {rec['calls'][-1]['peak_reserved'] / 2**30:.3f} GiB "
              f"(eager / replayed); {card()}")

    # The VEP ref-once path keeps the final streams: the same bits, and a
    # later replay of the same graphs leaves them as they were.
    batch = batch_at(192, 200, SEED + 7, True)
    want, *_ = forward(params, batch, False, streams)
    got, *_ = forward(params, batch, True, streams)
    same_bits("return_streams", got, want)
    kept = {n: v.clone() for n, v in got.items()}
    forward(params, batch_at(192, 200, SEED + 8, True), True, streams)
    same_bits("return_streams after another replay", got, kept)
    print(f"graphs return_streams: replayed = eager bits ({', '.join(streams)}), kept "
          f"through a later replay")

    # A new weight set captures anew: four graphs (two window sets, the CRE
    # and the gene stack) at one shape.
    batch = batch_at(384, 200, SEED, False)
    swapped = bench.packed_params(cfg, init_seq2gene(cfg, SEED + 1, device=dev,
                                                     dtype=torch.bfloat16))
    want, *_ = forward(swapped, batch, False)
    before = graph_counts()
    got, *_ = forward(swapped, batch, True)
    same_bits("weight swap", got, want)
    new = {op: kernels.GRAPHS[op]["captures"] - before[op]["captures"] for op in before}
    require(new == {"fused_window_encoder": 2, "cre_stack": 1, "fused_gene_modulator": 1},
            f"graphs weight swap: captures {new}")
    del swapped
    record = {"shapes": shapes, "graphs": graph_counts(), "launches": dict(kernels.LAUNCHES)}
    print(f"graphs weight swap: replayed = eager bits, captures {json.dumps(new)}")
    print(f"graphs path: {json.dumps(record)}")
    return record


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


def attn_bwd_cost(lens, len_div, kv_div, b, sq, sk, heads, hd, dkv_size):
    """Backward of one attention call: the score and dP products, dV, dQ
    and dK (five products where the forward has two); bytes: q, k, v, dO
    (bf16), the forward's f32 output and the log-sum-exp read once, dq
    (bf16) and dk, dv (``dkv_size`` bytes an element: 2 for the bf16 slices
    of a self-attention's d(QKV), 4 for the cross-attention's f32 d(K|V))
    written once."""
    flops, _ = attn_cost(lens, len_div, kv_div, b, sq, sk, heads, hd)
    e = heads * hd
    q_elems, kv_elems = b * sq * e, (b // kv_div) * sk * e
    nbytes = (2.0 * 3 * q_elems + 4.0 * q_elems + 2.0 * 2 * kv_elems
              + dkv_size * 2.0 * kv_elems + 4.0 * b * heads * sq)
    return 2.5 * flops, nbytes


def backward_checks(torch, checks: Checks) -> None:
    """The backward kernels of the training path against their plain
    versions at main-path shapes, then the whole-stack backwards (#3, #4,
    #5 + #6) against torch autograd of the plain stacks."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import ParamInit
    from variantformer_tpu_torch.ops import fused_encoder as FE
    from variantformer_tpu_torch.ops import fused_modulator as FM
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

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
    rec = checks.run(
        "gemm_dgrad gene qkv", lambda: kernels.gemm_dgrad(dy, w, res),
        lambda: kernels.gemm_dgrad_plain(dy, w, res), lambda: torch.addmm(res, dy, w.t()),
        flops, 2.0 * (rows * 3 * e_mod + e_mod * 3 * e_mod + 2 * rows * e_mod), tol=GEMM_TOL,
        record="gemm_dgrad", meta={"shape": f"[{rows},{3 * e_mod}]x[{e_mod},{3 * e_mod}]^T +res"},
    )
    print_vs("gemm_dgrad gene qkv", rec)
    wgrad_bytes = 2.0 * (rows * e_mod + rows * 3 * e_mod) + 4.0 * e_mod * 3 * e_mod
    rec = checks.run(
        "gemm_wgrad gene qkv", lambda: kernels.gemm_wgrad(x, dy),
        lambda: kernels.gemm_wgrad_plain(x, dy), lambda: torch.matmul(x.t(), dy),
        flops, wgrad_bytes, tol=WGRAD_TOL,
        record="gemm_wgrad", meta={"shape": f"[{rows},{e_mod}]^Tx[{rows},{3 * e_mod}] f32 out"},
    )
    print_vs("gemm_wgrad gene qkv", rec)
    acc = torch.randn((e_mod, 3 * e_mod), generator=gen, device=dev)
    rec = checks.run(
        "gemm_wgrad gene qkv, into a buffer",
        lambda: kernels.gemm_wgrad(x, dy, out=acc.clone()),
        lambda: kernels.gemm_wgrad_plain(x, dy, out=acc.clone()), None,
        flops, wgrad_bytes + 4.0 * e_mod * 3 * e_mod, tol=WGRAD_TOL,
    )
    print_vs("gemm_wgrad gene qkv, into a buffer", rec)
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
    print_vs(name, rec)
    dm = randn(333 * 200 + 7, 2 * e_enc)
    we1 = randn(e_enc, 2 * e_enc, scale=e_enc ** -0.5)
    rec = checks.run(
        "gemm_dgrad ragged M", lambda: kernels.gemm_dgrad(dm, we1),
        lambda: kernels.gemm_dgrad_plain(dm, we1), lambda: torch.matmul(dm, we1.t()),
        2.0 * dm.shape[0] * e_enc * 2 * e_enc,
        2.0 * (dm.shape[0] * 3 * e_enc + e_enc * 2 * e_enc), tol=GEMM_TOL,
    )
    print_vs("gemm_dgrad ragged M", rec)
    del xe, dye, acc, dm

    # --- attention_bwd (three uses) ------------------------------------------
    sdpa_fwd_bwd = functools.partial(sdpa_fwd_bwd_call, torch)

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
        # The cotangents' buffers as the training path hands them over: bf16
        # slices of one d(QKV) for a self-attention, f32 slices of one d(K|V)
        # for the cross-attention.
        dtype = bf if kv_div == 1 else torch.float32
        dq, dk, dv = attn_bwd_buffers(torch, b, sq, kv_rows, sk, e, kv_div, dtype)
        flops, nbytes = attn_bwd_cost(lens, len_div, kv_div, b, sq, sk, heads, hd,
                                      dk.element_size())
        rec = checks.run(
            name, lambda: kernels.attention_bwd(*args, dq=dq, dk=dk, dv=dv),
            lambda: kernels.attention_bwd_plain(*args),
            sdpa_fwd_bwd(q, k, v, do, kv_len, slopes, scale, heads, kv_div, len_div),
            flops, nbytes, record=record, zeros=attn_bwd_zeros(name, lens, kv_rows, kv_div, len_div),
            floor=1.0, noise=(0, 1) if sk == 1 else (),
            meta={"shape": f"B={b} H={heads} Sq={sq} Sk={sk} hd={hd} kv_div={kv_div}, dk/dv "
                           + ("bf16 slices of d(QKV)" if kv_div == 1 else "f32 slices of d(K|V)")},
        )
        print(f"plan {name}: {kernels.attention_bwd_plan(b, heads, sq, sk, kv_div)}")
        print_vs(name, rec, REPLACED_BWD_MS, "the replaced kernel")

    gl4 = [201, 150, 1, 77]
    attn_bwd_case("attention_bwd gene self", d4 * t, g1, d4 * t, g1, mc.num_heads, hd_mod,
                  gl4, True, 1, t, record="attention_bwd")
    for name, sk, lens in (("attention_bwd gene cross C=384", c, [384, 300, 1, 2]),
                           ("attention_bwd gene cross C=1", 1, [1, 1, 1, 1])):
        attn_bwd_case(name, d4 * t, g1, d4, sk, mc.num_heads, hd_mod, lens, False, t, t,
                      record=name)
    # a training batch of 2 genes with 1024 and 700 CREs: the dQ pass in chunks
    attn_bwd_case("attention_bwd gene cross C=1024", 2 * t, g1, 2, 1024, mc.num_heads, hd_mod,
                  [1024, 700], False, t, t, record="attention_bwd gene cross C=1024")
    enc_lens = torch.randint(2, length + 1, (n_gene,), generator=gen, device=dev).tolist()
    enc_lens[:4] = [0, 1, 2, length]
    attn_bwd_case("attention_bwd encoder self", n_gene, length, n_gene, length, we.num_heads,
                  hd_enc, enc_lens, True, 1, 1, record="attention_bwd encoder self")

    # --- layernorm_bwd, geglu_bwd, masked_mean_pool_bwd, colsum ---------------
    # The gene width with the two residual cotangents of the main path's
    # LN1 backward and without any (LN2, LN3), and the encoder width. The
    # library call, native_layer_norm_backward, adds no residual: beside
    # the +2 case it reads 3 of the 5 tensors, a call that does less.
    for name, n_rows, e, n_res, record in (
        ("layernorm_bwd gene +2 residuals", rows, e_mod, 2, "layernorm_bwd"),
        ("layernorm_bwd gene, no residuals", rows, e_mod, 0, "layernorm_bwd gene, no residuals"),
        ("layernorm_bwd encoder E=512, no residuals", n_gene * length, e_enc, 0,
         "layernorm_bwd encoder E=512, no residuals"),
    ):
        x = randn(n_rows, e, scale=3.0)
        dy = randn(n_rows, e)
        res = tuple(randn(n_rows, e) for _ in range(n_res))
        sc = torch.rand(e, generator=gen, device=dev) + 0.5
        bi = torch.randn(e, generator=gen, device=dev) * 0.1
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [e], sc.to(bf), bi.to(bf), 1e-5)
        lib_call = ("native_layer_norm_backward" if not n_res else
                    "native_layer_norm_backward, without the residual adds (does less)")
        rec = checks.run(
            name, lambda: kernels.layernorm_bwd(x, dy, sc, res),
            lambda: kernels.layernorm_bwd_plain(x, dy, sc, res),
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [e], mean, rstd, sc.to(bf), bi.to(bf), [True, True, True]),
            (12.0 + n_res) * n_rows * e, 2.0 * (3 + n_res) * n_rows * e + 16.0 * e,
            record=record, flops_peak=PEAK_F32_FLOPS,
            meta={"shape": f"[{n_rows},{e}]" + (f" +{n_res} residuals" if n_res else ""),
                  "library_call": lib_call},
        )
        print(f"plan {name}: {kernels.layernorm_bwd_plan(n_rows, e)}; library call {lib_call}")
        print_vs(name, rec, REPLACED_BWD_MS, "the replaced kernel")
        del x, dy, res, mean, rstd
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
    encoder_bwd_record(torch, checks, FE.pack_encoder_layers(layers, we.num_heads, bf),
                       xg.detach(), tok_len, cot, enc_slopes, we.num_heads,
                       "fused_window_encoder_bwd (8 layer calls)", "fused_window_encoder_bwd")
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

    packed = FM.pack_gene_layers(layers, mc.num_heads, bf)
    del layers, leaves
    gene_stack_bwd_records(torch, checks, packed, randn(2, t, g1, e_mod),
                           randn(mc.num_layers, 2, c, e_mod), [201, 120], [384, 300], mod_slopes,
                           mc.num_heads, randn)


# Window encoders whose heads the attention kernels take at 128 lanes: (head
# dim, heads, E), 8 layers, GeGLU input 4 E. Head dim 96 is zero-padded to
# 128 lanes in the packs, as the JAX package's _pad_heads does.
WIDE_HEADS = ((96, 4, 384), (128, 4, 512))


def wide_heads_path(torch, checks: Checks) -> dict:
    """The window encoder at head dims 96 and 128 (``WIDE_HEADS``), N=1536
    windows of L=200 (ragged tok_len with 0, 1 and 200): the path drives
    ``fused_window_encoder`` (#1) and one backward through
    ``fused_window_encoder_diff`` (#3) at both, with the launch counts set
    to 0 just before and read just after; the forward within 3e-2 of max
    |plain| and every gradient within rel L2 5e-2 of torch autograd of the
    plain stack, dx exactly 0 past tok_len. Then #1, #3 and the attention
    forward and backward at head dim 128 are timed beside their plain
    versions (and SDPA for the attention). Returns the path's launches."""
    from variantformer_tpu_torch.models.init import ParamInit
    from variantformer_tpu_torch.ops import fused_encoder as FE
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(bf)
    n, length, num_layers = 1536, 200, 8
    lens = torch.randint(2, length + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    lens[:3] = torch.tensor([0, 1, length], device=dev, dtype=torch.int32)
    cases = []
    for hd, heads, e in WIDE_HEADS:
        layers = ParamInit(SEED + 13 + hd, dev, torch.float32).plain_layer_stack(
            num_layers, e, 4 * e)
        packed = FE.pack_encoder_layers(layers, heads, bf)
        require(packed["wqkv"].shape[-1] == 3 * heads * 128,
                f"hd={hd}: the pack's heads are not 128 lanes")
        cases.append((hd, heads, e, layers, packed, randn(n, length, e), randn(n, e)))
    slopes = torch.from_numpy(alibi_slopes(4)).to(dev)

    reset_launches()
    outs, grads = [], []
    for hd, heads, e, layers, packed, x, cot in cases:
        outs.append(FE.fused_window_encoder(x, lens, packed, slopes, hd ** -0.5, heads))
        leaves = [FE.get_leaf(layers, q).requires_grad_(True) for q in FE.LEAVES]
        xg = x.clone().requires_grad_(True)
        out = FE.fused_window_encoder_diff(xg, lens, layers, slopes, hd ** -0.5, heads)
        grads.append(torch.autograd.grad(out, [xg] + leaves, cot))
        del out
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"wide heads path (hd 96 and 128, N={n}): launches {json.dumps(launches)}")
    for name in ("fused_window_encoder", "fused_window_encoder_bwd", "attention",
                 "attention_bwd"):
        require(kernel_ran(launches, name), f"{name} was not launched on the wide heads path")

    names = ["x"] + ["/".join(q) for q in FE.LEAVES]
    for (hd, heads, e, layers, packed, x, cot), out, got in zip(cases, outs, grads):
        label = f"hd={hd} H={heads} E={e} ({packed['wqkv'].shape[-1] // 3 // heads} lanes)"
        with torch.no_grad():
            compare(torch, f"fused_window_encoder {label} N={n}", out,
                    FE.fused_window_encoder_plain(x, lens, packed, slopes, hd ** -0.5, heads),
                    STACK_TOL)
        leaves = [FE.get_leaf(layers, q) for q in FE.LEAVES]
        xg = x.clone().requires_grad_(True)
        ref = FE.fused_window_encoder_plain(xg, lens, FE.pack_encoder_layers(layers, heads, bf),
                                            slopes, hd ** -0.5, heads)
        want = torch.autograd.grad(ref, [xg] + leaves, cot)
        del ref
        compare_grads(torch, f"fused_window_encoder backward {label} vs autograd of the plain "
                      "stack", dict(zip(names, got)), dict(zip(names, want)))
        past = torch.arange(length, device=dev)[None, :] >= lens[:, None]
        require_zero(got[0][past], f"{label} dx past tok_len")
        del want
    del outs, grads

    meta = {"path": "heads"}
    for hd, heads, e, layers, packed, x, cot in cases:
        label = f"hd={hd}" + (" (128 lanes)" if hd != 128 else "")
        rows, ffn = n * length, 4 * e
        gemm_flops = 2.0 * rows * (e * 3 * e + e * e + e * ffn + ffn // 2 * e)
        a_flops, _ = attn_cost(lens.tolist(), 1, 1, n, length, length, heads, hd)
        w_bytes = sum(v.numel() * v.element_size() for v in packed.values())
        args = (x, lens, packed, slopes, hd ** -0.5, heads)
        name = f"fused_window_encoder {label} N={n}"
        checks.run(
            name, lambda: FE.fused_window_encoder(*args),
            lambda: FE.fused_window_encoder_plain(*args), None,
            num_layers * (gemm_flops + a_flops), 2.0 * (rows * e + n * e) + 4.0 * n + w_bytes,
            record=name, meta={"shape": f"N={n} L={length} E={e} H={heads} hd={hd} "
                                        f"layers={num_layers} (the bound: hd {hd}'s work)",
                               **meta},
        )
        name = f"fused_window_encoder_bwd {label} (8 layer calls)"
        encoder_bwd_record(torch, checks, packed, x, lens, cot, slopes, heads, name, name, meta)
    del cases

    # The attention and its backward alone at head dim 128 (the E=512
    # encoder's self-attention), beside SDPA.
    heads, hd = 4, 128
    e = heads * hd
    lens_l = lens.tolist()
    qkv = randn(n, length, 3 * e, scale=2.0)
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    args = (q, k, v, lens, slopes, hd ** -0.5, heads, 1, 1)
    flops, nbytes = attn_cost(lens_l, 1, 1, n, length, length, heads, hd)
    name = "attention encoder self hd=128"
    checks.run(
        name, lambda: kernels.attention(*args), lambda: kernels.attention_plain(*args),
        sdpa_call(torch, *args), flops, nbytes, record=name,
        meta={"shape": f"B={n} H={heads} Sq={length} Sk={length} hd={hd} kv_div=1, kv_len "
                       "mixed", **meta},
    )
    print(f"plan {name}: {kernels.attention_plan(n, heads, length, length, head_dim=hd)}")
    _, lse, o = kernels.attention(*args, for_backward=True)
    do = randn(n, length, e)
    bargs = (q, k, v, o, lse, do, lens, slopes, hd ** -0.5, heads, 1, 1)
    dq, dk, dv = attn_bwd_buffers(torch, n, length, n, length, e, 1, bf)
    flops, nbytes = attn_bwd_cost(lens_l, 1, 1, n, length, length, heads, hd, 2)
    name = "attention_bwd encoder self hd=128"
    checks.run(
        name, lambda: kernels.attention_bwd(*bargs, dq=dq, dk=dk, dv=dv),
        lambda: kernels.attention_bwd_plain(*bargs),
        sdpa_fwd_bwd_call(torch, q, k, v, do, lens, slopes, hd ** -0.5, heads, 1, 1),
        flops, nbytes, record=name, zeros=attn_bwd_zeros(name, lens_l, n, 1, 1), floor=1.0,
        meta={"shape": f"B={n} H={heads} Sq={length} Sk={length} hd={hd} kv_div=1, dk/dv bf16 "
                       "slices of d(QKV)", **meta},
    )
    print(f"plan {name}: {kernels.attention_bwd_plan(n, heads, length, length, head_dim=hd)}")
    return launches


def encoder_bwd_record(torch, checks: Checks, packed: dict, x, tok_len, cot, slopes,
                       heads: int, name: str, record: str, meta: dict | None = None) -> None:
    """#3, the window-encoder stack's recompute backward from the pooled
    cotangent ``cot``, timed against its plain version on the layer inputs
    the kernel chain saves for ``x`` [N, L, E]."""
    from variantformer_tpu_torch.ops import fused_encoder as FE
    from variantformer_tpu_torch.ops import kernels

    n, length, e = x.shape
    layers, ffn = packed["wqkv"].shape[0], packed["wf1"].shape[-1]
    hd = e // heads
    with torch.no_grad():
        xsave: list = []
        FE._chain(kernels.KERNELS, x, tok_len, packed, slopes, hd ** -0.5, heads, xsave)
        bwd_args = (cot, xsave, tok_len, packed, slopes, hd ** -0.5, heads)
        n_rows = n * length
        a_flops, _ = attn_bwd_cost(tok_len.tolist(), 1, 1, n, length, length, heads, hd, 2)
        gemm_flops = 2.0 * n_rows * (e * 3 * e + e * e + e * ffn + ffn // 2 * e)
        # recompute (all but FFN-out) + dgrad and wgrad of every projection
        rec_flops = gemm_flops - 2.0 * n_rows * ffn // 2 * e + a_flops / 2.5
        w_bytes = sum(v.numel() * v.element_size() for v in packed.values())
        checks.run(
            name, lambda: FE.fused_window_encoder_bwd(*bwd_args)[0],
            lambda: FE.fused_window_encoder_bwd_plain(*bwd_args)[0], None,
            layers * (rec_flops + 2 * gemm_flops + a_flops),
            layers * 2.0 * n_rows * e + 2.0 * n_rows * e + 3 * w_bytes, record=record,
            meta={"shape": f"N={n} L={length} E={e} layers={layers}", **(meta or {})},
        )


def gene_stack_bwd_records(torch, checks: Checks, packed: dict, gs, cre, gene_lens, cre_lens,
                           slopes, heads: int, randn, suffix: str = "",
                           meta: dict | None = None) -> None:
    """#4 (the checkpointing forward), #5 and #6 (one layer's two backward
    parts) timed against their plain versions at ``gs`` [D, T, G1, E] and
    ``cre`` [layers, D, C, E]. Records are named after the kernel, plus
    ``suffix`` when given."""
    from variantformer_tpu_torch.ops import fused_modulator as FM
    from variantformer_tpu_torch.ops import kernels

    d2, t, g1, e_mod = gs.shape
    num_layers, c = cre.shape[0], cre.shape[2]
    ffn = packed["wf1"].shape[-1]
    hd_mod = e_mod // heads
    mod_scale = hd_mod ** -0.5
    dev = gs.device
    rec = lambda name: name + suffix
    with torch.no_grad():
        gl = torch.tensor(gene_lens, device=dev, dtype=torch.int32)
        cl = torch.tensor(cre_lens, device=dev, dtype=torch.int32)
        valid = torch.zeros((d2, t, g1), dtype=torch.bool, device=dev)
        for i, n in enumerate(gene_lens):
            valid[i, :, :n] = True
        r2 = d2 * t * g1
        sa_flops, _ = attn_cost(gene_lens, t, 1, d2 * t, g1, g1, heads, hd_mod)
        ca_flops, _ = attn_cost(cre_lens, t, t, d2 * t, g1, c, heads, hd_mod)
        proj = lambda *widths: 2.0 * r2 * sum(a * b for a, b in widths)
        w_bytes = sum(v.numel() * v.element_size() for v in packed.values())
        fwd_args = (gs, cre, gl, cl, packed, slopes, mod_scale, heads)
        layer_flops = (proj((e_mod, 3 * e_mod), (e_mod, e_mod), (e_mod, e_mod), (e_mod, e_mod),
                            (e_mod, ffn), (ffn // 2, e_mod))
                       + 2.0 * d2 * c * e_mod * 2 * e_mod + sa_flops + ca_flops)
        checks.run(
            f"fused_gene_modulator_fwd_save D={d2}{suffix}",
            lambda: FM.fused_gene_modulator_fwd_save(*fwd_args)[0],
            lambda: FM._chain(kernels.PLAIN, *fwd_args, saves=[]), None,
            num_layers * layer_flops,
            2.0 * (2 * r2 * e_mod + num_layers * (d2 * c * e_mod + 2 * r2 * e_mod)) + w_bytes,
            valid=valid, record=rec("fused_gene_modulator_fwd_save"),
            meta={"shape": f"D={d2} T={t} G1={g1} C={c} E={e_mod} layers={num_layers}",
                  **(meta or {})},
        )
        _, saves = FM.fused_gene_modulator_fwd_save(*fwd_args)
        i = num_layers - 1
        xl, hl, ckv = (s.clone() for s in saves[i])
        del saves
        grads = {k: torch.zeros(packed[k].shape, dtype=torch.float32, device=dev)
                 for k in FM.PACKED}
        dnext = randn(r2, e_mod)
        dnext.view(d2, t, g1, e_mod)[~valid] = 0
        dckv = torch.zeros(ckv.shape, dtype=torch.float32, device=dev)

        def bwd1(ops):
            dh = FM._bwd1(ops, i, hl, ckv, dnext, cl, packed, grads, dckv, mod_scale,
                          heads, t, g1)
            return dh, dckv.clone()

        ca_bwd, _ = attn_bwd_cost(cre_lens, t, t, d2 * t, g1, c, heads, hd_mod, 4)
        phase1 = proj((e_mod, e_mod), (e_mod, e_mod), (e_mod, ffn))
        checks.run(
            f"fused_gene_modulator_bwd1 (one layer){suffix}", lambda: bwd1(kernels.KERNELS),
            lambda: bwd1(kernels.PLAIN), None,
            phase1 + 2 * (phase1 + proj((ffn // 2, e_mod))) + ca_flops + ca_bwd,
            2.0 * (3 * r2 * e_mod + d2 * c * 2 * e_mod) + 4.0 * d2 * c * 2 * e_mod
            + 3 * 2.0 * (3 * e_mod * e_mod + e_mod * ffn + ffn // 2 * e_mod),
            record=rec("fused_gene_modulator_bwd1"),
            meta={"shape": f"D={d2} T={t} G1={g1} C={c} E={e_mod}", **(meta or {})},
        )
        dh = bwd1(kernels.KERNELS)[0]
        sa_bwd, _ = attn_bwd_cost(gene_lens, t, 1, d2 * t, g1, g1, heads, hd_mod, 2)
        phase0 = proj((e_mod, 3 * e_mod))
        checks.run(
            f"fused_gene_modulator_bwd0 (one layer){suffix}",
            lambda: FM._bwd0(kernels.KERNELS, i, xl, dh, dnext, gl, packed, grads, slopes,
                             mod_scale, heads, t, g1),
            lambda: FM._bwd0(kernels.PLAIN, i, xl, dh, dnext, gl, packed, grads, slopes,
                             mod_scale, heads, t, g1), None,
            phase0 + 2 * (phase0 + proj((e_mod, e_mod))) + sa_flops + sa_bwd,
            2.0 * 4 * r2 * e_mod + 3 * 2.0 * 4 * e_mod * e_mod,
            record=rec("fused_gene_modulator_bwd0"),
            meta={"shape": f"D={d2} T={t} G1={g1} E={e_mod}", **(meta or {})},
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
VOCAB_TISSUES = 63  # tissues.yaml: tissue0 .. tissue62, the released vocabulary's ids
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
    (root / "tissues.yaml").write_text(
        "".join(f"tissue{i}: {i}\n" for i in range(VOCAB_TISSUES)))
    return cre_maps


# The kernels of the vcf2exp path; their launches are read on its run. Every
# other kernel belongs to the training path and is read on the fit run.
SERVING_KERNELS = ("gemm_bf16", "attention", "layernorm", "geglu", "masked_mean_pool",
                   "fused_window_encoder", "fused_gene_modulator", "cre_stack")
# The capability probes' kernels; their launches are read on the probe run.
PROBE_KERNELS = ("probe_48slice", "probe_3dreshape", "probe_48slice_bf16_matmul")


def genome_sources(root: Path, cre_maps: dict):
    from variantformer_tpu_torch.api.vcfprocessor import DataSources

    return DataSources(
        fasta_path=str(root / "genome.fa"), gencode_path=str(root / "gencode.csv"),
        tissue_vocab_path=str(root / "tissues.yaml"), cre_map_provider=cre_maps.get,
    ).resolve_defaults()


def tabix_checks(root: Path, cre_maps: dict) -> None:
    """Index the donor VCF with the port's ``write_tbi`` and require the
    indexed query to equal the scan on every gene window and CRE window of
    the main path."""
    import pandas as pd

    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.tabix import write_tbi
    from variantformer_tpu_torch.utils.vcf import VCFReader

    vcf = str(root / "donor.vcf.gz")
    t0 = time.perf_counter()
    write_tbi(vcf)
    tbi_s = time.perf_counter() - t0
    indexed, scan = VCFReader(vcf), VCFReader(vcf, use_index=False)
    require(indexed._index is not None, "the donor VCF's .tbi was not used")
    sources = genome_sources(root, cre_maps)
    cfg = ModelConfig().dataset
    builder = GeneSampleBuilder(
        cfg, FastaReader(sources.fasta_path), BPETokenizer.from_file(sources.bpe_vocab_path),
        pd.read_csv(sources.gencode_path), cre_maps.get,
    )
    regions = []
    for g, *_ in GENES:
        regions.append(builder.gene_window(builder.gene_info(g)))
        cre = cre_maps[g]
        regions += [(max(0, int(a) - cfg.cre_neighbour_hood), int(b) + cfg.cre_neighbour_hood)
                    for a, b in zip(cre["start_cre"], cre["end_cre"])]
    found = 0
    t0 = time.perf_counter()
    for a, b in regions:
        got = indexed.query("chr1", a, b)
        require(got == scan.query("chr1", a, b), f"indexed query != scan on chr1:{a}-{b}")
        found += len(got)
    print(f"tabix: .tbi written in {tbi_s:.3f} s; indexed query == scan on {len(regions)} "
          f"windows (4 gene windows, {len(regions) - 4} CRE windows; {found} variants) in "
          f"{time.perf_counter() - t0:.3f} s")


def serving_path(torch, root: Path, cre_maps: dict) -> tuple[dict, object, object]:
    """vcf2exp for 4 genes x 54 tissues through ``VCFProcessor.predict`` on
    the native host engines and the tabix-indexed donor VCF, held against
    the plain versions; the same batch built again on the Python engines
    must be equal. Returns the path's launch counts, its predictions and
    the batch (numpy leaves)."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward_plain
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.utils import native
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import ConsensusEngine, VCFReader

    sources = genome_sources(root, cre_maps)
    cfg = ModelConfig()
    proc = VCFProcessor(sources=sources, config=cfg, device="cuda")
    proc.set_params(init_seq2gene(cfg, SEED, device="cuda"))
    tissues = ",".join(f"tissue{i}" for i in range(54))
    query = pd.DataFrame({"gene_id": [g for g, *_ in GENES], "tissues": tissues})
    vcf = str(root / "donor.vcf.gz")
    require(proc.tokenizer.use_native, "the processor's tokenizer is not the native engine")

    reset_launches()
    native.CALLS.update(dict.fromkeys(native.CALLS, 0))
    t0 = time.perf_counter()
    result = proc.predict(vcf, query, batch_size=4)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    calls = dict(native.CALLS)
    variants = attn_variants()
    print(f"predict: {len(result)} genes x 54 tissues in {predict_s:.3f} s "
          f"(host pipeline included); launches {json.dumps(launches)}; "
          f"attention variants {json.dumps(variants)}; native host calls {json.dumps(calls)}")
    # Serving never takes the statistics variants; a replayed graph launches
    # none from the host, so the serving ones are counted only where the
    # wrapper ran.
    require(variants["alibi=0 stats=1"] == variants["alibi=1 stats=1"] == 0
            and (launches["attention"] == 0
                 or variants["alibi=1 stats=0"] > 0 and variants["alibi=0 stats=0"] > 0),
            f"vcf2exp predict: attention variants {variants}")
    require(calls["consensus"] > 0 and calls["bpe_encode_batch"] > 0,
            f"predict did not run the native host engines: {calls}")
    require_cre_chain("vcf2exp predict", launches)

    preds = np.stack(result["predicted_expression"].to_list())
    embs = np.stack(result["embeddings"].to_list())
    require(preds.shape == (4, 54), f"pred shape {preds.shape}")
    require(embs.shape == (4, 54, cfg.seq2gene.emb_dim), f"embedding shape {embs.shape}")
    require(np.isfinite(preds).all() and np.isfinite(embs).all(), "non-finite output")
    require((preds >= 0).all(), "softplus head gave a negative prediction")
    for name in SERVING_KERNELS:
        require(kernel_ran(launches, name), f"kernel {name} was not launched on the vcf2exp path")

    # The same batch again, on the native engines and on the Python ones
    # (equal leaves); then the forward alone, and through the plain versions.
    def host_batch(tokenizer, use_native: bool):
        fasta, reader = FastaReader(sources.fasta_path), VCFReader(vcf)
        builder = GeneSampleBuilder(
            cfg=cfg.dataset, fasta=fasta, tokenizer=tokenizer, gencode=proc.get_genes(),
            cre_map_provider=cre_maps.get, vcf=reader,
        )
        builder.engine = ConsensusEngine(fasta, reader, use_native=use_native)
        t0 = time.perf_counter()
        out = pack_samples([builder.build(g) for g, *_ in GENES], list(range(54)))
        return out, time.perf_counter() - t0

    batch, host_s = host_batch(proc.tokenizer, True)
    py_tok = BPETokenizer.from_file(sources.bpe_vocab_path, use_native=False)
    py_batch, host_py_s = host_batch(py_tok, False)
    for name, leaf in batch._asdict().items():
        require((leaf is None) == (getattr(py_batch, name) is None)
                and (leaf is None or np.array_equal(leaf, getattr(py_batch, name))),
                f"batch leaf {name}: native engines != Python engines")
    print(f"host build+pack (4 genes): native engines {host_s:.3f} s, Python engines "
          f"{host_py_s:.3f} s (the pure-Python pipeline's 6.029 s in PERF.md); the same batch, "
          f"leaf for leaf; {card()}")
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
          f"host build+pack {host_s:.3f} s (native); predict end to end "
          f"{4 / predict_s:.4f} genes/s (0.5984 on the pure-Python pipeline, PERF.md); "
          f"{card()}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile(torch, fwd, "vcf2exp forward")
    proc.cleanup()
    return launches, preds, batch


# The VEP path's variants: (gene whose CRE or gene window holds it, where):
# "cre_in_window" a CRE inside the gene window, "cre_outside" a CRE outside
# it, "window" the gene window outside every CRE. Against every other gene a
# variant is "No overlap". GENE4's variant lists 2 tissues, the others 54.
VEP_VARIANTS = (("GENE1.1", "cre_in_window"), ("GENE1.1", "cre_outside"),
                ("GENE3.1", "cre_in_window"), ("GENE3.1", "cre_outside"),
                ("GENE2.1", "window"), ("GENE4.1", "window"))
VEP_FLOATS = ("gene_exp", "gene_emb", "gene_token_embedding", "cre_token_embedding")


def vep_variants(seq: str, cre_maps: dict, builder, cfg) -> list[tuple[int, str, str]]:
    """(1-based position, ref, alt) of each of ``VEP_VARIANTS`` on the main
    path's genome: the first CRE (or the first CRE-free stretch of the gene
    window) of its kind, 50 bp in."""
    nb = cfg.cre_neighbour_hood
    out = []
    for gene, where in VEP_VARIANTS:
        w0, w1 = builder.gene_window(builder.gene_info(gene))
        cres = cre_maps[gene]
        spans = [(int(a) - nb, int(b) + nb) for a, b in zip(cres["start_cre"], cres["end_cre"])]
        if where == "window":
            covered = [(a, b) for m in cre_maps.values()
                       for a, b in zip(m["start_cre"] - nb, m["end_cre"] + nb)]
            pos = next(p for p in range(w0 + 1000, w1, 97)
                       if not any(a - 2 <= p <= b + 2 for a, b in covered))
        else:
            inside = where == "cre_in_window"
            a, b = next((a, b) for a, b in spans if (w0 < a and b <= w1) == inside)
            pos = a + 50
        ref = seq[pos - 1]
        out.append((pos, ref, "ACGT"[("ACGT".index(ref) + 2) % 4]))
    return out


def vep_path(torch, root: Path, cre_maps: dict, cfg=None, device: str = "cuda") -> dict:
    """VEP / eQTL at ``cfg`` (default full v4_pcg width and depth; the
    smoke runs it at ``variants_depth_config()``; ``device`` only for a rehearsal
    on the CPU at a small width): three records merged
    into the donor VCF by ``create_vcf_from_variant`` (its tabix query equal
    to the scan, the new records replacing the donor's), then
    ``VariantProcessor.predict`` of 6 variants x 4 genes x (SAMPLE,
    REF_HG38) with the ref-once cache, launch counts per dispatch and the
    native calls; one triple and one pair dispatch held against the plain
    versions; the run against itself with the ref-once cache off, the
    window-dedup pools off and k=4; the forward of a triple and a pair at
    T=54 timed and profiled. Returns the default run's launch counts."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward_plain
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.utils import native
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    no_remote_fetch(root)
    cfg = cfg or ModelConfig()
    sources = genome_sources(root, cre_maps)
    fasta = FastaReader(sources.fasta_path)
    seq = fasta.fetch("chr1", 0, CHR_LEN)
    builder = GeneSampleBuilder(cfg.dataset, fasta, BPETokenizer.from_file(
        sources.bpe_vocab_path), pd.read_csv(sources.gencode_path), cre_maps.get)
    variants = vep_variants(seq, cre_maps, builder, cfg.dataset)

    # --- create_vcf_from_variant: 3 records merged into the donor VCF ---
    donor = str(root / "donor.vcf.gz")
    donor_recs = VCFReader(donor, use_index=False).query("chr1", 0, CHR_LEN)
    replaced = donor_recs[len(donor_recs) // 2]
    new_recs = [(replaced.pos, seq[replaced.pos - 1], "0|1")] + [
        (p, r, "1|1") for p, r, _ in variants[:2]]
    alt_of = lambda ref, k: "ACGT"[("ACGT".index(ref) + k) % 4]
    new_df = pd.DataFrame({
        "chrom": "chr1", "pos": [p for p, _, _ in new_recs], "ref": [r for _, r, _ in new_recs],
        "alt": [alt_of(r, 1) for _, r, _ in new_recs], "GT": [g for _, _, g in new_recs]})
    t0 = time.perf_counter()
    merged = VCFProcessor(sources=sources, config=cfg, device=device).create_vcf_from_variant(
        new_df, str(root / "merged"), vcf_path=donor)
    merge_s = time.perf_counter() - t0
    indexed, scan = VCFReader(merged), VCFReader(merged, use_index=False)
    require(indexed._index is not None, "the merged VCF's .tbi was not used")
    require(scan.sample_names == ["DONOR"], f"merged sample names {scan.sample_names}")
    for g, *_ in GENES:
        a, b = builder.gene_window(builder.gene_info(g))
        require(indexed.query("chr1", a, b) == scan.query("chr1", a, b),
                f"merged VCF: indexed query != scan on {g}'s window")
    got = {v.pos: v for v in scan.query("chr1", 0, CHR_LEN)}
    require(len(got) == len({v.pos for v in donor_recs} | {p for p, _, _ in new_recs}),
            "merged VCF lost or duplicated records")
    for (pos, ref, gt), alt in zip(new_recs, new_df["alt"]):
        want = (ref, alt) if gt == "0|1" else (alt, alt)
        require(got[pos].alleles == want, f"merged record at {pos}: {got[pos].alleles} != {want}")
    print(f"create_vcf_from_variant: 3 records merged into the {len(donor_recs)}-record donor "
          f"VCF in {merge_s:.3f} s (one replacing the donor's record at {replaced.pos}); indexed "
          f"query == scan on the 4 gene windows")

    # --- predict: 6 variants, ref-once cache, k=1 ---
    tissues54 = ",".join(f"tissue{i}" for i in range(54))
    var_df = pd.DataFrame({
        "chrom": "chr1", "pos": [p for p, _, _ in variants], "ref": [r for _, r, _ in variants],
        "alt": [a for _, _, a in variants],
        "tissue": [tissues54] * 5 + ["tissue0,tissue7"]})
    proc = VariantProcessor(sources=sources, config=cfg, device=device)
    proc.set_params(init_seq2gene(cfg, SEED, device=device))
    require(proc._vp.tokenizer.use_native, "the processor's tokenizer is not the native engine")

    dispatched = []  # (batch, return_streams, output) of every dispatch
    forward = proc._vp._forward

    def recording(batch, return_streams=False, narrow_embeddings=False):
        out = forward(batch, return_streams=return_streams, narrow_embeddings=narrow_embeddings)
        dispatched.append((batch, return_streams, out))
        return out

    proc._vp._forward = recording

    def run(label, k=1, **env):
        saved = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        proc._ref_cache.clear()
        dispatched.clear()
        try:
            t0 = time.perf_counter()
            df = proc.predict(var_df, str(root / f"vep_{label}"), vcf_path=merged,
                              sample_name="DONOR", variants_per_dispatch=k)
            wall = time.perf_counter() - t0
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        written = os.path.exists(os.path.join(root, f"vep_{label}", "vep_VF.parquet"))
        shapes = sorted({(int(b.cre_tokens.shape[0]), int(b.tissue_ids.shape[0]),
                          b.cre_pool_tokens is not None) for b, _, _ in dispatched})
        print(f"vep {label}: {len(df)} rows, {len(proc.gene_variant_pairs)} (variant, gene, "
              f"population) items in {wall:.3f} s ({len(proc.gene_variant_pairs) / wall:.4f} "
              f"items/s end to end); {len(dispatched)} dispatches (D, T, pooled): {shapes}; "
              f"parquet written: {written}; vep_stats {json.dumps(proc.vep_stats)}; {card()}")
        return df, wall, list(dispatched), dict(proc.vep_stats)

    reset_launches()
    native.CALLS.update(dict.fromkeys(native.CALLS, 0))
    df, wall, runs, stats = run("ref_once_k1")
    launches = dict(kernels.LAUNCHES)
    calls = dict(native.CALLS)
    n_disp = len(runs)
    print(f"vep launches {json.dumps(launches)}; per dispatch "
          f"{json.dumps({k: round(v / n_disp, 3) for k, v in launches.items() if v})}; "
          f"native host calls {json.dumps(calls)}")
    require(calls["consensus"] > 0 and calls["bpe_encode_batch"] > 0 and calls["bpe_encode"] > 0,
            f"predict did not run the native host engines: {calls}")
    if device == "cuda":
        for name in SERVING_KERNELS:
            require(kernel_ran(launches, name), f"kernel {name} was not launched on the VEP path")
        require_cre_chain("vep predict", launches)
    require(any(b.cre_pool_tokens is not None for b, _, _ in runs),
            "no dispatch of the VEP run carried window-dedup pools")

    # the frame: every variant type on both strands, finite where scored
    strand = {g: st for g, *_, st in GENES}
    types = {(strand[g], t) for g, t in zip(df["genes"], df["variant_type"])}
    want_types = {(s, t) for s in "+-" for t in (
        "Gene and CRE overlap", "CRE overlap only", "Gene overlap only", "No overlap")}
    require(types >= want_types, f"variant types missing: {want_types - types}")
    require(set(df["population"]) == {"SAMPLE", "REF_HG38"}, "populations")
    scored = (df["variant_type"] != "No overlap").to_numpy()
    for col in VEP_FLOATS:
        vals = np.stack(df[col].to_list()).astype(np.float64)
        require(np.isfinite(vals[scored]).all(), f"non-finite {col} on a scored row")
        require(np.isnan(vals[~scored]).all(), f"{col} of a No-overlap row is not NaN")
    require(np.stack(df["gene_emb"].to_list()).shape[1] == cfg.seq2gene.emb_dim, "emb width")
    require((df.loc[scored, "gene_exp"] >= 0).all(), "negative expression")
    for col in ("gene_token_embedding", "cre_token_embedding"):
        require(np.abs(np.stack(df.loc[scored, col].to_list())).max() > 0, f"{col} all zero")
    scores = proc.eqtl_scores(proc.format_scores(df))
    require(len(scores) > 0 and np.isfinite(scores.filter(like="log2fc").to_numpy(float)).any(),
            "no eQTL score")
    print(f"vep frame: variant types {sorted(types)}; {int(scored.sum())} scored rows, "
          f"{len(scores)} eQTL score rows")

    # --- one triple and one pair dispatch against the plain versions ---
    # (A triple whose edit shifts the gene's token windows overflows the
    # gene pool and runs on the plain window layout.)
    triples = [r for r in runs if r[0].cre_tokens.shape[0] == 3 and r[1]
               and r[0].tissue_ids.shape[0] == 54]
    triple = next(r for r in triples if r[0].cre_pool_tokens is not None)
    plain_triple = next((r for r in triples if r[0].cre_pool_tokens is None), None)
    pair = next(r for r in runs if r[0].cre_tokens.shape[0] == 2)
    held = [("triple", triple), ("pair", pair)]
    if plain_triple is not None:
        held.append(("triple on the plain window layout", plain_triple))
    for label, (batch, streams, out) in held:
        with torch.inference_mode():
            plain = seq2gene_forward_plain(proc._vp._params, proc._vp._to_device(batch), cfg,
                                           return_streams=streams)
        compare(torch, f"vep {label} pred vs plain", out.pred_expression,
                plain.pred_expression, PRED_TOL)
        for name in ("pooled_embedding", "gene_token_embedding", "cre_token_embedding"):
            compare(torch, f"vep {label} {name} vs plain", getattr(out, name),
                    getattr(plain, name), EMB_TOL)
        del plain

    # --- the run against its own variants ---
    def hold(label, other):
        same = True
        for col in VEP_FLOATS:
            a = np.stack(df.loc[scored, col].to_list()).astype(np.float64)
            b = np.stack(other.loc[scored, col].to_list()).astype(np.float64)
            tol = PRED_TOL if col == "gene_exp" else EMB_TOL
            compare(torch, f"vep {label} {col}", torch.from_numpy(b), torch.from_numpy(a), tol)
            same &= bool(np.array_equal(a, b))
        require(list(df["variant_type"]) == list(other["variant_type"]), f"{label}: types")
        print(f"vep {label} against the default run: the same bits: {same}")

    triples, wall_triples, *_ = run("all_triples", VFX_VEP_REF_ONCE="0")
    hold("ref-once vs all-triples", triples)
    plain_layout, wall_plain, plain_runs, _ = run("plain_layout", VFX_VEP_DEDUP="0")
    require(all(b.cre_pool_tokens is None for b, _, _ in plain_runs), "VFX_VEP_DEDUP=0 pooled")
    hold("dedup vs plain layout", plain_layout)
    k4, wall_k4, *_ = run("k4", k=4)
    hold("k=4 vs k=1", k4)

    n_items = len(proc.gene_variant_pairs)
    readings = {"ref_once_k1": wall, "all_triples": wall_triples, "plain_layout": wall_plain,
                "k4": wall_k4}
    print("vep items/s by run: " + json.dumps(
        {label: round(n_items / w, 4) for label, w in readings.items()}) + f"; {card()}")

    # --- device time of a triple and a pair at T=54 ---
    if device == "cuda":
        timed = [("triple D=3 T=54", triple), ("pair D=2 T=54", pair)]
        if plain_triple is not None:
            timed.append(("triple D=3 T=54, plain window layout", plain_triple))
        for label, (batch, streams, _) in timed:
            fwd = lambda b=batch, s=streams: forward(b, return_streams=s, narrow_embeddings=True)
            ms = time_ms(torch, fwd, 3)
            print(f"vep forward {label} (pooled: {batch.cre_pool_tokens is not None}): "
                  f"{ms:.3f} ms by CUDA events; {card()}")
            profile(torch, fwd, f"vep {label}")
            # How long the host takes to launch one dispatch.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            print(f"vep dispatch {label}: the host returns after {host_ms:.3f} ms; {card()}")
    print(f"vep host stages (default run): build {stats.get('build_s', 0):.3f} s (summed over "
          f"worker threads), pack {stats.get('pack_s', 0):.3f} s, dispatch "
          f"{stats.get('dispatch_s', 0):.3f} s, fetch {stats.get('fetch_s', 0):.3f} s; "
          f"{len(proc.gene_variant_pairs) / wall:.4f} items/s at k=1, "
          f"{len(proc.gene_variant_pairs) / wall_k4:.4f} at k=4; {card()}")
    proc.cleanup()
    return launches


def no_remote_fetch(root: Path) -> None:
    """No artifacts and no network: REF_HG38 takes the local consensus. A
    remote fetch fails at once instead of reaching for the object store."""
    from variantformer_tpu_torch.utils import assets

    def refuse(self, rel, dst):
        raise RuntimeError(f"no remote fetch in the smoke run ({rel})")

    assets.CachedFetcher._default_transport = refuse
    os.environ["VFX_FETCH_RETRY_TIMEOUT"] = "0"
    os.environ["VFX_ARTIFACTS_DIR"] = str(root / "artifacts")


def seeded_ensemble(seed: int, n_trees: int, lo, hi, max_depth: int = 6):
    """A ``TreeEnsemble`` made from ``seed`` with numpy: ``n_trees`` trees of
    depth 2 to ``max_depth`` (a node below the root becomes a leaf with
    probability 0.2) over ``len(lo)`` features; each split's threshold lies
    in the middle half of its feature's [lo, hi], so rows drawn from that
    range take both branches."""
    import numpy as np

    from variantformer_tpu_torch.api.ad_risk import TreeEnsemble

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    feat, thr, left, right, val, offsets = [], [], [], [], [], []

    def new_node() -> int:
        for field in (feat, left, right):
            field.append(0)
        thr.append(0.0)
        val.append(0.0)
        return len(feat) - 1

    for _ in range(n_trees):
        offsets.append(len(feat))
        depth_cap = int(rng.integers(2, max_depth + 1))
        stack = [(new_node(), 0)]
        while stack:
            node, depth = stack.pop()
            if depth == depth_cap or (depth > 0 and rng.random() < 0.2):
                feat[node], val[node] = -1, float(rng.normal(0.0, 0.1))
                continue
            f = int(rng.integers(len(lo)))
            feat[node] = f
            thr[node] = float(lo[f] + rng.uniform(0.25, 0.75) * (hi[f] - lo[f]))
            left[node], right[node] = new_node(), new_node()
            stack += [(left[node], depth + 1), (right[node], depth + 1)]
    return TreeEnsemble(
        feature=np.asarray(feat, np.int32), threshold=np.asarray(thr, np.float32),
        left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
        value=np.asarray(val, np.float32), tree_offsets=np.asarray(offsets, np.int32),
        base_score=-0.25,
    )


class DictManifest:
    """An AD-predictor manifest backed by a dict: (gene_id, tissue_id) -> path."""

    def __init__(self, paths: dict):
        self.paths = paths

    def get_file_path(self, gene_id, tissue_id):
        return self.paths.get((gene_id, tissue_id))


SWEEP_REPEATS = 8       # the genome-wide gene list: the 4 genes, 8 times over
SCAN_POSITIONS = 12     # the saturation scan's positions inside one CRE of GENE1.1
SCAN_VARIANTS = 8       # variants a scan dispatch: D = 16
AD_TISSUES = (0, 7, 13, 53)  # one tissue id per gene of the AD-risk query
AD_TREES = 300
COHORT_ROWS = 65_536    # rows of the cohort-sized AD-risk margin check


def scan_cre(cre_maps: dict, builder, nb: int) -> int:
    """The start of the padded span of the first CRE of GENE1.1 that lies
    inside its gene window: the scan starts 50 bp into it, the live app's
    edit 60 bp."""
    w0, w1 = builder.gene_window(builder.gene_info("GENE1.1"))
    cres = cre_maps["GENE1.1"]
    return next(int(a) - nb for a, b in zip(cres["start_cre"], cres["end_cre"])
                if w0 < int(a) - nb and int(b) + nb <= w1)


def sweep_path(torch, root: Path, cre_maps: dict, want_preds, cfg=None,
               device: str = "cuda") -> dict:
    """Sweeps, AD risk, the reports and the live app at full v4_pcg width and
    depth (``cfg`` and ``device`` only for a rehearsal on the CPU at a small
    width), through the public entry points: ``genome_wide_expression`` of
    the 4 genes 8 times over after a warm-up dispatch (batch_size 4; then
    once at batch_size 3, the trailing group padded), ``saturation_scan`` of
    12 positions x 3 alts in one CRE of GENE1.1 at 54 tissues (D=16
    dispatches), ``ADriskFromVCF`` over a seeded 300-tree ensemble, the
    report writers, and the live app's HTTP round trip (D=1 at every tissue of the vocabulary). Then, with the
    path's launch counts read: a scan dispatch, the AD-risk dispatches and
    the live app's values held against the plain versions or ``predict``, a
    scan dispatch timed and profiled, a genome-wide dispatch traced by
    ``device_trace`` and its launch timed with the card idle, and
    ``torch_predict_margin`` on a cohort-sized matrix against
    ``raw_margin``. Returns the path's launch counts."""
    import re
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pandas as pd
    import yaml

    from variantformer_tpu_torch.api.ad_risk import (
        ADriskFromVCF,
        TreeEnsemble,
        torch_predict_margin,
    )
    from variantformer_tpu_torch.api.anatomagram import anatomagram_html
    from variantformer_tpu_torch.api.live import LiveExpressionApp
    from variantformer_tpu_torch.api.sweeps import (
        BUILD_WORKERS,
        genome_wide_expression,
        saturation_scan,
    )
    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.api.visualization import expression_report, tissue_group
    from variantformer_tpu_torch.api.webapp import vcf2embed_app, vcf2exp_app, vcf2risk_app
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward_plain
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.utils import assets
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.profiling import device_trace

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    no_remote_fetch(root)
    cfg = cfg or ModelConfig()
    sources = genome_sources(root, cre_maps)
    donor = str(root / "donor.vcf.gz")
    genes = [g for g, *_ in GENES]
    tissues54 = [f"tissue{i}" for i in range(54)]
    params = init_seq2gene(cfg, SEED, device=device)
    proc = VCFProcessor(sources=sources, config=cfg, device=device)
    proc.set_params(params)
    vp = VariantProcessor(sources=sources, config=cfg, device=device)
    vp.set_params(params)
    del params

    # Every dispatch of the path: (phase, batch, output).
    dispatched: list[tuple[str, object, object]] = []
    phase = ["genome-wide warm-up"]
    recorded = (proc, vp._vp)
    for target in recorded:
        def recording(batch, return_streams=False, narrow_embeddings=False,
                      forward=target._forward):
            out = forward(batch, return_streams=return_streams,
                          narrow_embeddings=narrow_embeddings)
            dispatched.append((phase[0], batch, out))
            return out

        target._forward = recording

    def phase_dispatches(name):
        return [(b, o) for p, b, o in dispatched if p == name]

    reset_launches()   # the path's counts start here
    counts = [dict(kernels.LAUNCHES)]

    def phase_launches(name: str) -> None:
        """Print the launches since the last phase, in all and a dispatch."""
        now = dict(kernels.LAUNCHES)
        diff = {k: now[k] - counts[-1][k] for k in now if now[k] - counts[-1][k]}
        n = max(len(phase_dispatches(name)), 1)
        counts.append(now)
        print(f"sweeps {name} launches {json.dumps(diff)}; per dispatch "
              f"{json.dumps({k: round(v / n, 3) for k, v in diff.items()})}")

    # --- genome-wide expression: 32 builds, 8 dispatches at D=4 ---
    # One dispatch first, so the timed sweep finds the files in the page
    # cache and the card's allocator warm.
    genome_wide_expression(proc, donor, tissues54, genes=genes, batch_size=4)
    sync()
    phase_launches(phase[0])
    phase[0] = "genome-wide"
    gw_genes = genes * SWEEP_REPEATS
    stats: dict = {}
    t0 = time.perf_counter()
    gw = genome_wide_expression(proc, donor, tissues54, genes=gw_genes, batch_size=4,
                                stats=stats)
    sync()
    gw_s = time.perf_counter() - t0
    shapes = [tuple(b.gene_tokens.shape[:1]) + (len(b.tissue_ids),)
              for b, _ in phase_dispatches("genome-wide")]
    print(f"genome-wide: {len(gw_genes)} genes x 54 tissues in {gw_s:.3f} s, "
          f"{len(gw_genes) / gw_s:.4f} genes/s; wall_s {stats['wall_s']}; stages "
          f"{json.dumps(stats['stages'])}; dispatches "
          f"(D, T) {shapes}; {card()}")
    require(shapes == [(4, 54)] * 8, f"genome-wide dispatches {shapes}")
    require(len(gw) == len(gw_genes) * 54 and list(gw["gene_id"][::54]) == gw_genes,
            "genome-wide rows")
    gw_preds = gw["predicted_expression"].to_numpy(np.float32).reshape(SWEEP_REPEATS, 4, 54)
    for k in range(SWEEP_REPEATS):
        compare(torch, f"genome-wide group {k} vs predict", torch.from_numpy(gw_preds[k]),
                torch.from_numpy(want_preds), PRED_TOL)
    print(f"genome-wide rows against the vcf2exp path's predict: the same bits: "
          f"{all(np.array_equal(gw_preds[k], want_preds) for k in range(SWEEP_REPEATS))}")
    phase_launches("genome-wide")

    phase[0] = "genome-wide padded"
    t0 = time.perf_counter()
    gw3 = genome_wide_expression(proc, donor, tissues54, genes=genes, batch_size=3)
    sync()
    gw3_s = time.perf_counter() - t0
    shapes3 = [int(b.gene_tokens.shape[0]) for b, _ in phase_dispatches(phase[0])]
    require(shapes3 == [3, 3], f"batch_size=3 dispatches {shapes3}")
    require(list(gw3["gene_id"][::54]) == genes, "batch_size=3 rows")
    preds3 = gw3["predicted_expression"].to_numpy(np.float32).reshape(4, 54)
    compare(torch, "genome-wide batch_size=3 vs batch_size=4", torch.from_numpy(preds3),
            torch.from_numpy(gw_preds[0]), PRED_TOL)
    print(f"genome-wide batch_size=3: 4 genes in {gw3_s:.3f} s, dispatches at D={shapes3} "
          f"(the trailing gene padded to 3); the same bits as batch_size=4: "
          f"{np.array_equal(preds3, gw_preds[0])}")
    phase_launches(phase[0])

    # --- saturation scan: 12 positions x 3 alts in one CRE of GENE1.1 ---
    phase[0] = "scan"
    seq = FastaReader(sources.fasta_path).fetch("chr1", 0, CHR_LEN)
    cre_a = scan_cre(cre_maps, proc._builder(None), cfg.dataset.cre_neighbour_hood)
    p0 = cre_a + 50
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scan = saturation_scan(vp, "chr1", p0, p0 + SCAN_POSITIONS - 1, "GENE1.1", tissues54,
                           variants_per_batch=SCAN_VARIANTS)
    sync()
    scan_s = time.perf_counter() - t0
    scan_disp = phase_dispatches("scan")
    shapes = [int(b.gene_tokens.shape[0]) for b, _ in scan_disp]
    n_snv = SCAN_POSITIONS * 3
    print(f"saturation scan: {n_snv} SNVs x 54 tissues in {scan_s:.3f} s, "
          f"{n_snv / scan_s:.4f} SNVs/s; dispatches at D={shapes}; variant types "
          f"{sorted(set(scan['variant_type']))}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30 if cuda else 0:.2f} GiB; {card()}")
    require(shapes == [2 * SCAN_VARIANTS] * 6, f"scan dispatches {shapes}")
    require(len(scan) == n_snv * 2 * 54, f"scan rows {len(scan)}")
    require(scan.groupby("tissue")["ref_expression"].nunique().eq(1).all()
            and scan["tissue"].nunique() == 54, "one ref_expression per tissue")
    require(np.isfinite(scan["log2fc"]).all(), "non-finite log2fc")
    hom = scan[scan["zygosity"] == "2"]
    require((hom["expression"] != hom["ref_expression"]).any(), "no hom edit moved expression")
    phase_launches("scan")

    # --- AD risk: 4 genes, one tissue each, D=1 T=1 dispatches ---
    phase[0] = "ad risk"
    first = phase_dispatches("genome-wide")[0][1].pooled_embedding.float().cpu().numpy()
    flat = first.reshape(-1, first.shape[-1])
    ens = seeded_ensemble(SEED, AD_TREES, flat.min(0), flat.max(0))
    pred_path = root / "ad_risk" / "predictor.npz"
    pred_path.parent.mkdir(parents=True, exist_ok=True)
    ens.save(str(pred_path))
    manifest = DictManifest({(g, t): str(pred_path) for g in genes for t in AD_TISSUES})
    t0 = time.perf_counter()
    risk = ADriskFromVCF(proc, manifest=manifest)(donor, genes, list(AD_TISSUES))
    sync()
    ad_s = time.perf_counter() - t0
    loaded = TreeEnsemble.load(str(pred_path))
    risks = risk["ad_risk"].to_numpy(np.float64)
    require(((risks >= 0) & (risks <= 1)).all(), f"ad_risk outside [0, 1]: {risks}")
    for (_, row), r in zip(risk.iterrows(), risks):
        want = float(loaded(np.atleast_2d(np.asarray(row["embedding"][0], np.float32)))[0])
        require(r == want, f"ad_risk {r} != the ensemble on the returned embedding {want}")
    require(list(risk["tissue_id"]) == list(AD_TISSUES), "AD-risk tissue ids")
    shapes = [tuple(b.gene_tokens.shape[:1]) + (len(b.tissue_ids),)
              for b, _ in phase_dispatches("ad risk")]
    print(f"AD risk: {len(risk)} (gene, tissue) rows in {ad_s:.3f} s; dispatches (D, T) "
          f"{shapes}; ad_risk {[round(float(r), 6) for r in risks]}; {AD_TREES} trees, "
          f"{len(ens.feature)} nodes; each the ensemble on the returned embedding; {card()}")
    phase_launches("ad risk")

    # --- reports from the frames above ---
    with open(assets.resolve_vocab_path("tissue_vocab.yaml")) as fh:
        released = {v: k for k, v in yaml.safe_load(fh).items()}
    # tissueN is id N of the released vocabulary (which has no id 1)
    name_of = {f"tissue{i}": released.get(i, f"tissue{i}") for i in range(VOCAB_TISSUES)}
    values = {g: {name_of[t]: float(v) for t, v in zip(grp["tissue"], grp["predicted_expression"])}
              for g, grp in gw.iloc[:4 * 54].groupby("gene_id", sort=False)}
    pred_df = pd.DataFrame({"gene_id": list(values),
                            "tissue_names": [list(v) for v in values.values()],
                            "predicted_expression": [list(v.values()) for v in values.values()]})
    risk_df = risk.assign(tissue_name=[name_of[f"tissue{t}"] for t in risk["tissue_id"]])
    xy = flat - flat.mean(0)
    xy = xy @ np.linalg.svd(xy, full_matrices=False)[2][:2].T   # the embeddings' 2 PCs
    embed_df = pd.DataFrame({
        "gene_id": np.repeat(genes, 54), "tissue": [name_of[t] for t in tissues54] * 4,
        "predicted_expression": gw_preds[0].reshape(-1),
        "cluster": [tissue_group(name_of[t]) for t in tissues54] * 4,
        "x": xy[:, 0], "y": xy[:, 1]})
    rep = root / "reports"
    rep.mkdir(exist_ok=True)
    written = {
        "vcf2exp_app": vcf2exp_app(pred_df, rep / "vcf2exp.html"),
        "vcf2risk_app": vcf2risk_app(risk_df, rep / "vcf2risk.html"),
        "vcf2embed_app": vcf2embed_app(embed_df, rep / "vcf2embed.html"),
        "anatomagram_html": anatomagram_html(values, rep / "anatomagram.html"),
        "expression_report": expression_report(values, rep / "report.html"),
    }
    sizes = {k: Path(p).stat().st_size for k, p in written.items()}
    require(all(s > 1000 for s in sizes.values()), f"report sizes {sizes}")
    require("UBERON_0002107" in Path(written["anatomagram_html"]).read_text(),
            "the anatomagram drew no liver")
    print(f"reports (bytes): {json.dumps(sizes)}")

    # --- the live app: GET /, POSTs at D=1 over every tissue ---
    phase[0] = "live"
    app = LiveExpressionApp(proc, vcf_path=donor, workdir=str(root / "live"))
    srv = app.make_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    all_tissues = list(proc.get_tissues())
    edit_pos = cre_a + 60
    edit = {"chrom": "chr1", "pos": edit_pos, "ref": seq[edit_pos - 1],
            "alt": "ACGT"[("ACGT".index(seq[edit_pos - 1]) + 1) % 4], "zygosity": "het"}
    host, port = srv.server_address
    live = {}
    try:
        def post(label, payload):
            req = urllib.request.Request(
                f"http://{host}:{port}/api/predict", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    code, body = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                code, body = exc.code, json.loads(exc.read())
            live[label] = (code, body, time.perf_counter() - t0)
            return code, body

        t0 = time.perf_counter()
        page = urllib.request.urlopen(f"http://{host}:{port}/", timeout=60).read().decode()
        get_s = time.perf_counter() - t0
        for needle in ("id='gene'", "id='edits'", "id='run'", "id='tbl'", "/api/predict",
                       "data-uberon="):
            require(needle in page, f"live page lacks {needle}")
        for ref in set(re.findall(r"getElementById\('([^']+)'\)", page)):
            require(f"id='{ref}'" in page, f"live page's JS names a missing #{ref}")
        query = {"gene": "GENE1.1", "tissues": all_tissues}
        code, base = post("first", query)
        require(code == 200 and not base["cached"], f"live POST: {code} {base}")
        require(list(base["values"]) == all_tissues, "live values' tissues")
        code, again = post("again", query)
        require(code == 200 and again["cached"] and again["values"] == base["values"],
                "the same POST again was not served from the cache")
        code, edited = post("edit", dict(query, edits=[edit]))
        require(code == 200 and edited["values"] != base["values"],
                "an in-silico edit inside a CRE of GENE1.1 did not change the values")
        code, bad = post("unknown gene", {"gene": "NOPE.1"})
        require(code == 400 and "unknown gene" in bad["error"], f"unknown gene: {code} {bad}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    print(f"live app: GET / {get_s:.3f} s ({len(page)} bytes); " + "; ".join(
        f"POST {label}: HTTP {code}, {secs:.3f} s by the client"
        + (f", {body['seconds']} s by the app, cached {body['cached']}" if code == 200 else "")
        for label, (code, body, secs) in live.items()) + f"; {card()}")
    phase_launches("live")
    for target in recorded:
        del target._forward   # the class's own again: nothing more is recorded

    launches = dict(kernels.LAUNCHES)
    print(f"sweeps path launches {json.dumps(launches)} over {len(dispatched)} dispatches")
    if cuda:
        for name in SERVING_KERNELS:
            require(kernel_ran(launches, name),
                    f"kernel {name} was not launched on the sweeps path")
        require_cre_chain("sweeps path", launches)

    # --- against the plain versions and predict (launches not counted) ---
    batch, out = scan_disp[1]   # the first full D=16 batch of variants
    dev_batch = vp._vp._to_device(batch)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        plain = seq2gene_forward_plain(vp._vp._params, dev_batch, cfg)
    compare(torch, "scan dispatch D=16 T=54 pred vs plain", out.pred_expression,
            plain.pred_expression, PRED_TOL)
    compare(torch, "scan dispatch D=16 T=54 embeddings vs plain", out.pooled_embedding,
            plain.pooled_embedding, EMB_TOL)
    print(f"scan dispatch vs plain: peak device memory of the plain forward "
          f"{torch.cuda.max_memory_allocated() / 2**30 if cuda else 0:.2f} GiB")
    del plain
    for i, (b, o) in enumerate(phase_dispatches("ad risk")):
        with torch.inference_mode():
            plain = seq2gene_forward_plain(proc._params, proc._to_device(b), cfg)
        compare(torch, f"AD-risk dispatch {i} (D=1 T=1) embeddings vs plain",
                o.pooled_embedding, plain.pooled_embedding, EMB_TOL)
    want = proc.predict(donor, pd.DataFrame({"gene_id": ["GENE1.1"],
                                             "tissues": [",".join(all_tissues)]}))
    compare(torch, f"live values (D=1 T={len(all_tissues)}) vs predict",
            torch.tensor(list(live["first"][1]["values"].values())),
            torch.from_numpy(np.asarray(want["predicted_expression"][0], np.float32)), PRED_TOL)
    # a scan's three (variant, zygosity) rows against VariantProcessor.predict
    # (REF_HG38: the reference consensus, as the scan's; a ref triple, then pairs)
    jobs = [(p0 + 1, alt) for alt in "ACGT" if alt != seq[p0]][:3]
    var_df = pd.DataFrame({"chrom": "chr1", "pos": [p for p, _ in jobs],
                           "ref": [seq[p - 1] for p, _ in jobs], "alt": [a for _, a in jobs],
                           "tissue": ",".join(tissues54), "gene_id": "GENE1"})
    vep = vp.predict(var_df, str(root / "scan_vep"), vcf_path=donor, sample_name="DONOR")
    vep = vep[(vep["population"] == "REF_HG38") & (vep["genes"] == "GENE1.1")]
    for (pos, alt), zyg in zip(jobs, "122"):
        got = scan[(scan["pos"] == pos) & (scan["alt"] == alt) & (scan["zygosity"] == zyg)]
        ref = vep[(vep["pos"] == pos) & (vep["alt"] == alt) & (vep["zygosity"] == zyg)]
        require(list(got["tissue"]) == list(ref["tissues"]) == tissues54, "scan/predict rows")
        compare(torch, f"scan {pos}{alt} zygosity {zyg} vs VariantProcessor.predict",
                torch.tensor(got["expression"].to_numpy(np.float32)),
                torch.tensor(ref["gene_exp"].to_numpy(np.float32)), PRED_TOL)

    # --- cohort-sized AD-risk margins: torch_predict_margin vs raw_margin ---
    rng = np.random.default_rng(SEED)
    cohort = (flat.mean(0) + flat.std(0) * rng.standard_normal(
        (COHORT_ROWS if cuda else 512, flat.shape[1]))).astype(np.float32)
    t0 = time.perf_counter()
    want_margin = loaded.raw_margin(cohort)
    host_s = time.perf_counter() - t0
    x_dev = torch.from_numpy(cohort).to(device)
    got_margin = torch_predict_margin(loaded, x_dev, device=device)
    np.testing.assert_allclose(got_margin.cpu().numpy(), want_margin, rtol=1e-4, atol=1e-5)
    require(np.unique(want_margin).size > len(cohort) // 2, "the cohort's margins barely vary")
    margin_ms = (time_ms(torch, lambda: torch_predict_margin(loaded, x_dev, device=device), 3)
                 if cuda else float("nan"))
    print(f"torch_predict_margin: {len(cohort)} rows x {flat.shape[1]} features x {AD_TREES} "
          f"trees (max_depth 32) in {margin_ms:.4f} ms by CUDA events, "
          f"{len(cohort) / (margin_ms / 1e3):.1f} rows/s; raw_margin (numpy, host) "
          f"{host_s:.3f} s; within rtol 1e-4 / atol 1e-5 of raw_margin, max abs diff "
          f"{float(np.abs(got_margin.cpu().numpy() - want_margin).max()):.3g}; {card()}")

    if cuda:
        # --- one scan dispatch: CUDA events and the profile by kernel ---
        fwd = lambda: vp._vp._forward(batch)
        ms = time_ms(torch, fwd, 3)
        print(f"scan dispatch D=16 T=54: {ms:.3f} ms by CUDA events, "
              f"{2 * SCAN_VARIANTS / (ms / 1e3):.1f} samples/s; {card()}")
        dev_ms = profile(torch, fwd, "scan dispatch D=16 T=54")
        print(f"saturation scan: device share {len(scan_disp) * dev_ms / 1e3 / scan_s:.4f} "
              f"({len(scan_disp)} dispatches x {dev_ms:.3f} ms of device time over "
              f"{scan_s:.3f} s)")
        # --- one genome-wide dispatch under device_trace ---
        gw_batch = phase_dispatches("genome-wide")[0][0]
        with device_trace(str(root / "trace")) as prof:
            proc._forward(gw_batch)
        trace = Path(prof.trace_file)
        require(trace.exists(), "device_trace wrote no trace file")
        events = json.loads(trace.read_text())["traceEvents"]
        gemms = sum("gemm_sm90_kernel<0" in str(ev.get("name", "")) for ev in events)
        require(gemms > 0, "the trace names no gemm_bf16 launch")
        kernel_ms = sum(ev.get("dur", 0) for ev in events if ev.get("cat") == "kernel") / 1e3
        print(f"device_trace: {trace.name}, {trace.stat().st_size} bytes, {len(events)} "
              f"events, {gemms} gemm_bf16 launches of one genome-wide dispatch, "
              f"{kernel_ms:.3f} ms of kernels; the genome-wide sweep's device share "
              f"{len(gw_genes) // 4 * kernel_ms / 1e3 / stats['wall_s']:.4f}")
        # --- the host's launch of a genome-wide dispatch, the card idle ---
        # In the sweep the `dispatch` stage also holds waits on the card
        # (the batch copies block until the stream is idle); here the card
        # has nothing queued, so the host's return is its launch alone.
        def launch_ms():
            sync()
            t0 = time.perf_counter()
            proc._forward(gw_batch)
            ms = (time.perf_counter() - t0) * 1e3
            sync()
            return ms

        alone = [launch_ms() for _ in range(3)]
        builder, stop = proc._builder(donor), threading.Event()

        def keep_building():
            while not stop.is_set():
                for gene in genes:
                    builder.build(gene)

        with ThreadPoolExecutor(max_workers=BUILD_WORKERS) as pool:
            busy = [pool.submit(keep_building) for _ in range(BUILD_WORKERS)]
            time.sleep(0.5)   # every builder thread under way
            beside = [launch_ms() for _ in range(3)]
            stop.set()
            for job in busy:
                job.result()
        print(f"genome-wide dispatch D=4 T=54, the card idle: the host returns after "
              f"{', '.join(f'{ms:.3f}' for ms in alone)} ms alone and "
              f"{', '.join(f'{ms:.3f}' for ms in beside)} ms beside {BUILD_WORKERS} build "
              f"threads, against {kernel_ms:.3f} ms of kernels and the sweep's `dispatch` "
              f"stage of {stats['stages']['dispatch']['mean_ms']} ms a dispatch; {card()}")
    proc.cleanup()
    vp.cleanup()
    return launches


# The model variants of the variants path: (label, window-encoder fields,
# gene-stack fields). Each takes the route the JAX package's rules give it:
# the whole-stack encoder (#1) for the plain layer flavour with mean pooling,
# the whole-stack gene stack (#2) for full self + cross layers without the
# stack residual at a head dim of at most 64 (hd 32 padded to 64 lanes).
VARIANT_CONFIGS = (
    ("a use_context", {"use_context": True}, {}),
    ("b seq_pool=max", {"seq_pool": "max"}, {}),
    ("c only_cross", {}, {"only_cross_attention": True}),
    ("d only_cross+use_res", {}, {"only_cross_attention": True, "use_res": True}),
    ("e 48 gene heads, hd 32", {}, {"num_heads": 48}),
)


VARIANT_GENE_LAYERS = 8    # the variants path's depth (full width): 8 gene and 7 CRE
VARIANT_WINDOW_LAYERS = 4  # layers, 4 window-encoder layers a tokenizer


def variants_depth_config():
    """v4_pcg at full width, its depth cut for the variants path."""
    from variantformer_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    return dataclasses.replace(
        cfg, window_encoder=dataclasses.replace(cfg.window_encoder,
                                                num_layers=VARIANT_WINDOW_LAYERS),
        seq2gene=dataclasses.replace(cfg.seq2gene, num_layers=VARIANT_GENE_LAYERS))


def variant_config(cfg, wfields: dict, gfields: dict):
    return dataclasses.replace(
        cfg, window_encoder=dataclasses.replace(cfg.window_encoder, **wfields),
        seq2gene=dataclasses.replace(cfg.seq2gene, **gfields))


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def variants_path(torch, root: Path, cre_maps: dict, checks: "Checks", cfg=None,
                  device: str = "cuda") -> dict:
    """The model variants at ``cfg`` (the smoke's: full v4_pcg width, the
    depth of ``variants_depth_config``; ``device`` only for a rehearsal on
    the CPU at a small width):
    ``VCFProcessor.predict`` of the 4 genes x 54 tissues for each of
    ``VARIANT_CONFIGS``, the whole-stack wrappers' launches against the
    route, the predictions against ``seq2gene_forward_plain`` at 5e-2 / 6e-2
    of max |plain| and one forward timed; kernels #1 and #2 held at the
    variants' shapes (#2 on the padded hd-32 packs too); then one
    ``make_seq2gene_train_step`` step at 1 gene x 54 tissues (gene tokenizer
    trained, remat) for (a), (c) and (e), its gradients against the plain
    versions. Returns the launches of the predicts and the steps."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder, pack_samples
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import (
        Seq2GeneBatch,
        seq2gene_forward_plain,
        whole_gene_stack,
    )
    from variantformer_tpu_torch.models.seq2reg import whole_stack
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.ops.alibi import alibi_slopes
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
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import (
        TrainState,
        make_seq2gene_train_step,
        seq2gene_loss_fn,
    )
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    base = cfg or ModelConfig()
    sources = genome_sources(root, cre_maps)
    vcf = str(root / "donor.vcf.gz")
    builder = GeneSampleBuilder(
        cfg=base.dataset, fasta=FastaReader(sources.fasta_path),
        tokenizer=BPETokenizer.from_file(sources.bpe_vocab_path),
        gencode=pd.read_csv(sources.gencode_path), cre_map_provider=cre_maps.get,
        vcf=VCFReader(vcf),
    )
    samples = [builder.build(g) for g, *_ in GENES]
    tissues = list(range(54))
    batch = pack_samples(samples, tissues)
    query = pd.DataFrame({"gene_id": [g for g, *_ in GENES],
                          "tissues": ",".join(f"tissue{i}" for i in tissues)})
    d, c = batch.cre_tokens.shape[:2]
    g1 = batch.gene_tokens.shape[1] + 1
    path = {"path": "variants"}
    counted = torch.device(device).type == "cuda"  # wrappers count card launches only
    total: dict = {}
    for label, wf, gf in VARIANT_CONFIGS:
        vcfg = variant_config(base, wf, gf)
        route = (whole_stack(vcfg.window_encoder), whole_gene_stack(vcfg))
        proc = VCFProcessor(sources=sources, config=vcfg, device=device)
        proc.set_params(init_seq2gene(vcfg, SEED, device=device))
        packed = {"encoder": "layers_packed" in proc._params["cre_tokenizer"],
                  "gene stack": "gene_layers_packed" in proc._params}
        require((packed["encoder"], packed["gene stack"]) == route,
                f"variant {label}: set_params packed {packed}, route {route}")
        reset_launches()
        t0 = time.perf_counter()
        result = proc.predict(vcf, query, batch_size=4)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        add_launches(total, launches)
        if counted:
            require_cre_chain(f"variant {label} predict", launches)
        took = (launches["fused_window_encoder"] > 0, launches["fused_gene_modulator"] > 0)
        require(took == route or not counted, f"variant {label}: launched (encoder, gene "
                f"stack) {took}, route {route}")
        preds = np.stack(result["predicted_expression"].to_list())
        require(preds.shape == (4, 54) and np.isfinite(preds).all(),
                f"variant {label}: predictions {preds.shape}, finite {np.isfinite(preds).all()}")
        out = proc._forward(batch)
        require(np.allclose(out.pred_expression.cpu().numpy(), preds), "predict != _forward")
        dev_batch = proc._to_device(batch)
        with torch.inference_mode():
            plain = seq2gene_forward_plain(proc._params, dev_batch, vcfg)
        compare(torch, f"variant {label} pred vs plain", out.pred_expression,
                plain.pred_expression, PRED_TOL)
        compare(torch, f"variant {label} embeddings vs plain", out.pooled_embedding,
                plain.pooled_embedding, EMB_TOL)
        del out, plain
        fwd_ms = time_ms(torch, lambda: proc._forward(batch), 2)
        print(f"variant {label}: route encoder {'#1 kernels' if route[0] else 'plain loop'}, "
              f"gene stack {'#2 kernels' if route[1] else 'plain loop'}; predict 4 genes x 54 "
              f"tissues in {predict_s:.3f} s; forward {fwd_ms:.3f} ms on the card "
              f"({4 / (fwd_ms / 1e3):.4f} genes/s); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}; {card()}")

        # The kernels at this variant's shapes, its own packed weights.
        mc, we = vcfg.seq2gene, vcfg.window_encoder
        if label.startswith("c"):
            tok = dev_batch.cre_tokens.reshape(d * c, -1)
            lens = dev_batch.cre_tok_len.reshape(d * c).to(torch.int32).contiguous()
            params = proc._params["cre_tokenizer"]
            x = params["token_embedding"][tok.long()].to(torch.bfloat16)
            slopes = torch.from_numpy(alibi_slopes(we.num_heads)).to(x.device)
            e = we.embedding_dim
            args = (x, lens, params["layers_packed"], slopes, (e // we.num_heads) ** -0.5,
                    we.num_heads)
            n, length = tok.shape
            rows = n * length
            a_flops, _ = attn_cost(lens.tolist(), 1, 1, n, length, length, we.num_heads,
                                   e // we.num_heads)
            flops = we.num_layers * (2.0 * rows * (4 * e * e + e * we.ffn_hidden_dim
                                                   + we.ffn_hidden_dim // 2 * e) + a_flops)
            w_bytes = sum(v.numel() * v.element_size() for v in params["layers_packed"].values())
            name = "fused_window_encoder variants only_cross CRE windows"
            checks.run(name, lambda: fused_window_encoder(*args),
                       lambda: fused_window_encoder_plain(*args), None, flops,
                       2.0 * (n * length * e + n * e) + 4.0 * n + w_bytes, record=name,
                       meta={"shape": f"N={n} L={length} E={e} layers={we.num_layers}", **path})
            del x, args
        if label.startswith(("a", "e")):
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED + 11)
            e, heads, ffn = mc.emb_dim, mc.num_heads, mc.ffn_hidden_dim
            hd = e // heads
            gene_stream = torch.randn((d, 54, g1, e), generator=gen, device=device).to(
                torch.bfloat16)
            cre = torch.randn((mc.num_layers, d, c, e), generator=gen, device=device).to(
                torch.bfloat16)
            gl = (dev_batch.gene_count + 1).to(torch.int32).contiguous()
            cl = dev_batch.cre_count.to(torch.int32).contiguous()
            slopes = torch.from_numpy(alibi_slopes(heads)).to(device)
            mod_packed = proc._params["gene_layers_packed"]
            args = (gene_stream, cre, gl, cl, mod_packed, slopes, hd ** -0.5, heads)
            rows = d * 54 * g1
            sa, _ = attn_cost(gl.tolist(), 54, 1, d * 54, g1, g1, heads, hd)
            ca, _ = attn_cost(cl.tolist(), 54, 54, d * 54, g1, c, heads, hd)
            # the true head dim's work: the padded lanes are the kernels' own cost
            flops = mc.num_layers * (2.0 * rows * (6 * e * e + e * ffn + ffn // 2 * e)
                                     + 2.0 * d * c * e * 2 * e + sa + ca)
            w_bytes = 2.0 * mc.num_layers * (8 * e * e + e * ffn + ffn // 2 * e)
            valid = torch.zeros((d, 54, g1), dtype=torch.bool, device=device)
            for i, n in enumerate(gl.tolist()):
                valid[i, :, :n] = True
            name = ("fused_gene_modulator variants hd=32 padded D=4 T=54" if label.startswith("e")
                    else "fused_gene_modulator variants use_context D=4 T=54")
            checks.run(name, lambda: fused_gene_modulator(*args),
                       lambda: fused_gene_modulator_plain(*args), None, flops,
                       2.0 * (2 * rows * e + mc.num_layers * d * c * e) + w_bytes, valid=valid,
                       record=name,
                       meta={"shape": f"D={d} T=54 G1={g1} C={c} E={e} H={heads} hd={hd}"
                                      f" (packed to {mod_packed['wqkv'].shape[-1] // 3 // heads}"
                                      " lanes)", **path})
            del gene_stream, cre, args, mod_packed
        proc.cleanup()
        del proc, result
        torch.cuda.empty_cache()

    # One training step of (a), (c) and (e) at 1 gene x 54 tissues. The
    # gene tokenizer's gradient is exactly 0 under cross-only gene layers
    # (they never mix the gene windows into the registry row the heads
    # read), so (c)'s #3 holds zeros against zeros; (e) runs #1/#3 with a
    # live cotangent and #4-#6 on the padded packs.
    one = pack_samples(samples[:1], tissues)
    targets = torch.from_numpy(np.random.default_rng(SEED).uniform(0.0, 5.0, (1, 54)).astype(
        np.float32)).to(device)
    mask = torch.ones((1, 54), dtype=torch.bool, device=device)
    for label, wf, gf in (VARIANT_CONFIGS[0], VARIANT_CONFIGS[2], VARIANT_CONFIGS[4]):
        vcfg = variant_config(base, wf, dict(gf, remat=True))
        params = init_seq2gene(vcfg, SEED, device=device)
        opt = make_optimizer(params, learning_rate=1e-4, train_gene_tokenizer=True)
        step = make_seq2gene_train_step(vcfg, opt, freeze_tokenizers=True,
                                        train_gene_tokenizer=True)
        dev_one = Seq2GeneBatch(*(None if v is None else torch.as_tensor(v).to(device)
                                  for v in one))
        trained = [(k, t) for k, t in named_leaves(params) if t.requires_grad]

        def grads(plain: bool):
            opt.zero_grad(set_to_none=True)
            torch.cuda.reset_peak_memory_stats()
            loss = seq2gene_loss_fn(params, dev_one, targets, mask, vcfg, stop_cre_grads=True,
                                    plain=plain)
            loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = {k: t.grad.detach().clone() for k, t in trained if t.grad is not None}
            opt.zero_grad(set_to_none=True)
            return float(loss.detach()), got, peak

        reset_launches()
        loss_k, got, peak_k = grads(False)
        launches = dict(kernels.LAUNCHES)
        require_cre_chain(f"variant {label} step gradients", launches, "loop")
        loss_p, want, peak_p = grads(True)
        require(abs(loss_k - loss_p) <= 2e-2 * abs(loss_p), f"variant {label} step: loss "
                f"{loss_k} through the kernels, {loss_p} through the plain versions")
        require(set(got) == set(want), f"variant {label} step: different gradient sets")
        compare_grads(torch, f"variant {label} train step gradients (every trained leaf)",
                      got, want)
        gene_tok = sum(float(g.float().norm()) ** 2 for k, g in got.items()
                       if k.startswith("gene_tokenizer")) ** 0.5
        require(gene_tok > 0 or vcfg.seq2gene.only_cross_attention,
                f"variant {label} step: the gene tokenizer's gradient is 0")
        del got, want
        reset_launches()
        state = TrainState(params, opt, 0)
        state, loss = step(state, dev_one, targets, mask)
        torch.cuda.synchronize()
        add_launches(launches, kernels.LAUNCHES)
        add_launches(total, launches)
        require(bool(torch.isfinite(loss)), f"variant {label} step: loss {float(loss)}")
        encoder_k = ("fused_window_encoder", "fused_window_encoder_bwd")
        gene_k = ("fused_gene_modulator_fwd_save", "fused_gene_modulator_bwd1",
                  "fused_gene_modulator_bwd0")
        want_kernels = {"a": gene_k, "c": encoder_k, "e": encoder_k + gene_k}[label[0]]
        for name in want_kernels:
            require(kernel_ran(launches, name) or not counted,
                    f"variant {label} step: {name} was not launched")
        step_ms = time_ms(torch, lambda: step(state, dev_one, targets, mask), 2)
        # The whole-stack backward kernels of this step's route, timed at its
        # shapes with its own weights (bf16 packs) on seeded inputs.
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 12)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        meta = {"path": "variants"}
        with torch.no_grad():
            if label.startswith("c"):
                we = vcfg.window_encoder
                tok = params["gene_tokenizer"]
                lens = dev_one.gene_tok_len.reshape(-1).to(torch.int32).contiguous()
                x = tok["token_embedding"][dev_one.gene_tokens.reshape(lens.shape[0], -1).long()]
                encoder_bwd_record(
                    torch, checks, pack_encoder_layers(tok["layers"], we.num_heads, torch.bfloat16),
                    x.to(torch.bfloat16), lens, randn(lens.shape[0], we.embedding_dim),
                    torch.from_numpy(alibi_slopes(we.num_heads)).to(device), we.num_heads,
                    "fused_window_encoder_bwd variants only_cross step",
                    "fused_window_encoder_bwd variants only_cross step", meta)
                del x
            else:
                mc = vcfg.seq2gene
                g1_one = dev_one.gene_tokens.shape[1] + 1
                c_one = dev_one.cre_tokens.shape[1]
                suffix = (" variants use_context step" if label.startswith("a")
                          else " variants hd=32 padded step")
                gene_stack_bwd_records(
                    torch, checks, pack_gene_layers(params["gene_layers"], mc.num_heads,
                                                    torch.bfloat16),
                    randn(1, 54, g1_one, mc.emb_dim), randn(mc.num_layers, 1, c_one, mc.emb_dim),
                    (dev_one.gene_count + 1).tolist(), dev_one.cre_count.tolist(),
                    torch.from_numpy(alibi_slopes(mc.num_heads)).to(device), mc.num_heads, randn,
                    suffix, meta)
        print(f"variant {label} train step (1 gene x 54 tissues, bf16, remat, gene tokenizer "
              f"trained): loss {loss_k:.6f} kernels / {loss_p:.6f} plain; gene tokenizer "
              f"|grad| {gene_tok:.6g}; {step_ms:.3f} ms on "
              f"the card; peak device memory {peak_k:.2f} GiB kernels / {peak_p:.2f} GiB plain "
              f"gradients; launches {json.dumps({k: v for k, v in launches.items() if v})}; "
              f"{card()}")
        del params, opt, step, state, trained
        torch.cuda.empty_cache()
    return total


SEQ2REG_TISSUES = {"tissue0": 0, "tissue7": 7}
SEQ2REG_CHUNK = 64


SEQ2REG_LAYERS = 4  # the seq2reg path's depth at the released tokenizer width


def seq2reg_depth_config():
    """The released window encoder's width, its depth cut for the seq2reg path."""
    from variantformer_tpu_torch.config import WindowEncoderConfig

    return dataclasses.replace(WindowEncoderConfig(), num_layers=SEQ2REG_LAYERS)


def seq2reg_path(torch, root: Path, cre_maps: dict, wcfg=None, device: str = "cuda") -> dict:
    """seq2reg training at the released tokenizer width (``wcfg`` and
    ``device`` only for a rehearsal on the CPU at a small width):
    ``Seq2RegShardWriter`` shards of the genome's CREs (2 tissues x 1
    subject of seeded labels, sequences from the port's consensus engine,
    64 windows a chunk, 200 tokens), ``make_optimizer("adamw")``,
    ``make_seq2reg_train_step`` and ``fit`` (an epoch, then a resume for the
    second) with ``make_seq2reg_eval_loss`` and ``make_seq2reg_eval_metrics``,
    for ``use_context`` False and True; a few steps with the focal and dual
    losses, ``plateau="step"`` and ``accumulate_steps=2``; the k=2 update
    against one Adam update on the mean of its two micro-steps' gradients.
    No hand-written kernel may launch (the step is f32 plain PyTorch).
    Returns the path's launches."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.config import ModelConfig, WindowEncoderConfig
    from variantformer_tpu_torch.data.train_pipeline import Seq2RegShardWriter
    from variantformer_tpu_torch.models.init import init_window_encoder
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.train.loop import (
        fit,
        make_seq2reg_eval_loss,
        seq2reg_shard_batches,
    )
    from variantformer_tpu_torch.train.metrics import make_seq2reg_eval_metrics
    from variantformer_tpu_torch.train.optimizer import apply_update, make_optimizer
    from variantformer_tpu_torch.train.steps import (
        TrainState,
        make_seq2reg_train_step,
        seq2reg_loss_fn,
    )
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.constants import CRES
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import ConsensusEngine, VCFReader

    wcfg = wcfg or WindowEncoderConfig()
    sources = genome_sources(root, cre_maps)
    cres = pd.concat(cre_maps.values(), ignore_index=True)
    nb = 50  # the writer's neighbour_hood: label frames are padded by it on both sides
    ref = pd.DataFrame({"chromosome": cres["chromosome"], "start": cres["start_cre"] - nb,
                        "end": cres["end_cre"] + nb, "cCRE": cres["cre_name"]})
    rng = np.random.default_rng(SEED)
    engine = ConsensusEngine(FastaReader(sources.fasta_path), VCFReader(str(root / "donor.vcf.gz")))
    seq_fn = lambda subject, chrom, a, b: engine.consensus(chrom, a, b)[0]
    tok = BPETokenizer.from_file(sources.bpe_vocab_path)
    labels = {t: pd.DataFrame({"chromosome": cres["chromosome"], "start": cres["start_cre"],
                               "end": cres["end_cre"], "tissue_cre": rng.choice(CRES, len(cres))})
              for t in SEQ2REG_TISSUES}
    t0 = time.perf_counter()
    dirs = {}
    for split, test_chr in (("train", "chr8"), ("test", "chr1")):
        dirs[split] = root / f"seq2reg_{split}"
        writer = Seq2RegShardWriter(ref, tok, seq_fn, dirs[split], chunk_size=SEQ2REG_CHUNK,
                                    max_length=200, test_chr=test_chr, neighbour_hood=nb)
        for tissue, bed in labels.items():
            writer.add_labels("DONOR", tissue, bed)
        written = writer.write(np.random.default_rng(SEED))
        want = len(SEQ2REG_TISSUES) * -(-len(cres) // SEQ2REG_CHUNK)
        require(len(written) == want and all(f"/{split}/" in w for w in written),
                f"seq2reg {split} shards: {len(written)} written, {want} wanted")
    z = np.load(written[0])
    require(z["tokens"].shape == (SEQ2REG_CHUNK, 200) and (z["tok_len"] > 0).all(),
            f"seq2reg shard tokens {z['tokens'].shape}")
    print(f"seq2reg shards: {len(cres)} CRE windows x {len(SEQ2REG_TISSUES)} tissues, "
          f"{len(written)} chunks of {SEQ2REG_CHUNK} a split, written twice (train, test) in "
          f"{time.perf_counter() - t0:.2f} s")

    vocab = SEQ2REG_TISSUES
    train_b = seq2reg_shard_batches(dirs["train"], vocab, device=device)
    val_b = seq2reg_shard_batches(dirs["test"], vocab, split="test", shuffle=False,
                                  device=device)
    tissue_names = {v: k for k, v in vocab.items()}
    batches = list(train_b(0))
    per_epoch = len(batches)
    batches = batches[:2]
    total: dict = {}
    for use_context in (False, True):
        label = f"use_context={use_context}"
        cfg = ModelConfig(window_encoder=dataclasses.replace(wcfg, use_context=use_context))
        fresh = lambda: init_window_encoder(cfg.window_encoder, SEED, device=device)
        adamw = lambda p, **kw: make_optimizer(p, learning_rate=1e-4, weight_decay=0.01,
                                               optimizer="adamw", **kw)
        params = fresh()
        opt = adamw(params)
        step = make_seq2reg_train_step(cfg, opt)
        eval_loss = make_seq2reg_eval_loss(cfg, val_b)
        before = {k: t.detach().clone() for k, t in named_leaves(params)}
        ckpt = root / f"seq2reg_ckpt_{use_context}"
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = fit(TrainState(params, opt, 0), step, train_b, eval_loss=eval_loss, epochs=1,
                    ckpt_dir=ckpt)
        params2 = fresh()
        opt2 = adamw(params2)
        res = fit(TrainState(params2, opt2, 0), make_seq2reg_train_step(cfg, opt2), train_b,
                  eval_loss=eval_loss, epochs=2, ckpt_dir=ckpt, resume=True)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        metrics = make_seq2reg_eval_metrics(cfg, val_b, CRES, tissue_names)(res.state)
        # focal + dual losses, the per-step plateau, 2 micro-steps an update
        opt3 = adamw(params2, plateau="step", accumulate_steps=2)
        step3 = make_seq2reg_train_step(cfg, opt3, plateau="step", loss_type="focal", gamma=2.0,
                                        use_dual_loss=True)
        state3 = TrainState(params2, opt3, 0)
        more = []
        for b in batches * 2:
            state3, loss = step3(state3, *b)
            more.append(float(loss))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        add_launches(total, launches)
        losses = [h["train_loss"] for h in res.history] + [h["val_loss"] for h in res.history]
        require(len(res.history) == 2 and res.history[0] == first.history[0],
                f"seq2reg {label}: resume history {res.history}")
        require(res.state.step == 2 * per_epoch, f"seq2reg {label}: step {res.state.step}")
        require(all(np.isfinite(losses + more)), f"seq2reg {label}: losses {losses} {more}")
        require(all(np.isfinite(v) for v in metrics.values()) and "val_acc" in metrics,
                f"seq2reg {label}: metrics {metrics}")
        moved = [k for k, t in named_leaves(params2) if not torch.equal(t, before[k])]
        require(any(k.startswith("layers/") for k in moved) and "token_embedding" in moved
                and "tissue_classifiers/w" in moved, f"seq2reg {label}: moved {moved}")
        require(sum(launches.values()) == 0, f"seq2reg {label}: hand-written kernels launched "
                f"{ {k: v for k, v in launches.items() if v} }")
        n = batches[0][0].shape[0]
        one = lambda: step(TrainState(params, opt, 0), *batches[0])
        step_ms = time_ms(torch, one, 3)
        print(f"seq2reg {label}: fit {len(res.history)} epochs of {per_epoch} steps "
              f"(one, then a resume) in {fit_s:.2f} s, history {json.dumps(res.history)}; "
              f"val_acc {metrics['val_acc']:.4f}; focal + dual, plateau='step', 2 micro-steps: "
              f"losses {more}, plateau scale {opt3.monitor.scale:.4g}; one step {step_ms:.3f} ms "
              f"({n / (step_ms / 1e3):.1f} windows/s, f32, E={wcfg.embedding_dim}, "
              f"{wcfg.num_layers} layers); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; hand-written kernel "
              f"launches 0; {card()}")
        del params, params2, opt, opt2, opt3, state3, res, first
        torch.cuda.empty_cache()

    # accumulate_steps=2: the update on the second micro-step is one AdamW
    # update on the mean of the two micro-steps' gradients (both at the
    # start point: the first micro-step moves nothing), the mean taken as
    # optax's MultiSteps takes it: g1 + (g2 - g1) / 2.
    cfg = ModelConfig(window_encoder=dataclasses.replace(wcfg, use_context=True))
    params = init_window_encoder(cfg.window_encoder, SEED, device=device)
    start = {k: t.detach().clone() for k, t in named_leaves(params)}
    opt = make_optimizer(params, learning_rate=1e-4, weight_decay=0.01, optimizer="adamw",
                         accumulate_steps=2)
    step = make_seq2reg_train_step(cfg, opt)
    state = TrainState(params, opt, 0)
    reset_launches()
    state, _ = step(state, *batches[0])
    require(all(torch.equal(t, start[k]) for k, t in named_leaves(params)),
            "accumulate_steps=2: the first micro-step moved the parameters")
    state, _ = step(state, *batches[1])
    add_launches(total, kernels.LAUNCHES)
    ref = {k: t.clone().requires_grad_(True) for k, t in start.items()}
    tree = {}
    for k, t in ref.items():
        node = tree
        *head, last = k.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t
    grads = []
    for b in batches:
        loss, _ = seq2reg_loss_fn(tree, *b, cfg)
        gs = torch.autograd.grad(loss, list(ref.values()), allow_unused=True)
        grads.append(dict(zip(ref, gs)))
    ref_opt = make_optimizer(tree, learning_rate=1e-4, weight_decay=0.01, optimizer="adamw")
    with torch.no_grad():
        for k, t in ref.items():
            g = [gr[k] for gr in grads]
            t.grad = None if g[0] is None else g[0] + (g[1] - g[0]) / 2
    apply_update(ref_opt, 1.0)
    got = dict(named_leaves(params))
    rels = {k: rel_l2(got[k].detach(), ref[k].detach()) for k in ref}
    key = max(rels, key=rels.get)
    require(rels[key] < 1e-6, f"accumulate_steps=2: {key} rel L2 {rels[key]} from one AdamW "
            "update on the mean gradient")
    print(f"check accumulate_steps=2: the update equals one AdamW update on the mean of the two "
          f"micro-steps' gradients, worst leaf {key} rel L2 {rels[key]:.3g} (tol 1e-6)")
    require(sum(total.values()) == 0, f"seq2reg path launched hand-written kernels: {total}")
    return total


# The rank processes start_ranks starts; main() kills any still running at
# its end (a phase that fails between start_ranks and wait_ranks).
CHILDREN: list = []


def stop_children() -> None:
    for child in CHILDREN:
        if child.poll() is None:
            child.kill()
            child.wait()


def start_ranks(module: str, argv: list, n: int, root: Path, name: str) -> list:
    """Start ``n`` ranks of ``python -m module argv`` on ``cuda:0`` over gloo
    (a ``file://`` store under ``root``), run from this checkout, each
    rank's output in ``root/{name}.rank{r}.log``; ``wait_ranks`` joins
    them. Started early, their start-up overlaps this process's work."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(HERE), env.get("PYTHONPATH")]))
    env.pop("LOCAL_WORLD_SIZE", None)
    ranks = []
    try:
        for r in range(n):
            log = root / f"{name}.rank{r}.log"
            with open(log, "w") as fh:
                ranks.append((subprocess.Popen(
                    [sys.executable, "-m", module, *argv, "--device", "cuda:0",
                     "--backend", "gloo", "--num-processes", str(n), "--process-id", str(r),
                     "--init-method", f"file://{root / (name + '_store')}"],
                    stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=HERE), log))
                CHILDREN.append(ranks[-1][0])
    except BaseException:
        for p, _ in ranks:
            p.kill()
        raise
    return ranks


def wait_ranks(ranks: list, name: str, started: float) -> None:
    """Join ``start_ranks``' ranks: a rank that fails, or a world still
    running 600 s after ``started``, fails the phase (every rank is
    killed)."""
    deadline = started + 600
    try:
        for p, _ in ranks:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, _ in ranks:
            p.kill()
    for r, (p, log) in enumerate(ranks):
        require(p.returncode == 0, f"{name} rank {r}: exit {p.returncode}\n"
                + log.read_text()[-3000:])


# The two-rank training launcher's loss gap to a world of one: the same
# global batches, only the order of the bf16 gradient reduction over gloo
# differs.
TRAIN_RANKS_TOL = 1e-3


def launchers_path(torch, root: Path, cre_maps: dict, want_preds) -> dict:
    """The multi-process launchers (``variantformer_tpu_torch/scripts``),
    through ``main(argv)`` and ``python -m``:

    (a) ``launch_genome_wide`` in real mode at full v4_pcg width and depth,
        on an artifacts directory under the downloader's names
        (``examples/_common.write_artifacts``: the seeded weights as a 4.5 GiB reference-layout
        ``.pth``). A world of one on NCCL in this process: ``load_model``
        gives every leaf the written bf16 bits, #1 and #2 launch, and the
        rows of the 4 genes x the released vocabulary's tissues with ids
        below 54 lie within 5e-2 of the vcf2exp ``predict``'s; and two
        processes on the card over gloo, started before the world of one so
        that their start-up overlaps it: ``stats.json`` genes [2, 2], the
        rows of both within 5e-2 of the world of one's (and whether the bits
        are equal).
    (b) ``launch_train``: a world of one on NCCL in this process at full
        width and depth from its seeded init, over the training path's
        ``TrainingShardWriter`` shards of the 4 genes (global batch 2, one
        epoch): #1 and #3-#6 launched (with (a)'s #2, every kernel of
        #1-#6), finite losses, ``trained/`` written. Two processes on the
        card over gloo at full width and the mesh path's cut depth from a
        port checkpoint written here, started before the world of one: each
        epoch's train loss within ``TRAIN_RANKS_TOL`` relative of a world of
        one on the same checkpoint.
    Each in-process run ends with ``shutdown_distributed()``. Returns the
    launch counts of the two in-process runs at full depth."""
    import numpy as np
    import pandas as pd
    import yaml

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.examples import _common
    from variantformer_tpu_torch.models.checkpoint import save_checkpoint
    from variantformer_tpu_torch.models.init import count_params, init_seq2gene
    from variantformer_tpu_torch.models.params import map_tree
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.parallel.launch import shutdown_distributed
    from variantformer_tpu_torch.scripts import launch_genome_wide, launch_train
    from variantformer_tpu_torch.utils import assets

    total: dict = {}
    cfg = ModelConfig()
    params = map_tree(lambda t: t.cpu(), init_seq2gene(cfg, SEED, device="cuda"))
    t0 = time.perf_counter()
    artifacts = _common.write_artifacts(root / "artifacts_real", root / "genome.fa",
                                        root / "gencode.csv", cre_maps, params, cfg)
    write_s = time.perf_counter() - t0
    saved_dir = os.environ.get("VFX_ARTIFACTS_DIR")
    os.environ["VFX_ARTIFACTS_DIR"] = str(artifacts)
    require(_common.artifacts_present(), "the artifacts layout is not the downloader's")
    with open(assets.resolve_vocab_path("tissue_vocab.yaml")) as fh:
        vocab = yaml.safe_load(fh)
    tissues = sorted((t for t, i in vocab.items() if i < 54), key=vocab.get)
    genes = [g for g, *_ in GENES]
    gw = ["--vcf", str(root / "donor.vcf.gz"), "--tissues", ",".join(tissues),
          "--batch-size", "4"]
    gw_module = "variantformer_tpu_torch.scripts.launch_genome_wide"

    def rows(out: Path, host: int) -> dict:
        df = pd.concat([pd.read_parquet(f) for f in sorted((out / f"host_{host:03d}").glob(
            "*.parquet"))])
        require(len(df) == len(set(zip(df["gene_id"], df["tissue"]))), f"{out}: repeated rows")
        got = {(g, t): v for g, t, v in zip(df["gene_id"], df["tissue"],
                                            df["predicted_expression"])}
        return got

    # (a) the genome-wide launcher, real mode: two ranks over gloo started
    # first (their start-up and load_model overlap the world of one), then
    # a world of one in this process.
    t_two = time.monotonic()
    gw_ranks = start_ranks(gw_module, [*gw, "--out", str(root / "gw2")], 2, root, "gw2")
    loaded = {}
    load_model = VCFProcessor.load_model

    def spy(self, *a, **kw):
        t = time.perf_counter()
        loaded["params"] = load_model(self, *a, **kw)
        torch.cuda.synchronize()
        loaded["s"] = time.perf_counter() - t
        loaded["config"] = self.config
        return loaded["params"]

    VCFProcessor.load_model = spy
    reset_launches()
    try:
        stats1 = launch_genome_wide.main([*gw, "--out", str(root / "gw1"), "--device", "cuda:0",
                                          "--init-method", f"file://{root / 'gw1_store'}"])
        torch.cuda.synchronize()
    finally:
        VCFProcessor.load_model = load_model
        shutdown_distributed()
    launches = dict(kernels.LAUNCHES)
    add_launches(total, launches)
    for name in SERVING_KERNELS:
        require(kernel_ran(launches, name), f"kernel {name} was not launched by launch_genome_wide")
    require_cre_chain("launch_genome_wide", launches)
    require(not loaded["config"].seq2gene.multi_head
            and not loaded["config"].window_encoder.use_context,
            "load_model read the wrong head layout or encoder flavour")
    n = 0
    for name, leaf in named_leaves(params):
        got = loaded["params"]
        for k in name.split("/"):
            got = got[k]
        require(got.dtype == torch.bfloat16 and got.is_cuda, f"{name}: {got.dtype} {got.device}")
        require(torch.equal(got.cpu(), leaf.to(torch.bfloat16)), f"loaded {name} != written")
        n += leaf.numel()
    print(f"load_model (launch_genome_wide, real mode): {loaded['s']:.3f} s "
          f"({count_params(params)} parameters from a "
          f"{(artifacts / _common.CHECKPOINTS['v4_pcg']).stat().st_size / 2**30:.2f} GiB "
          f"reference-layout .pth; the artifacts laid out in {write_s:.3f} s); every leaf the "
          f"written bf16 bits ({n} values); {card()}")
    del params, loaded
    one = rows(root / "gw1", 0)
    require(stats1["genes"] == 4 and len(one) == 4 * len(tissues), f"world of one {stats1}")
    got = torch.tensor([[one[(g, t)] for t in tissues] for g in genes])
    want = torch.from_numpy(np.asarray(want_preds))[:, [vocab[t] for t in tissues]]
    compare(torch, f"launch_genome_wide world of one (real mode, 4 genes x {len(tissues)} "
            f"tissues) vs vcf2exp predict", got, want, PRED_TOL)
    print(f"launch_genome_wide world of one (NCCL): {stats1['genes']} genes in "
          f"{stats1['seconds']} s, {stats1['genes_per_sec']} genes/s; launches "
          f"{json.dumps({k: launches[k] for k in SERVING_KERNELS})}; {card()}")

    # ... and the two processes on the card over gloo.
    wait_ranks(gw_ranks, "gw2", t_two)
    stats2 = [json.loads((root / "gw2" / f"host_{r:03d}" / "stats.json").read_text())
              for r in range(2)]
    require([s["genes"] for s in stats2] == [2, 2], f"two ranks' genes {stats2}")
    two = {**rows(root / "gw2", 0), **rows(root / "gw2", 1)}
    require(set(two) == set(one), "the two ranks' rows are not the world of one's")
    keys = sorted(one)
    compare(torch, "launch_genome_wide two ranks (gloo, one card) vs the world of one",
            torch.tensor([two[k] for k in keys]), torch.tensor([one[k] for k in keys]), PRED_TOL)
    same = all(two[k] == one[k] for k in keys)
    print(f"launch_genome_wide two ranks (gloo on one card, python -m): "
          f"{'the same bits as' if same else 'differs in bits from'} the world of one; "
          + "; ".join(f"rank {s['host']}: {s['genes']} genes in {s['seconds']} s, "
                      f"{s['genes_per_sec']} genes/s" for s in stats2)
          + f"; {time.monotonic() - t_two:.1f} s with start-up and load_model, beside the "
          f"world of one; {card()}")
    if saved_dir is None:
        os.environ.pop("VFX_ARTIFACTS_DIR", None)
    else:
        os.environ["VFX_ARTIFACTS_DIR"] = saved_dir
    torch.cuda.empty_cache()

    # (b) the training launcher: two ranks at the mesh path's cut depth from
    # a checkpoint, started first (their start-up overlaps this process's
    # runs), then a world of one at full depth in this process.
    shards = root / "shards"
    tissue_ids = ",".join(str(i) for i in range(54))
    train = ["--shards", str(shards), "--tissue-ids", tissue_ids, "--global-batch", "2"]
    train_module = "variantformer_tpu_torch.scripts.launch_train"
    small = dataclasses.replace(
        cfg, window_encoder=dataclasses.replace(cfg.window_encoder,
                                                num_layers=MESH_WINDOW_LAYERS),
        seq2gene=dataclasses.replace(cfg.seq2gene, num_layers=MESH_GENE_LAYERS))
    ckpt = root / "train_ckpt"
    save_checkpoint(ckpt, init_seq2gene(small, SEED + 1, device="cuda"), small)
    cut = [*train, "--epochs", "2", "--checkpoint", str(ckpt)]
    t_two = time.monotonic()
    train_ranks = start_ranks(train_module, [*cut, "--out", str(root / "train2")], 2, root,
                              "train2")
    reset_launches()
    try:
        hist = launch_train.main([*train, "--epochs", "1", "--out", str(root / "train1"),
                                  "--device", "cuda:0",
                                  "--init-method", f"file://{root / 'train1_store'}"])
        torch.cuda.synchronize()
    finally:
        shutdown_distributed()
    launches = dict(kernels.LAUNCHES)
    add_launches(total, launches)
    losses = [e["train_loss"] for e in hist["epochs"]]
    print(f"launch_train world of one (NCCL, full v4_pcg, seeded init, 2 steps of 2 genes x 54 "
          f"tissues): losses {losses}; {hist['fit_seconds'] / hist['steps']:.3f} s a step "
          f"(host clock, the first step's warm-up and the epoch's bookkeeping included); "
          f"launches {json.dumps(launches)}; {card()}")
    # Training runs the gene stack through #4-#6; the inference stacks (#2
    # and the CRE stack's chain) run where a validation loss is asked for,
    # and the launcher, as the JAX one, asks for none: the two worlds of one
    # launch #1-#6 and the chain together.
    require_cre_chain("launch_train", launches, "loop")
    for name in (set(kernels.LAUNCHES) - set(PROBE_KERNELS)
                 - {"fused_gene_modulator", "cre_stack"}):
        require(kernel_ran(launches, name), f"kernel {name} was not launched by launch_train")
    for name in set(kernels.LAUNCHES) - set(PROBE_KERNELS):
        require(total[name] > 0, f"kernel {name} was not launched by the launchers")
    require(hist["steps"] == 2 and np.isfinite(losses).all(), f"launch_train {hist}")
    require((root / "train1" / "trained" / "params.pt").exists(), "rank 0 wrote no trained/")
    torch.cuda.empty_cache()

    # ... and the two processes at the mesh path's cut depth, against a world
    # of one on the same checkpoint.
    try:
        hist1 = launch_train.main([*cut, "--out", str(root / "train_cut1"), "--device", "cuda:0",
                                   "--init-method", f"file://{root / 'train_cut1_store'}"])
    finally:
        shutdown_distributed()
    wait_ranks(train_ranks, "train2", t_two)
    hist2 = [json.loads((root / "train2" / f"host_{r:03d}" / "history.json").read_text())
             for r in range(2)]
    one_l = [e["train_loss"] for e in hist1["epochs"]]
    gaps = []
    for r, h in enumerate(hist2):
        two_l = [e["train_loss"] for e in h["epochs"]]
        require(len(two_l) == len(one_l) == 2 and h["steps"] == 4, f"rank {r}: {h}")
        gap = max(abs(a - b) / abs(b) for a, b in zip(two_l, one_l))
        require(gap <= TRAIN_RANKS_TOL, f"launch_train rank {r}: losses {two_l} vs {one_l}")
        gaps.append(gap)
    print(f"check launch_train two ranks (gloo on one card, python -m, {MESH_GENE_LAYERS} gene / "
          f"{MESH_GENE_LAYERS - 1} CRE / {MESH_WINDOW_LAYERS} window layers, from a port "
          f"checkpoint): each epoch's train loss vs the world of one's, worst relative gap "
          f"{max(gaps):.3g} (tol {TRAIN_RANKS_TOL}); losses {[e['train_loss'] for e in hist2[0]['epochs']]} vs "
          f"{one_l}; s a step: world of one {hist1['fit_seconds'] / hist1['steps']:.3f}, "
          + ", ".join(f"rank {r} {h['fit_seconds'] / h['steps']:.3f}" for r, h in enumerate(hist2))
          + f" (host clock, beside this process's runs); {time.monotonic() - t_two:.1f} s "
          f"with start-up; {card()}")
    torch.cuda.empty_cache()
    return total


# The example flows of the examples path, in their order; the two AD-risk
# flows fit a demo predictor with scikit-learn.
EXAMPLE_FLOWS = ("vcf2exp", "variant2exp", "vcf2embed", "snp_indel_predictions",
                 "eqtl_analysis", "vcf2risk", "variant2risk", "finetune_seq2gene", "live_app")
SKLEARN_FLOWS = ("vcf2risk", "variant2risk")


def examples_path(torch, root: Path) -> dict:
    """Every example flow (``variantformer_tpu_torch/examples``) in synthetic
    mode on the card, in this process (the tiny model: E=32, 4 heads of 8
    packed to 64 lanes, the GEMMs at K=32), each with its launches read:
    vcf2exp launches #1 and #2, and its predictions and embeddings lie within
    5e-2 / 6e-2 of the plain forward's (``impl="xla"``, the same weights);
    finetune_seq2gene launches #1, #2, #4, #5 and #6 (its tokenizers are
    frozen, as in the JAX flow, so #3 has nothing to do) and lowers the
    validation loss, and one of its train steps' gradients lie within rel L2
    5e-2 of the plain versions' (``finetune_grad_parity``). Where scikit-learn is missing the two AD-risk flows,
    which fit a demo predictor with it, are named and left to the CPU
    tests. Returns the summed launches."""
    import importlib

    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.examples import _common
    from variantformer_tpu_torch.ops import kernels

    no_remote_fetch(root)  # no artifacts under the root: synthetic mode
    require(not _common.artifacts_present(), "the examples path found artifacts")
    try:
        import sklearn  # noqa: F401
        flows = EXAMPLE_FLOWS
    except ImportError:
        flows = tuple(f for f in EXAMPLE_FLOWS if f not in SKLEARN_FLOWS)
        print(f"examples: scikit-learn is not installed: "
              f"{', '.join(SKLEARN_FLOWS)} (a demo predictor fitted with it) run on the CPU "
              f"tests only (tests/test_torch_examples.py); the AD-risk machinery is held on "
              f"the card by the sweeps path")
    total: dict = {}
    results = {}
    for name in flows:
        module = importlib.import_module(f"variantformer_tpu_torch.examples.{name}")
        reset_launches()
        t0 = time.perf_counter()
        results[name] = module.main(root / "examples" / name, device="cuda")
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        add_launches(total, launches)
        print(f"example {name}: {time.perf_counter() - t0:.2f} s on the card; launches "
              f"{json.dumps(launches)}")
        require_cre_chain(f"example {name}", launches, "some" if name == "vcf2exp" else "any")
        results[name + " launches"] = launches

    out = results["vcf2exp"]
    require(len(out) == 2, "vcf2exp: rows")
    for k in ("fused_window_encoder", "fused_gene_modulator", "cre_stack"):
        require(results["vcf2exp launches"].get(k, 0) > 0, f"vcf2exp did not launch {k}")
    sources, cfg, extras = _common.synthetic_env(root / "examples" / "vcf2exp" / "env")
    plain = VCFProcessor(sources=sources, config=cfg, device="cuda", impl="xla")
    plain.set_params(_common.synthetic_params(cfg, "cuda"))
    ref = plain.predict(extras["vcf"], pd.DataFrame(
        {"gene_id": ["GENE1.1", "GENE2.1"], "tissues": ["tissue0,tissue3"] * 2}))
    for col, tol in (("predicted_expression", PRED_TOL), ("embeddings", EMB_TOL)):
        compare(torch, f"example vcf2exp {col} (synthetic, E=32, hd 8 in 64 lanes) vs the "
                f"plain forward", torch.from_numpy(np.stack(out[col]).astype(np.float32)),
                torch.from_numpy(np.stack(ref[col]).astype(np.float32)), tol)
    plain.cleanup()
    eqtl = results["variant2exp"]
    require(any("log2fc" in c for c in eqtl.columns), "variant2exp: no log2fc column")
    require({"x", "y"} <= set(results["vcf2embed"].columns), "vcf2embed: no projection")
    require(len(results["snp_indel_predictions"]) >= 2, "snp_indel_predictions: rows")
    require(len(results["eqtl_analysis"]) >= 3, "eqtl_analysis: associations")
    for name in set(SKLEARN_FLOWS) & set(flows):
        require(len(results[name]) >= 1, f"{name}: rows")
    res, ft = results["finetune_seq2gene"]
    require(res.history[-1]["val_loss"] < res.history[0]["val_loss"] and len(ft) == 2,
            f"finetune_seq2gene: {res.history}")
    for k in ("fused_window_encoder", "fused_gene_modulator", "fused_gene_modulator_fwd_save",
              "fused_gene_modulator_bwd1", "fused_gene_modulator_bwd0"):
        require(results["finetune_seq2gene launches"].get(k, 0) > 0,
                f"finetune_seq2gene did not launch {k}")
    finetune_grad_parity(torch, root / "examples" / "finetune_seq2gene", res.state.params)
    live = results["live_app"]
    require(live["edited"] is not None and np.isfinite(list(live["base"]["values"].values())).all(),
            "live_app: no edited answer")
    print(f"examples: {len(flows)} of {len(EXAMPLE_FLOWS)} flows ran on the card; finetune val "
          f"loss {res.history[0]['val_loss']:.4f} -> {res.history[-1]['val_loss']:.4f}; "
          f"launches {json.dumps(total)}; {card()}")
    return total


def finetune_grad_parity(torch, flow_root: Path, fitted: dict) -> None:
    """One seq2gene train step of the finetune flow at the tiny model's
    shapes (K=32 GEMMs, head dim 8 packed to 64 lanes, tokenizers frozen as
    in the flow), on the flow's shards and config: from the seeded init and
    from the flow's fitted parameters, every trained leaf's gradient through
    the kernels (#1, #4-#6 and the inner backward kernels, whose launches
    are read) within rel L2 5e-2 of the plain versions' bf16 gradient; a
    leaf that bf16 cannot resolve (the plain bf16 gradient itself strays
    from the f32 one) may instead stay no further from the f32 gradient
    than 1.25x the plain's, as the training path's exact parity."""
    import yaml

    from variantformer_tpu_torch.config import PrecisionPolicy
    from variantformer_tpu_torch.examples import _common
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.train.loop import seq2gene_shard_batches
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import seq2gene_loss_fn

    sources, cfg, _ = _common.synthetic_env(flow_root / "env")
    with open(sources.tissue_vocab_path) as fh:
        vocab = yaml.safe_load(fh)
    batch = next(iter(seq2gene_shard_batches(
        flow_root / "shards", [vocab["tissue0"], vocab["tissue3"]], batch_size=2,
        shuffle=False, device="cuda")(0)))
    cfg32 = dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))
    init = _common.synthetic_params(cfg, "cuda")
    make_optimizer(init, learning_rate=3e-3, plateau="epoch", train_gene_tokenizer=False)

    def grads(params, c, plain: bool):
        trained = [(k, t) for k, t in named_leaves(params) if t.requires_grad]
        for _, t in trained:
            t.grad = None
        loss = seq2gene_loss_fn(params, *batch, c, stop_cre_grads=True, stop_gene_grads=True,
                                plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        out = {k: t.grad.detach().clone() for k, t in trained if t.grad is not None}
        for _, t in trained:
            t.grad = None
        return float(loss.detach()), out

    for label, params in (("seeded init", init), ("fitted", fitted)):
        reset_launches()
        loss_k, got = grads(params, cfg, False)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        loss_p, want = grads(params, cfg, True)
        loss_32, f32 = grads(params, cfg32, True)
        for k in ("fused_window_encoder", "fused_gene_modulator_fwd_save",
                  "fused_gene_modulator_bwd1", "fused_gene_modulator_bwd0", "gemm_dgrad",
                  "gemm_wgrad", "attention_bwd", "layernorm_bwd", "geglu_bwd", "colsum"):
            require(kernel_ran(launches, k), f"finetune grad parity ({label}): {k} not launched")
        require(abs(loss_k - loss_p) <= 2e-2 * abs(loss_p),
                f"finetune grad parity ({label}): loss {loss_k} vs plain {loss_p}")
        require(set(got) == set(want) and got, f"finetune grad parity ({label}): gradient sets")
        rels = {k: rel_l2(got[k], want[k]) for k in want}
        held = []
        for k, r in rels.items():
            require(torch.isfinite(got[k]).all(), f"finetune grad parity ({label}): {k} non-finite")
            if r < GRAD_TOL:
                continue
            r_k, r_p = rel_l2(got[k], f32[k]), rel_l2(want[k], f32[k])
            held.append(f"{k}: kernels {r_k:.4g}, plain bf16 {r_p:.4g} from f32")
            require(r_k <= max(GRAD_TOL, 1.25 * r_p),
                    f"finetune grad parity ({label}): {k} rel L2 {r:.4g} to the plain bf16, "
                    f"{r_k:.4g} to f32 (plain bf16 {r_p:.4g})")
        worst = max(rels, key=rels.get)
        err = max((got[k].float() - want[k].float()).abs().max().item() for k in want)
        print(f"check finetune grad parity, {label} (2 genes x 2 tissues, E=32, hd 8 in 64 "
              f"lanes, K=32): loss {loss_k:.6f} through the kernels, {loss_p:.6f} plain bf16, "
              f"{loss_32:.6f} plain f32; {len(rels)} gradients, worst leaf {worst} rel L2 "
              f"{rels[worst]:.4g} (|grad| {want[worst].norm().item():.3g}; tol {GRAD_TOL}), "
              f"max_abs_err {err:.4g}; held to f32 instead: {'; '.join(held) or 'none'}; "
              f"launches {json.dumps(launches)}")


# The port's notebooks (variantformer_tpu_torch/notebooks), in the
# generator's order; the kernels each must launch on the card.
NOTEBOOKS = ("vcf2exp", "variant2exp", "vcf2risk", "eqtl_analysis", "snp_indel_predictions",
             "variant2risk", "vcf2embed", "finetune_seq2gene")
NOTEBOOK_KERNELS = {
    "vcf2exp": ("fused_window_encoder", "fused_gene_modulator", "cre_stack"),
    "variant2exp": ("fused_window_encoder", "fused_gene_modulator", "cre_stack"),
    "eqtl_analysis": ("fused_window_encoder", "fused_gene_modulator", "cre_stack"),
    "finetune_seq2gene": ("fused_window_encoder", "fused_gene_modulator", "cre_stack",
                          "fused_gene_modulator_fwd_save", "fused_gene_modulator_bwd1",
                          "fused_gene_modulator_bwd0"),
}
# vcf2exp's query in real mode: the smoke genome's genes, its donor VCF and
# three tissues of the released vocabulary.
REAL_TISSUES = "brain - cortex,liver,whole blood"


def notebooks_path(torch, root: Path, real_artifacts: Path, cfg=None,
                   device: str = "cuda") -> dict:
    """The port's notebooks, run in this process by
    ``scripts/run_notebook.py`` (every code cell in order in one namespace,
    ``DEVICE`` and ``ROOT`` set after the ``parameters`` cell), each with
    its launches read (``cfg`` and ``device`` only for a rehearsal on the CPU
    at a small width):

    (a) synthetic mode, every notebook this host's installs allow: a cell
        that imports a module missing here (the plots without matplotlib)
        is named and left to the CPU tests, and so are the two AD-risk
        notebooks without scikit-learn (their demo predictor); where IPython
        is missing, a minimal ``IPython.display`` stands in. vcf2exp,
        variant2exp and eqtl_analysis launch #1 and #2, finetune_seq2gene
        #1, #2 and #4-#6; the vcf2exp notebook's predictions and embeddings
        lie within 5e-2 / 6e-2 of the plain forward's (``impl="xla"``, the
        same weights).
    (b) real mode at full v4_pcg width: the vcf2exp notebook on the
        artifacts directory that the launchers path wrote (the downloader's
        names, a 4.50 GiB reference-layout ``.pth``), its parameters cell
        naming the smoke genome's 4 genes, its donor VCF and three tissues;
        #1 and #2 launch at E=1536 with 32 heads of 48, and the notebook's
        frame is the bits of ``VCFProcessor.predict`` on the same processor
        and query. ``load_model`` and the query's seconds are printed.
    Returns the summed launches of (a) and (b)."""
    import numpy as np

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.examples import _common
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.scripts import run_notebook

    cfg = cfg or ModelConfig()
    no_remote_fetch(root)  # no artifacts under the root: synthetic mode
    require(not _common.artifacts_present(), "the notebooks path found artifacts")
    names = NOTEBOOKS
    if importlib.util.find_spec("sklearn") is None:
        names = tuple(n for n in NOTEBOOKS if n not in SKLEARN_FLOWS)
        print(f"notebooks: scikit-learn is not installed: {', '.join(SKLEARN_FLOWS)} (a demo "
              f"predictor fitted with it, as their flows) run on the CPU tests only "
              f"(tests/test_torch_notebooks.py)")

    def skip(index: int, src: str):
        missing = run_notebook.missing_modules(src)
        return f"needs {', '.join(missing)}" if missing else None

    def run(name: str, params: dict):
        reset_launches()
        t0 = time.perf_counter()
        done = run_notebook.run(run_notebook.load(name), {"DEVICE": device, **params}, skip=skip)
        if device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        add_launches(total, launches)
        if device != "cpu":
            require_cre_chain(f"notebook {name}", launches, "any")
        for index, reason in done.skipped:
            print(f"notebook {name} cell {index}: {reason}, not installed here: left to the "
                  f"CPU tests (tests/test_torch_notebooks.py)")
        if done.stub_ipython and not stubbed:
            stubbed.append(name)
            print("notebooks: IPython is not installed: a minimal IPython.display (display, "
                  "HTML) stood in; displays recorded, not shown")
        for kernel in NOTEBOOK_KERNELS.get(name, ()) if device != "cpu" else ():
            require(kernel_ran(launches, kernel), f"notebook {name} did not launch {kernel}")
        return done, seconds, launches

    total: dict = {}
    stubbed: list = []
    ran = {}
    for name in names:
        done, seconds, launches = run(name, {"ROOT": str(root / "notebooks" / name)})
        ran[name] = done.namespace
        print(f"notebook {name} (synthetic): {seconds:.2f} s on {device}, "
              f"{sum(o['output_type'] != 'stream' for o in done.outputs)} displays; "
              f"launches {json.dumps(launches)}")
    ns = ran["vcf2exp"]
    sources, scfg, extras = _common.synthetic_env(root / "notebooks" / "vcf2exp" / "env")
    plain = VCFProcessor(sources=sources, config=scfg, device=device, impl="xla")
    plain.set_params(_common.synthetic_params(scfg, device))
    ref = plain.predict(extras["vcf"], ns["query"])
    plain.cleanup()
    for col, tol in (("predicted_expression", PRED_TOL), ("embeddings", EMB_TOL)):
        compare(torch, f"notebook vcf2exp {col} (synthetic, E=32, hd 8 in 64 lanes) vs the "
                f"plain forward", torch.from_numpy(np.stack(ns["out"][col]).astype(np.float32)),
                torch.from_numpy(np.stack(ref[col]).astype(np.float32)), tol)
    res = ran["finetune_seq2gene"]["res"]
    require(res.history[-1]["val_loss"] < res.history[0]["val_loss"],
            f"notebook finetune_seq2gene: {res.history}")
    require(len(ran["eqtl_analysis"]["result"]) >= 1, "notebook eqtl_analysis: no Spearman row")
    for name in set(SKLEARN_FLOWS) & set(names):
        require(len(ran[name]["out" if name == "variant2risk" else "risk"]) >= 1,
                f"notebook {name}: rows")
    del ran, ns

    # (b) real mode at full width on the launchers path's artifacts.
    saved_dir = os.environ["VFX_ARTIFACTS_DIR"]
    os.environ["VFX_ARTIFACTS_DIR"] = str(real_artifacts)
    require(_common.artifacts_present(), f"no artifacts under {real_artifacts}")
    loaded = {}
    load_model = VCFProcessor.load_model

    def spy(self, *a, **kw):
        t = time.perf_counter()
        out = load_model(self, *a, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        loaded["s"] = time.perf_counter() - t
        return out

    VCFProcessor.load_model = spy
    genes = [g for g, *_ in GENES]
    try:
        done, seconds, launches = run("vcf2exp", {
            "ROOT": str(root / "notebooks" / "vcf2exp_real"), "GENES": genes,
            "TISSUES": REAL_TISSUES, "VCF_PATH": str(root / "donor.vcf.gz")})
        ns = done.namespace
        proc = ns["proc"]
        again = proc.predict(ns["vcf_path"], ns["query"])  # CRE maps: the artifacts' manifest
    finally:
        VCFProcessor.load_model = load_model
        os.environ["VFX_ARTIFACTS_DIR"] = saved_dir
    s2g, enc = proc.config.seq2gene, proc.config.window_encoder
    require(not ns["SYNTHETIC"] and proc.device.type == torch.device(device).type,
            "the real-mode notebook did not run on the artifacts and the card")
    require((s2g.emb_dim, s2g.num_heads, enc.embedding_dim, enc.num_heads) == (
        cfg.seq2gene.emb_dim, cfg.seq2gene.num_heads, cfg.window_encoder.embedding_dim,
        cfg.window_encoder.num_heads), f"real mode loaded {s2g} / {enc}")
    out = ns["out"]
    require(list(out["gene_id"]) == genes and len(out["tissue_names"][0]) == 3,
            "the real-mode notebook's frame")
    for col in ("predicted_expression", "embeddings"):
        a, b = np.stack(out[col].map(np.stack)), np.stack(again[col].map(np.stack))
        require(a.shape == b.shape and np.array_equal(a, b),
                f"notebook vcf2exp (real mode) {col}: not the bits of predict")
    print(f"check notebook vcf2exp (real mode, full v4_pcg: E={s2g.emb_dim}, {s2g.num_heads} "
          f"heads of {s2g.emb_dim // s2g.num_heads}, {s2g.num_layers} gene layers, window "
          f"encoders E={enc.embedding_dim} x {enc.num_layers}): {len(genes)} genes x 3 tissues "
          f"({REAL_TISSUES}); the frame is the bits of VCFProcessor.predict on the same "
          f"processor and query; load_model {loaded['s']:.3f} s, the query {ns['wall']:.3f} s "
          f"(the notebook's clock), the whole notebook {seconds:.2f} s; launches "
          f"{json.dumps(launches)}; {card()}")
    proc.cleanup()
    del done, ns, proc, out, again
    if device != "cpu":
        torch.cuda.empty_cache()
    return total


EXPORT_GENE_LAYERS = 2    # the serving export's depth (full width): 2 gene and 1 CRE
EXPORT_WINDOW_LAYERS = 1  # layers, one window-encoder layer a tokenizer


def export_config():
    """v4_pcg at full width, its depth cut for the export's traces."""
    from variantformer_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    return dataclasses.replace(
        cfg, window_encoder=dataclasses.replace(cfg.window_encoder,
                                                num_layers=EXPORT_WINDOW_LAYERS),
        seq2gene=dataclasses.replace(cfg.seq2gene, num_layers=EXPORT_GENE_LAYERS))


def export_path(torch, root: Path, cre_maps: dict, batch, cfg=None,
                device: str = "cuda") -> dict:
    """Serving export at full v4_pcg width (``main`` cuts the depth:
    ``export_config``) on the vcf2exp phase's batch (4 genes x 54 tissues),
    seeded weights packed by
    ``VCFProcessor.set_params``: ``export_forward`` for the kernel route
    (``fused2``) and the plain one (``xla``), each artifact far smaller than
    the weights; ``load_exported`` and one call of each on the card, with
    the launch counts set to 0 just before and read just after: the kernel
    route's call launches ``fused_window_encoder`` twice and
    ``fused_gene_modulator`` once (the ``vfx_torch`` ops) and gives eager
    ``seq2gene_forward``'s bits on every output, the plain route's call
    launches no hand-written kernel and gives eager
    ``seq2gene_forward_plain``'s bits. Each call is timed by CUDA events
    beside the eager forward. Returns the kernel route's launches."""
    from variantformer_tpu_torch.api.serving import export_forward, load_exported
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.models.seq2gene import seq2gene_forward, seq2gene_forward_plain
    from variantformer_tpu_torch.ops import kernels

    cfg = cfg or ModelConfig()
    proc = VCFProcessor(sources=genome_sources(root, cre_maps), config=cfg, device=device)
    raw = init_seq2gene(cfg, SEED, device=device)
    weights = sum(leaf.numel() * leaf.element_size() for _, leaf in named_leaves(raw))
    proc.set_params(raw)
    del raw
    params, dev_batch = proc._params, proc._to_device(batch)
    eager = {"fused2": seq2gene_forward, "xla": seq2gene_forward_plain}
    path_launches = {}
    for impl in ("fused2", "xla"):
        t0 = time.perf_counter()
        path = export_forward(cfg, params, dev_batch, root / f"serving_{impl}.pt2", impl=impl,
                              device=device)
        export_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        require(size < weights / 100, f"{impl} artifact {size} bytes: not far below the "
                                      f"{weights} bytes of weights")
        t0 = time.perf_counter()
        fn = load_exported(path, device=device)
        load_s = time.perf_counter() - t0
        with torch.inference_mode():
            want = eager[impl](params, dev_batch, cfg)
        torch.cuda.synchronize()
        reset_launches()
        got = fn(params, dev_batch)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if impl == "fused2" and device == "cuda":  # the wrappers count card launches only
            require(launches["fused_window_encoder"] == 2 and launches["fused_gene_modulator"] == 1
                    and launches["cre_stack"] == 1,
                    f"the kernel-route artifact did not launch #1 twice and #2 and the CRE "
                    f"stack's chain once: {launches}")
            path_launches = launches
        else:
            require(not any(launches.values()),
                    f"the plain-route artifact launched hand-written kernels: {launches}")
        diffs = {}
        for name in want._fields:
            w, g = getattr(want, name), getattr(got, name)
            require((w is None) == (g is None), f"{impl} artifact output {name}: None mismatch")
            if w is not None and not torch.equal(w, g):
                diffs[name] = (w.float() - g.float()).abs().max().item()
        require(not diffs, f"{impl} artifact differs from the eager forward: max |diff| {diffs}")
        with torch.inference_mode():
            eager_ms = time_ms(torch, lambda: eager[impl](params, dev_batch, cfg), 2)
        loaded_ms = time_ms(torch, lambda: fn(params, dev_batch), 2)
        print(f"serving export {impl}: export {export_s:.3f} s, artifact {size} bytes (weights "
              f"{weights} bytes), load {load_s:.3f} s; loaded call {loaded_ms:.3f} ms, eager "
              f"forward {eager_ms:.3f} ms (D={dev_batch.cre_tokens.shape[0]} "
              f"T={dev_batch.tissue_ids.shape[0]}, CUDA events); the same bits on "
              f"every output; launches {json.dumps({k: v for k, v in launches.items() if v})}; "
              f"{card()}")
        del fn, got, want
    proc.cleanup()
    return path_launches


def bench_path(torch) -> None:
    """``python -m variantformer_tpu_torch.bench`` in a subprocess (the
    port's bench entry, in a process of its own as a user runs it); prints
    its JSON line, then the forward's analytic FLOPs (``seq2gene_flops`` at
    D=4, C=384, G=200, T=54) and that count over the bench's median time as
    a share of the bf16 peak."""
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.utils.flops import seq2gene_flops

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "variantformer_tpu_torch.bench"], check=True,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "VFX_BENCH_D": "4"})
    wall_s = time.perf_counter() - t0
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    require(set(result) == {"metric", "value", "unit", "vs_baseline"}
            and result["value"] > 0, f"bench line {line!r}")
    flops = seq2gene_flops(ModelConfig(), 4, 384, 200, 54)["total"]
    median_s = 4 / result["value"]
    print(f"bench flops: seq2gene_flops(cfg, 4, 384, 200, 54)['total'] = {flops:.6g}; over the "
          f"median {median_s * 1e3:.3f} ms: {flops / median_s / 1e12:.3f} TFLOP/s, "
          f"{flops / median_s / PEAK_BF16_FLOPS:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; "
          f"bench process {wall_s:.1f} s; {card()}")
    print(line)


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def write_training_shards(root: Path, cre_maps: dict) -> Path:
    """``TrainingShardWriter`` shards of the 4 genes for the donor VCF's
    sample, 54 seeded log1p-TPM labels each, under ``root/shards``."""
    import numpy as np
    import pandas as pd

    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder
    from variantformer_tpu_torch.data.train_pipeline import TrainingShardWriter
    from variantformer_tpu_torch.utils.bpe import BPETokenizer
    from variantformer_tpu_torch.utils.fasta import FastaReader
    from variantformer_tpu_torch.utils.vcf import VCFReader

    sources = genome_sources(root, cre_maps)
    builder = GeneSampleBuilder(
        cfg=ModelConfig().dataset, fasta=FastaReader(sources.fasta_path),
        tokenizer=BPETokenizer.from_file(sources.bpe_vocab_path),
        gencode=pd.read_csv(sources.gencode_path), cre_map_provider=cre_maps.get,
        vcf=VCFReader(str(root / "donor.vcf.gz")),
    )
    rng = np.random.default_rng(SEED)
    genes = [g for g, *_ in GENES]
    expression = pd.DataFrame([
        {"gene_id": g, "donor": "DONOR", "tissue": f"tissue{t}", "TPM": tpm, "FPKM": tpm}
        for g in genes for t, tpm in zip(range(54), np.expm1(rng.uniform(0.0, 5.0, 54)))
    ])
    vocab = {f"tissue{i}": i for i in range(63)}
    shard_dir = root / "shards"
    t0 = time.perf_counter()
    written = TrainingShardWriter({"DONOR": builder}, expression, vocab, shard_dir).build_all(
        genes, ["DONOR"], max_workers=4)
    require(len(written) == 4, f"{len(written)} shards written")
    print(f"training shards: {len(written)} (gene, donor) samples x 54 log1p-TPM labels in "
          f"{time.perf_counter() - t0:.2f} s")
    return shard_dir


def training_path(torch, root: Path, cre_maps: dict) -> dict:
    """seq2gene training at full v4_pcg width and depth through the normal
    entry points: shard writer -> make_optimizer -> make_seq2gene_train_step
    -> fit (1 epoch of 2 steps, batches of 2 genes x 54 tissues), one
    save_train_state and load_train_state of the whole state; then one
    step's time and profile, and one step's
    gradients against the plain versions at D=1. Returns the fit run's
    launch counts."""
    import numpy as np

    from variantformer_tpu_torch.config import ModelConfig, PrecisionPolicy
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.train.loop import (
        fit,
        load_train_state,
        make_seq2gene_eval_loss,
        save_train_state,
        seq2gene_shard_batches,
    )
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import (
        TrainState,
        make_seq2gene_train_step,
        seq2gene_loss_fn,
    )

    cfg = ModelConfig()
    shard_dir = write_training_shards(root, cre_maps)
    tissues = list(range(54))

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
    step_reproducibility(torch, params, opt, next(iter(train_b(0))), cfg, seq2gene_loss_fn)
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
    reset_launches()
    t0 = time.perf_counter()
    # No checkpoint directory: fit's two writes of the whole state (last/
    # and best/, ~14 GB each) give way to one save and one load below;
    # fit's checkpointing itself is held on the CPU (tests/test_torch_train.py).
    res = fit(TrainState(params, opt, 0), logged_step, train_b, eval_loss=eval_loss, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"fit: 1 epoch, {len(losses)} steps in {fit_s:.2f} s (eval included); losses "
          f"{losses}; history {json.dumps(res.history)}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"fit launches {json.dumps(launches)}")
    require_cre_chain("fit (train steps and the eval loss)", launches, "some")
    require(len(losses) == 2 and all(np.isfinite(losses)), f"losses {losses}")
    require(all(np.isfinite(h["val_loss"]) for h in res.history), "non-finite eval loss")
    for k in watched:
        require(not torch.equal(leaf[k], before[k]), f"{k} did not move")
    for k, t in frozen:
        require(torch.equal(dict(named_leaves(params["cre_tokenizer"]))[k], t),
                f"frozen cre_tokenizer/{k} changed")
    print(f"moved: {', '.join(watched)}; cre_tokenizer bit-identical ({len(frozen)} leaves)")
    for name in set(kernels.LAUNCHES) - set(PROBE_KERNELS):
        require(kernel_ran(launches, name), f"kernel {name} was not launched on the training path")
    del before, frozen
    t0 = time.perf_counter()
    save_train_state(ckpt / "last", res.state)
    size = sum(f.stat().st_size for f in (ckpt / "last").rglob("*") if f.is_file())
    print(f"save_train_state(last/): step {res.state.step}, {size / 2**30:.2f} GiB in "
          f"{time.perf_counter() - t0:.2f} s")
    probe = leaf["gene_layers/ffn_in/w"].detach().clone()
    with torch.no_grad():
        leaf["gene_layers/ffn_in/w"].add_(1.0)
    t0 = time.perf_counter()
    restored = load_train_state(ckpt / "last", res.state)
    require(restored.step == res.state.step == 2, f"restored step {restored.step}")
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


def step_reproducibility(torch, params, opt, batch, cfg, loss_fn) -> None:
    """The gradients of two identical training steps (the fit's loss on a
    batch of 2 genes x 54 tissues, CRE tokenizer frozen, from the same
    state) are the same bits on every trained leaf. A third pass runs under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` and lists
    the operations PyTorch flags as nondeterministic on CUDA."""
    import warnings

    trained = [(k, t) for k, t in named_leaves(params) if t.requires_grad]

    def grads():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *batch, cfg, stop_cre_grads=True)
        loss.backward()
        out = {k: t.grad.detach().clone() for k, t in trained if t.grad is not None}
        opt.zero_grad(set_to_none=True)
        return float(loss.detach()), out

    loss_a, first = grads()
    loss_b, second = grads()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.utils.deterministic.fill_uninitialized_memory = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
    flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "determinis" in str(w.message)})
    print(f"deterministic-algorithms pass: {len(flagged)} operation(s) flagged"
          + "".join(f"\n  flagged: {m}" for m in flagged))
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    for k in differ[:8]:
        print(f"step reproducibility: {k} differs by up to "
              f"{(first[k] - second[k]).abs().max().item():.4g}")
    require(set(first) == set(second) and not differ and loss_a == loss_b,
            f"two identical steps: {len(differ)} of {len(first)} gradient leaves differ "
            f"(losses {loss_a!r}, {loss_b!r})")
    print(f"check step reproducibility (2 genes x 54 tissues): loss {loss_a!r} twice, all "
          f"{len(first)} trained leaves' gradients the same bits "
          f"({sum(g.numel() for g in first.values())} values)")
    del first, second


MESH_RANKS = 2          # the two-process phase: two ranks on one card, over gloo
MESH_GENE_LAYERS = 3    # its depth (full width): 3 gene and 2 CRE layers,
MESH_WINDOW_LAYERS = 2  # two window-encoder layers a tokenizer


def mesh_path(torch, root: Path, cre_maps: dict, batch) -> dict:
    """Multi-device inference and training (``variantformer_tpu_torch/parallel``).

    1. A world of one on NCCL (``initialize_distributed``, a ``file://``
       store): ``VCFProcessor.use_mesh`` with the donor, then the tissue
       partition on the vcf2exp batch (4 genes x 54 tissues, full v4_pcg
       width at the cut depth ``MESH_*``; the launchers path runs worlds of
       one on NCCL at full depth),
       each the unmeshed processor's bits; ``donor_dp_value_and_grad`` twice
       at D=2 (the same bits) and one ``donor_dp_train_step``, the gradients
       within rel L2 5e-2 of the single-device step's and the loss within
       2e-2. The launch counts are set to 0 just before the meshed run and
       read just after: every kernel of #1-#6 launched.
    2. Two processes on the card over gloo (NCCL refuses two ranks on one
       device) at full width and cut depth (``MESH_*``): gloo's collectives
       on CUDA tensors probed; the donor and tissue partitions against the
       world-of-one forward within 3e-2 of max |ref| (and whether the bits
       are equal); the layered route with heads split over a model axis of 2
       (``impl="xla"``) against the unmeshed layered forward within 3e-2;
       one donor-partition step's gradients against the single-device
       step's (rel L2 5e-2), twice the same bits, and two ZeRO-1 steps with
       a ``state_dict`` between them against two replicated ones. Each rank's forward and step times are printed:
       two ranks share one card, so they show no speed-up.
    Returns the meshed run's launch counts."""
    import dataclasses as dc

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.config import ModelConfig
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.ops import kernels
    from variantformer_tpu_torch.parallel import launch
    from variantformer_tpu_torch.parallel import mesh as pmesh
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState, seq2gene_loss_fn

    t_world1 = time.perf_counter()
    info = launch.initialize_distributed(num_processes=1, process_id=0, device="cuda:0",
                                         init_method=f"file://{root / 'mesh_store'}")
    require(dist.get_backend() == "nccl" and info["process_count"] == 1, f"world {info}")
    mesh = pmesh.make_mesh()
    cfg = ModelConfig()  # full width, the cut depth of the two-process phase
    cfg = dc.replace(cfg, window_encoder=dc.replace(cfg.window_encoder,
                                                    num_layers=MESH_WINDOW_LAYERS),
                     seq2gene=dc.replace(cfg.seq2gene, num_layers=MESH_GENE_LAYERS))
    proc = VCFProcessor(sources=genome_sources(root, cre_maps), config=cfg, device="cuda")
    proc.set_params(init_seq2gene(cfg, SEED, device="cuda"))
    want = proc._forward(batch)
    b2, targets, mask = mesh_train_batch(torch, batch)
    params = init_seq2gene(cfg, SEED, device="cuda")
    opt = make_optimizer(params, learning_rate=1e-4, train_gene_tokenizer=True)
    trained = [(k, t) for k, t in named_leaves(params) if t.requires_grad]
    dev = lambda x: x.cuda()  # noqa: E731
    dev_b2 = type(b2)(*(None if v is None else dev(v) for v in b2))
    single = seq2gene_loss_fn(params, dev_b2, dev(targets), dev(mask), cfg, stop_cre_grads=True)
    single.backward()
    single = float(single.detach())
    ref = {k: t.grad.cpu() for k, t in trained if t.grad is not None}
    opt.zero_grad(set_to_none=True)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    proc.use_mesh(mesh, partition="donor")
    require(proc.impl == "fused2" and proc._mesh_fused, "the donor mesh left the kernel route")
    donor = proc._forward(batch)
    proc.use_mesh(mesh, partition="tissue")
    require(proc.impl == "fused2" and proc._mesh_fused, "the tissue mesh left the kernel route")
    tissue = proc._forward(batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    state = pmesh.replicate_train_state(TrainState(params, opt, 0), mesh)
    args = pmesh.donor_dp_shard_fn(mesh)((b2, targets, mask))
    vg = pmesh.donor_dp_value_and_grad(cfg, mesh, freeze_tokenizers=True)
    grads = []
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        loss = float(vg(state.params, *args))
        grads.append({k: t.grad.clone() for k, t in trained})
    step = pmesh.donor_dp_train_step(cfg, mesh, opt, freeze_tokenizers=True)
    t1 = time.perf_counter()
    state, step_loss = step(state, *args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    print(f"mesh launches (world of one, NCCL: donor and tissue forwards, two gradients and "
          f"one step at D=2) {json.dumps(launches)}")
    require_cre_chain("mesh path", launches, "some")
    require(CRE_ROUTES[:2] == [True, True], f"the donor and tissue forwards' CRE routes "
            f"{CRE_ROUTES[:2]}: not the kernel chain")
    for name in set(kernels.LAUNCHES) - set(PROBE_KERNELS):
        require(kernel_ran(launches, name), f"kernel {name} was not launched on the mesh path")
    for label, out in (("donor", donor), ("tissue", tissue)):
        same = all(torch.equal(getattr(out, f), getattr(want, f)) for f in MESH_FIELDS)
        require(same, f"use_mesh({label!r}) at world size 1 is not the unmeshed bits")
        print(f"check mesh {label} partition (world of one, NCCL, 4 genes x 54 tissues, full "
              f"width, {MESH_GENE_LAYERS} gene / {MESH_GENE_LAYERS - 1} CRE / "
              f"{MESH_WINDOW_LAYERS} window layers): the unmeshed processor's bits on "
              f"{', '.join(MESH_FIELDS)}")
    differ = [k for k in grads[0] if not torch.equal(grads[0][k], grads[1][k])]
    require(not differ, f"donor_dp_value_and_grad twice: {len(differ)} leaves differ")
    require(abs(loss - single) <= 2e-2 * abs(single), "mesh step: loss")
    compare_grads(torch, "mesh donor-partition gradients vs the single-device step (world of "
                  "one, D=2 x 54 tissues)", {k: g.cpu() for k, g in grads[0].items()}, ref)
    for k, g in grads[0].items():
        if k not in ref:
            require(not g.any(), f"{k}: a gradient where the single-device step has none")
    require(np.isfinite(float(step_loss)), "mesh step: non-finite loss")
    print(f"check mesh step reproducibility: {len(grads[0])} trained leaves the same bits twice;"
          f" loss {loss!r} (single device {single!r}); donor + tissue forwards "
          f"{fwd_s:.3f} s, one donor-partition step {step_s * 1e3:.3f} ms (host clock); "
          f"{card()}")
    proc.cleanup()
    del state, params, opt, grads, ref, vg, step, trained, proc, donor, tissue, want
    torch.cuda.empty_cache()
    print(f"mesh world of one: {time.perf_counter() - t_world1:.1f} s")

    # Two processes on the card over gloo, at cut depth.
    t_two = time.perf_counter()
    small = dc.replace(cfg, window_encoder=dc.replace(cfg.window_encoder,
                                                      num_layers=MESH_WINDOW_LAYERS),
                       seq2gene=dc.replace(cfg.seq2gene, num_layers=MESH_GENE_LAYERS))
    refs = {}
    for impl in ("fused2", "xla"):
        p = VCFProcessor(sources=genome_sources(root, {}), config=small, device="cuda",
                         impl=impl)
        p.set_params(init_seq2gene(small, SEED, device="cuda"))
        out = p._forward(batch)
        refs[impl] = {f: getattr(out, f).cpu() for f in MESH_FIELDS}
        p.cleanup()
    sparams = init_seq2gene(small, SEED, device="cuda")
    make_optimizer(sparams, learning_rate=1e-4, train_gene_tokenizer=True)
    sb2 = type(b2)(*(None if v is None else dev(v) for v in b2))
    sloss = seq2gene_loss_fn(sparams, sb2, dev(targets), dev(mask), small, stop_cre_grads=True)
    sloss.backward()
    sloss = float(sloss.detach())
    sref = {k: t.grad.cpu() for k, t in named_leaves(sparams) if t.grad is not None}
    del sparams, sb2
    torch.cuda.empty_cache()
    job = root / "mesh_job.pt"
    torch.save({"cfg": small, "batch": batch, "b2": b2, "targets": targets, "mask": mask,
                "root": str(root)}, job)
    ctx = mp.start_processes(mesh_rank, args=(str(root), str(job)), nprocs=MESH_RANKS,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc_ in ctx.processes:
                proc_.kill()
            raise AssertionError("the two-process mesh phase ran past 600 s")
    ranks = [torch.load(root / f"mesh_rank{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    for r, res in enumerate(ranks):
        refused = {k: v for k, v in res["collectives"].items() if v != "ok"}
        require(not refused, f"gloo refused collectives on CUDA tensors: {refused}")
        for key, impl, tol in (("donor", "fused2", STACK_TOL), ("tissue", "fused2", STACK_TOL),
                               ("tp", "xla", STACK_TOL)):
            for f in MESH_FIELDS:
                compare(torch, f"mesh rank {r} {key} {f} vs the world of one",
                        res[key][f], refs[impl][f], tol)
            same = all(torch.equal(res[key][f], refs[impl][f]) for f in MESH_FIELDS)
            print(f"mesh rank {r} {key}: {'the same bits as' if same else 'differs in bits from'}"
                  f" the world of one")
        require(res["grads_repeat"], f"rank {r}: two donor-partition gradients differ in bits")
        require(abs(res["loss"] - sloss) <= 2e-2 * abs(sloss),
                f"rank {r}: loss {res['loss']} vs {sloss}")
        if res["grads"]:  # rank 0's
            compare_grads(torch, f"mesh rank {r} donor-partition gradients vs one process "
                          f"({MESH_RANKS} ranks, D=2)", {k: res["grads"][k] for k in sref}, sref)
        require(res["zero1_max_diff"] <= 1e-6,
                f"rank {r}: ZeRO-1 steps vs replicated steps {res['zero1_max_diff']}")
        print(f"check mesh rank {r}: two ZeRO-1 steps (a state_dict between them) vs the "
              f"replicated steps, max |diff| "
              f"{res['zero1_max_diff']:.3g} over the parameters ({res['zero1_sliced']} moments "
              f"sliced); forward ms donor {res['ms']['donor']:.3f}, tissue "
              f"{res['ms']['tissue']:.3f}, layered split over 2 (first call) "
              f"{res['ms']['tp']:.3f}; step ms "
              f"{res['ms']['step']:.3f} (host clock; two ranks on one card: no speed-up); "
              f"{card()}")
    print(f"mesh two processes (gloo on one card, {MESH_GENE_LAYERS} gene / "
          f"{MESH_GENE_LAYERS - 1} CRE / {MESH_WINDOW_LAYERS} window layers): "
          f"{time.perf_counter() - t_two:.1f} s; collectives on CUDA tensors over gloo: "
          f"{json.dumps(ranks[0]['collectives'])}")
    launch.shutdown_distributed()
    return launches


MESH_FIELDS = ("pred_expression", "pooled_embedding")


def mesh_train_batch(torch, batch):
    """The first two genes of the vcf2exp batch (tensor leaves), seeded
    targets in [0, 3) and a full mask: the mesh path's training batch."""
    import numpy as np

    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    rng = np.random.default_rng(SEED)
    b2 = Seq2GeneBatch(**{
        k: None if v is None else torch.from_numpy(np.array(v if k == "tissue_ids" else v[:2]))
        for k, v in batch._asdict().items()})
    targets = torch.from_numpy(rng.uniform(0, 3, (2, 54)).astype(np.float32))
    return b2, targets, torch.ones((2, 54), dtype=torch.bool)


def mesh_rank(rank: int, root: str, job_path: str) -> None:
    """One rank of the mesh path's two-process phase (spawned)."""
    import torch
    import torch.distributed as dist

    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.models.init import init_seq2gene
    from variantformer_tpu_torch.parallel import comm, launch
    from variantformer_tpu_torch.parallel import mesh as pmesh
    from variantformer_tpu_torch.train.optimizer import make_optimizer
    from variantformer_tpu_torch.train.steps import TrainState

    job = torch.load(job_path, weights_only=False)
    cfg, batch = job["cfg"], job["batch"]
    launch.initialize_distributed(num_processes=MESH_RANKS, process_id=rank, device="cuda:0",
                                  backend="gloo", init_method=f"file://{root}/mesh_store_2",
                                  timeout_s=300)
    res: dict = {"collectives": {}, "ms": {}}
    probe = torch.arange(6, dtype=torch.float32, device="cuda:0")
    calls = {"all_reduce": lambda: comm.all_reduce(probe.clone(), None),
             "all_gather": lambda: comm.all_gather_cat(probe, None),
             "broadcast": lambda: comm.broadcast(probe.clone(), 0),
             "barrier": lambda: dist.barrier()}
    require(set(calls) == set(comm.COLLECTIVES), "the probe misses a collective")
    for name, call in calls.items():  # a refusal fails the smoke in the parent
        try:
            call()
            torch.cuda.synchronize()
            res["collectives"][name] = "ok"
        except RuntimeError as exc:
            res["collectives"][name] = f"refused: {exc}"[:200]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    sources = genome_sources(Path(root), {})
    for key, impl, partition, num_model in (("donor", "fused2", "donor", 1),
                                            ("tissue", "fused2", "tissue", 1),
                                            ("tp", "xla", "donor", 2)):
        proc = VCFProcessor(sources=sources, config=cfg, device="cuda:0", impl=impl)
        proc.set_params(init_seq2gene(cfg, SEED, device="cuda:0"))
        proc.use_mesh(pmesh.make_mesh(num_model=num_model), partition=partition)
        if key != "tp":  # the split layered route is timed on its first call
            proc._forward(batch)
        out, res["ms"][key] = timed(lambda: proc._forward(batch))
        res[key] = {f: getattr(out, f).cpu() for f in MESH_FIELDS}
        proc.cleanup()
        del proc
    mesh = pmesh.make_mesh(num_model=1)
    args = pmesh.donor_dp_shard_fn(mesh)((job["b2"], job["targets"], job["mask"]))
    after = {}
    for zero1 in (False, True):
        params = init_seq2gene(cfg, SEED, device="cuda:0")
        opt = make_optimizer(params, learning_rate=1e-4, train_gene_tokenizer=True)
        state = pmesh.replicate_train_state(TrainState(params, opt, 0), mesh)
        if not zero1:
            vg = pmesh.donor_dp_value_and_grad(cfg, mesh, freeze_tokenizers=True)
            grads = []
            for _ in range(2):
                opt.zero_grad(set_to_none=True)
                res["loss"] = float(vg(state.params, *args))
                grads.append({k: t.grad.clone() for k, t in named_leaves(params) if t.requires_grad})
            res["grads_repeat"] = all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
            res["grads"] = {k: g.cpu() for k, g in grads[0].items()} if rank == 0 else {}
            del grads
            opt.zero_grad(set_to_none=True)
        else:
            state = state._replace(opt=pmesh.Zero1Optimizer(opt, mesh))
            res["zero1_sliced"] = sum(a is not None for a in pmesh.opt_state_specs(state.opt, mesh))
        step = pmesh.donor_dp_train_step(cfg, mesh, state.opt, freeze_tokenizers=True,
                                         shard_optimizer=zero1)
        (state, _), ms = timed(lambda: step(state, *args))
        res["ms"]["step"] = ms
        state.opt.state_dict()  # a checkpoint between steps, as fit takes one each epoch
        state, _ = step(state, *args)
        after[zero1] = {k: t.detach().clone() for k, t in named_leaves(state.params)}
        del state, params, opt, step
    res["zero1_max_diff"] = max((after[True][k].float() - after[False][k].float()).abs().max().item()
                                for k in after[False])
    torch.save(res, Path(root) / f"mesh_rank{rank}.pt")
    launch.shutdown_distributed()


# Device function name (substring) -> the kernel group it belongs to.
KERNEL_FUNCTIONS = {
    "gemm_sm90_kernel<0": "gemm_bf16",
    "gemm_sm90_kernel<1": "gemm_wgrad",
    "gemm_sm90_kernel<2": "gemm_dgrad",
    "attention_sm90_kernel": "attention",
    "attn_bwd_": "attention_bwd",
    "layernorm_kernel": "layernorm",
    "layernorm_rows_kernel": "layernorm",
    "split_sum_kernel": "gemm_wgrad",
    "layernorm_bwd_kernel": "layernorm_bwd",
    "column_partial_kernel": "colsum",
    "column_final_kernel": "layernorm_bwd + colsum",
    "geglu_kernel": "geglu",
    "geglu_bwd_kernel": "geglu_bwd",
    "masked_mean_pool_kernel": "masked_mean_pool",
    "masked_mean_pool_bwd_kernel": "masked_mean_pool_bwd",
}


def profile(torch, fn, label: str) -> float:
    """Device time of one call of ``fn`` by kernel group (torch.profiler),
    returned in ms:
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
    return total / 1e3


FWD_K1 = "variantformer_tpu/ops/fused_encoder.py:319"
FWD_K2 = "variantformer_tpu/ops/fused_modulator.py:483"
BWD_K3 = "variantformer_tpu/ops/fused_encoder.py:804"
FWD_K4 = "variantformer_tpu/ops/fused_modulator.py:996"
BWD_K5 = "variantformer_tpu/ops/fused_modulator.py:1071"
BWD_K6 = "variantformer_tpu/ops/fused_modulator.py:1159"
CRE_XLA = "variantformer_tpu/models/seq2gene.py:336"  # lax.scan of the CRE stack, on XLA
REPLACES = {
    "fused_window_encoder": FWD_K1,
    "fused_gene_modulator": FWD_K2,
    "fused_window_encoder_bwd": BWD_K3,
    "fused_gene_modulator_fwd_save": FWD_K4,
    "fused_gene_modulator_bwd1": BWD_K5,
    "fused_gene_modulator_bwd0": BWD_K6,
    "cre_stack": CRE_XLA,
    "gemm_bf16": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, BWD_K6, CRE_XLA)),
    "attention": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, BWD_K6, CRE_XLA)),
    "layernorm": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, BWD_K6, CRE_XLA)),
    "geglu": " + ".join((FWD_K1, FWD_K2, BWD_K3, FWD_K4, BWD_K5, CRE_XLA)),
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
    # the attention kernel's uses, each a record of its own ("attention" is
    # the gene self-attention at mixed lengths)
    "attention encoder self": " + ".join((FWD_K1, BWD_K3)),
    "attention encoder self, full lengths": " + ".join((FWD_K1, BWD_K3)),
    "attention gene self, full lengths": " + ".join((FWD_K2, FWD_K4, BWD_K6)),
    "attention gene cross": " + ".join((FWD_K2, FWD_K4, BWD_K5)),
    "attention gene cross, full lengths": " + ".join((FWD_K2, FWD_K4, BWD_K5)),
    "attention gene cross C=1024, full lengths": " + ".join((FWD_K2, FWD_K4, BWD_K5)),
    "attention cre self": CRE_XLA,
    "attention cre cross": CRE_XLA,
    "attention cre self, full lengths": CRE_XLA,
    "attention cre cross, full lengths": CRE_XLA,
    # the CRE stack's chain at the other head-dim classes its route admits
    "cre_stack hd=32 (64 lanes) 7 layers": CRE_XLA,
    "cre_stack hd=96 (128 lanes) 7 layers": CRE_XLA,
    "cre_stack hd=128 7 layers": CRE_XLA,
    # the attention backward's and the LayerNorm backward's other uses
    "attention_bwd gene cross C=384": BWD_K5,
    "attention_bwd gene cross C=1": BWD_K5,
    "attention_bwd gene cross C=1024": BWD_K5,
    "attention_bwd encoder self": BWD_K3,
    "layernorm_bwd gene, no residuals": " + ".join((BWD_K5, BWD_K6)),
    "layernorm_bwd encoder E=512, no residuals": BWD_K3,
    # the VEP path's shapes of the two forward stacks
    "fused_window_encoder vep CRE pool N=448": FWD_K1,
    "fused_window_encoder vep gene pool N=264": FWD_K1,
    "fused_gene_modulator vep triple D=3 T=54": FWD_K2,
    "fused_gene_modulator vep pair D=2 T=54": FWD_K2,
    "fused_gene_modulator vep triple D=3 T=2": FWD_K2,
    # the sweeps path's shapes
    "fused_window_encoder scan CRE windows N=6144": FWD_K1,
    "fused_window_encoder scan gene windows N=3200": FWD_K1,
    "fused_gene_modulator scan D=16 T=54": FWD_K2,
    f"fused_gene_modulator live D=1 T={VOCAB_TISSUES}": FWD_K2,
    "fused_gene_modulator ad risk D=1 T=1": FWD_K2,
    # the variants path's shapes (its own weights: (c)'s CRE tokenizer, the
    # gene stacks of (a) and of (e), hd 32 padded to 64 lanes)
    "fused_window_encoder variants only_cross CRE windows": FWD_K1,
    "fused_gene_modulator variants use_context D=4 T=54": FWD_K2,
    "fused_gene_modulator variants hd=32 padded D=4 T=54": FWD_K2,
    # the backward-side kernels at the variant train steps' shapes (1 gene)
    "fused_window_encoder_bwd variants only_cross step": BWD_K3,
    "fused_gene_modulator_fwd_save variants use_context step": FWD_K4,
    "fused_gene_modulator_bwd1 variants use_context step": BWD_K5,
    "fused_gene_modulator_bwd0 variants use_context step": BWD_K6,
    "fused_gene_modulator_fwd_save variants hd=32 padded step": FWD_K4,
    "fused_gene_modulator_bwd1 variants hd=32 padded step": BWD_K5,
    "fused_gene_modulator_bwd0 variants hd=32 padded step": BWD_K6,
    # the wide heads path: window encoders at head dims 96 (packed to 128
    # lanes) and 128, and the attention's head-dim-128 build alone
    "fused_window_encoder hd=96 (128 lanes) N=1536": FWD_K1,
    "fused_window_encoder hd=128 N=1536": FWD_K1,
    "fused_window_encoder_bwd hd=96 (128 lanes) (8 layer calls)": BWD_K3,
    "fused_window_encoder_bwd hd=128 (8 layer calls)": BWD_K3,
    "attention encoder self hd=128": " + ".join((FWD_K1, BWD_K3)),
    "attention_bwd encoder self hd=128": BWD_K3,
}
# A record's kernel, where its name is not the kernel's: its launches are
# that kernel's.
RECORD_KERNEL = {name: name.split(" ")[0] for name in REPLACES if " " in name}
_CSRC = "variantformer_tpu_torch/csrc/"
SOURCE = {
    "fused_window_encoder": "variantformer_tpu_torch/ops/fused_encoder.py",
    "fused_gene_modulator": "variantformer_tpu_torch/ops/fused_modulator.py",
    "fused_window_encoder_bwd": "variantformer_tpu_torch/ops/fused_encoder.py",
    "fused_gene_modulator_fwd_save": "variantformer_tpu_torch/ops/fused_modulator.py",
    "fused_gene_modulator_bwd1": "variantformer_tpu_torch/ops/fused_modulator.py",
    "fused_gene_modulator_bwd0": "variantformer_tpu_torch/ops/fused_modulator.py",
    "cre_stack": "variantformer_tpu_torch/ops/cre_stack.py",
    "gemm_bf16": _CSRC + "gemm_sm90.cu",
    "gemm_dgrad": _CSRC + "gemm_sm90.cu",
    "gemm_wgrad": _CSRC + "gemm_sm90.cu",
    "attention": _CSRC + "attention_sm90.cu",
    "attention_bwd": _CSRC + "attention_bwd_sm90.cu",
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
SOURCE.update({name: SOURCE[kernel] for name, kernel in RECORD_KERNEL.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from variantformer_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    info = kernels.build()
    print(f"nvcc build: {info['seconds']:.2f} s into {info['dir']}")
    record_cre_routes()
    for src, log in info["ptxas"].items():
        for line in log.splitlines():
            low = line.lower()
            if ("registers" in line or "spill" in line or "error" in low or "warning" in low
                    or "(C75" in line):
                print(f"ptxas {src}: {line.strip()}")
    attn_log = info["ptxas"].get("attention_sm90.cu")
    if attn_log is None:
        print("ptxas attention_sm90.cu: built before this run; C7520 not checked")
    else:
        attention_ptxas(attn_log)
        require("C7520" not in attn_log,
                "ptxas serialises the attention forward's wgmma (C7520)")
    sass_counts(info["dir"])

    t0 = time.perf_counter()
    probe = probe_path(torch)
    checks = Checks(torch, ITERS)
    probe_checks(torch, checks)
    gemm_unit_checks(torch)
    attention_unit_checks(torch)
    attention_bwd_unit_checks(torch)
    attention_chunk_checks(torch)
    attention_wide_checks(torch)
    layernorm_unit_checks(torch)
    wgrad_reproducibility_checks(torch)
    print(f"probe, GEMM, attention (chunked and head dim 128 too), attention backward, "
          f"LayerNorm and weight-gradient reproducibility unit checks: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernel_checks(torch, checks)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    backward_checks(torch, checks)
    print(f"backward checks: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    heads = wide_heads_path(torch, checks)
    print(f"wide heads path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graphs_path(torch)
    print(f"graphs path: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    try:
        with tempfile.TemporaryDirectory(prefix="vf_smoke_") as tmp:
            root = Path(tmp)
            t0 = time.perf_counter()
            cre_maps = write_genome(root, SEED)
            print(f"genome written in {time.perf_counter() - t0:.2f} s")
            tabix_checks(root, cre_maps)
            t0 = time.perf_counter()
            serve, serve_preds, serve_batch = serving_path(torch, root, cre_maps)
            print(f"vcf2exp path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            # VEP at the variants path's depth cut: its pace is its host stages';
            # the kernel checks time #1 and #2 at full depth at its shapes.
            vep = vep_path(torch, root, cre_maps, cfg=variants_depth_config())
            print(f"vep path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            sweeps = sweep_path(torch, root, cre_maps, serve_preds)
            print(f"sweeps path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            export = export_path(torch, root, cre_maps, serve_batch, cfg=export_config())
            print(f"serving export path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            bench_path(torch)
            print(f"bench path: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            train = training_path(torch, root, cre_maps)
            print(f"training path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            variants = variants_path(torch, root, cre_maps, checks, cfg=variants_depth_config())
            print(f"variants path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            seq2reg = seq2reg_path(torch, root, cre_maps, wcfg=seq2reg_depth_config())
            print(f"seq2reg path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            mesh = mesh_path(torch, root, cre_maps, serve_batch)
            print(f"mesh path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            launchers = launchers_path(torch, root, cre_maps, serve_preds)
            print(f"launchers path: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            examples = examples_path(torch, root)
            print(f"examples path: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            notebooks = notebooks_path(torch, root, root / "artifacts_real")
            print(f"notebooks path: {time.perf_counter() - t0:.1f} s")
    finally:
        stop_children()
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s")

    rows = []
    runs = {"probe": probe, "vcf2exp": serve, "vep": vep, "sweeps": sweeps, "train": train,
            "variants": variants, "seq2reg": seq2reg, "heads": heads, "serving": export,
            "mesh": mesh}
    for name, rec in checks.records.items():
        kernel = RECORD_KERNEL.get(name, name)
        path = rec.get("path") or ("probe" if kernel in PROBE_KERNELS else
                                   "vcf2exp" if kernel in SERVING_KERNELS else "train")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": runs[path][kernel],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"], "path": path,
            **({"library_call": rec["library_call"]} if "library_call" in rec else {}),
            "train_launches": train[kernel],
            "variants_launches": variants.get(kernel, 0),
            "seq2reg_launches": seq2reg.get(kernel, 0),
            "serving_launches": export.get(kernel, 0),
            "mesh_launches": mesh.get(kernel, 0),
            "launchers_launches": launchers.get(kernel, 0),
            "examples_launches": examples.get(kernel, 0),
            "notebooks_launches": notebooks.get(kernel, 0),
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
