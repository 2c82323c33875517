"""The shared CUDA kernels, their build, and their wrappers.

The Pallas kernels of the JAX package (``variantformer_tpu/ops/
fused_encoder.py`` ``_kernel`` and ``_bwd_kernel``, ``variantformer_tpu/
ops/fused_modulator.py`` ``_kernel``, ``_bwd1_kernel`` and ``_bwd0_kernel``)
become chains of kernels written by hand for Hopper (``csrc/``):

  ``gemm_bf16``         [M, K] @ [K, N] bf16 on the tensor cores through
                        TMA and ``wgmma`` (``gemm_sm90.cu``), f32
                        accumulation, bias and residual epilogue, bf16 out;
  ``gemm_wgrad``        the same kernel reading X transposed: dW += X^T dY
                        over all rows, f32 out (split along the rows when
                        the output has few tiles, the splits' partials
                        summed in split order);
  ``gemm_dgrad``        the same kernel reading the weight in its stored
                        layout as K-major B: dX = dY W^T (+ residual), bf16
                        out;
  ``gemm_geglu``        the same kernel with GeGLU in its epilogue: the
                        FFN-in projection [M, K] @ [K, F] + bias and its
                        gate in one launch, [M, F/2] out, the [M, F]
                        pre-activation never written;
  ``attention``         masked (ALiBi) softmax attention on TMA and
                        ``wgmma`` (``attention_sm90.cu``): one block per K/V
                        row and head loads that head's K and V once and walks
                        the query tiles that read them, scores and softmax in
                        registers; optionally each row's log-sum-exp and the
                        renormalised f32 output for the backward; past 768
                        keys (320 at head dim 128) one launch per key
                        chunk, the softmax state carried between them; head
                        dims 48, 64 and 128;
  ``attention_bwd``     its backward on TMA and ``wgmma``
                        (``attention_bwd_sm90.cu``): a dK/dV pass with the
                        keys as M, split over the tissues where a group's
                        items would run in series, and a dQ pass with the
                        queries as M (in key chunks past 576 keys, 320 at
                        head dim 128), both from P rebuilt with the
                        log-sum-exp;
  ``layernorm``         f32 statistics, bf16 out; a row in registers, scale
                        and bias loaded once per lane;
  ``layernorm_bwd``     dx (+ residual cotangents) and f32 dscale/dbias in
                        one pass over the rows;
  ``geglu``             value * gelu_erf(gate);
  ``geglu_bwd``         d(value), d(gate) with the exact erf derivative;
  ``masked_mean_pool``  mean over the valid rows of each window;
  ``masked_mean_pool_bwd``  dpool / len on valid rows, 0 elsewhere;
  ``colsum``            f32 column sums (the bias gradients).

The capability probes of ``scripts/mosaic_capability_probe.py`` run on
``probes.cu`` (``probe_48slice``, ``probe_3dreshape``,
``probe_48slice_bf16_matmul``; driven by ``variantformer_tpu_torch.probes``).

Build: every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface, at first
use, under ``_build/<hash of the sources and flags>/`` (the flags carry the
sizes the launch plans share with the kernels); the libraries are loaded with
ctypes. Each C entry point returns ``cudaGetLastError()`` and the wrapper
raises when it is not 0.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``, same
signature) when the tensor it was given lies on the CPU, and on a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts the launches of
each wrapper, and the calls of each whole-stack op; ``ATTN_VARIANTS`` the
attention's launches by the softmax variant each took. ``KERNELS`` and
``PLAIN`` bundle the wrappers and the plain versions for the chains that
run on either.

The inference ops replay their chains as CUDA graphs (``ops/graphs.py``):
a wrapper's count is of host launches, which the first call of an op and
each capture make and a replay does not. ``GRAPHS`` counts each op's
captures, replays and evictions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from variantformer_tpu_torch.ops.attention import attend, masked_scores

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("gemm_sm90.cu", "attention_sm90.cu", "attention_bwd_sm90.cu", "rowwise.cu",
           "probes.cu")
# Sizes that both a launch plan and its kernel read: the sources are built
# with these values (-D), so the plans and the kernels cannot disagree.
ATTN_BWD_STAGES = 3        # (Q, dO, lse/delta) items in flight in a dK/dV block
ATTN_BWD_DQ_CONSUMERS = 2  # consumer warpgroups of a dQ block
ATTN_BWD_DQ_CONSUMERS_WIDE = 1  # the same at head dim 128 (twice the bytes a Q/dO buffer)
LN_WARPS = 8               # rows in flight in a LayerNorm block, one a warp
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DVF_ATTN_BWD_STAGES={ATTN_BWD_STAGES}",
    f"-DVF_ATTN_BWD_DQ_CONSUMERS={ATTN_BWD_DQ_CONSUMERS}",
    f"-DVF_ATTN_BWD_DQ_CONSUMERS_WIDE={ATTN_BWD_DQ_CONSUMERS_WIDE}", f"-DVF_LN_WARPS={LN_WARPS}",
)

LAUNCHES = {
    "gemm_bf16": 0,
    "gemm_geglu": 0,
    "gemm_dgrad": 0,
    "gemm_wgrad": 0,
    "attention": 0,
    "attention_bwd": 0,
    "layernorm": 0,
    "layernorm_bwd": 0,
    "geglu": 0,
    "geglu_bwd": 0,
    "masked_mean_pool": 0,
    "masked_mean_pool_bwd": 0,
    "colsum": 0,
    "fused_window_encoder": 0,
    "fused_window_encoder_bwd": 0,
    "fused_gene_modulator": 0,
    "fused_gene_modulator_fwd_save": 0,
    "fused_gene_modulator_bwd1": 0,
    "fused_gene_modulator_bwd0": 0,
    "cre_stack": 0,
    "probe_48slice": 0,
    "probe_3dreshape": 0,
    "probe_48slice_bf16_matmul": 0,
}
# The inference ops' CUDA graphs (ops/graphs.py), per op: chains captured,
# graphs replayed, graphs evicted from the cache.
GRAPHS = {op: {"captures": 0, "replays": 0, "evictions": 0}
          for op in ("fused_window_encoder", "cre_stack", "fused_gene_modulator")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "gemm_sm90.cu": {
        "vf_gemm_sm90": [
            _P, _P, _P, _P, _P,      # a, b, bias, residual, out
            _I, _I, _I, _I,          # M, N, K, layout
            _I, _I, _I, _I,          # splits, per_split, blocks, group_m
            _P, _P,                  # split partials (workspace), stream
        ]
    },
    "attention_sm90.cu": {
        "vf_attention": [
            _P, _P, _P, _P,          # q, k, v, out
            _L, _L, _L, _L, _L, _L,  # batch and row strides of q, k/v, out
            _I, _I, _I, _I, _I,      # B, H, Sq, Sk, head_dim
            _P, _I, _I,              # kv_len, len_div, kv_div
            _P, _F, _P, _P,          # slopes, scale, lse, out32
            _I, _I, _I,              # splits, per_split, consumers
            _I, _I, _P, _P,          # chunks, chunk_keys (attention_plan), walk state
            _P,                      # stream
        ]
    },
    "attention_bwd_sm90.cu": {
        "vf_attention_bwd": [
            _P, _P, _P, _P, _P,      # q, k, v, o, d_o
            _P, _P, _P,              # lse, lse_delta and part (scratch)
            _P, _P, _P,              # dq, dk, dv
            _L, _L, _L, _L, _L, _L,  # strides of q, k/v, o
            _L, _L, _L, _L, _L, _L,  # strides of d_o, dq, dk/dv
            _I, _I, _I, _I, _I,      # B, H, Sq, Sk, head_dim
            _P, _I, _I,              # kv_len, len_div, kv_div
            _P, _F, _I,              # slopes, scale, dkv_f32
            _I, _I, _I, _I,          # consumers, key_blocks, splits, per_split,
            _I, _I, _I, _I,          # dq_splits, dq_per_split, dkv_smem, dq_smem,
            _I, _I, _P,              # dq_chunks, dq_chunk_keys (attention_bwd_plan), dq state
            _P,                      # stream
        ]
    },
    "rowwise.cu": {
        "vf_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
        "vf_geglu": [_P, _P, _I, _I, _P],
        "vf_masked_mean_pool": [_P, _P, _P, _I, _I, _I, _P],
        "vf_layernorm_bwd": [_P] * 9 + [_I, _I, _F, _I, _I, _P],
        "vf_colsum": [_P, _P, _P, _I, _I, _I, _I, _P],
        "vf_geglu_bwd": [_P, _P, _P, _I, _I, _P],
        "vf_masked_mean_pool_bwd": [_P, _P, _P, _I, _I, _I, _P],
    },
    "probes.cu": {
        "vf_probe_48slice": [_P, _P, _I, _P],
        "vf_probe_3dreshape": [_P, _P, _I, _P],
        "vf_probe_48slice_bf16_matmul": [_P, _P, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for variant in ATTN_VARIANTS:
        ATTN_VARIANTS[variant] = 0
    for counts in GRAPHS.values():
        counts.update(dict.fromkeys(counts, 0))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return str(path)


def build() -> dict:
    """Compile every source that is not built yet, one nvcc process each,
    all at once, and load the libraries. Returns ``BUILD_INFO``: the build
    directory, the wall seconds of this call and the ptxas report of each
    library compiled by it."""
    if _LIBS:
        return BUILD_INFO
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in SOURCES:
        lib = out_dir / (Path(src).stem + ".so")
        if lib.exists():
            continue
        tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    reports = {}
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        reports[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in SOURCES:
        lib = ctypes.CDLL(str(out_dir / (Path(src).stem + ".so")))
        for fn, argtypes in _SIGNATURES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[src] = lib
    BUILD_INFO.update(
        dir=str(out_dir), seconds=time.perf_counter() - t0, ptxas=reports
    )
    return BUILD_INFO


def _fn(src: str, name: str):
    build()
    return getattr(_LIBS[src], name)


def _launch(name: str, src: str, fn: str, *args) -> None:
    rc = _fn(src, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
             contiguous: bool = True) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _require_rows(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """A [B, S, W] view with unit last stride and 16-byte row strides (a
    column slice of a fused projection is one)."""
    _require(t, name, dtype, 3, contiguous=False)
    if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
        raise ValueError(f"{name} needs unit last stride and strides % 8 == 0")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _splits(rows: int, cols: int) -> int:
    """Row splits of a column reduction: ~4 blocks per SM of a 132-SM card,
    each split at least 64 rows long."""
    return max(1, min(-(-rows // 64), 528 // -(-cols // 256)))


# ---------------------------------------------------------------------------
# gemm_bf16, gemm_dgrad, gemm_wgrad
# ---------------------------------------------------------------------------

H100_SMS = 132
GEMM_BLOCK_M, GEMM_BLOCK_N, GEMM_BLOCK_K = 128, 256, 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GemmPlan(NamedTuple):
    """Launch plan of ``gemm_sm90.cu`` for one product [M, K] x [K, N]
    (tiles of GEMM_BLOCK_M x GEMM_BLOCK_N)."""

    tiles_m: int
    tiles_n: int
    splits: int     # contraction splits (weight gradients only)
    per_split: int  # k-tiles of 64 in each split
    blocks: int     # persistent blocks, at most one per SM
    group_m: int    # tile rows walked together, for L2 reuse of A and B


def gemm_plan(m: int, n: int, k: int, split: bool = False, sms: int = H100_SMS) -> GemmPlan:
    """Tiles, contraction splits and persistent blocks of one GEMM.

    With ``split`` (an f32 output added into, the weight gradients) the
    contraction is cut only when the output has fewer tiles than the card
    has SMs: into the number of splits, at most 8 and each at least 16
    k-tiles long, that takes the fewest waves of units per split."""
    tiles_m, tiles_n = _cdiv(m, GEMM_BLOCK_M), _cdiv(n, GEMM_BLOCK_N)
    tiles = tiles_m * tiles_n
    ktiles = max(_cdiv(k, GEMM_BLOCK_K), 1)
    splits = 1
    if split and tiles < sms:
        most = max(1, min(8, ktiles // 16))
        splits = min(range(1, most + 1), key=lambda s: (_cdiv(tiles * s, sms) / s, s))
    per_split = _cdiv(ktiles, splits)
    splits = _cdiv(ktiles, per_split)
    return GemmPlan(tiles_m, tiles_n, splits, per_split, min(tiles * splits, sms),
                    min(8, tiles_m))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gemm_sm90(name: str, a, b, bias, res, out, m: int, n: int, k: int, layout: int) -> None:
    """One launch of ``gemm_sm90.cu``: layout 0 forward, 1 weight gradient
    (rows split by the plan, each split's f32 partial [M, N] into a
    workspace of this call's own), 2 input cotangent, 3 forward with GeGLU
    (n the weight's F columns)."""
    plan = gemm_plan(m, n, k, split=layout == 1, sms=_sm_count(a.device.index or 0))
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, n), dtype=torch.float32, device=a.device)
    _launch(name, "gemm_sm90.cu", "vf_gemm_sm90", a.data_ptr(), b.data_ptr(), _ptr(bias),
            _ptr(res), out.data_ptr(), m, n, k, layout, plan.splits, plan.per_split,
            plan.blocks, plan.group_m, _ptr(ws), _stream(a))


def gemm_plain(a, w, bias=None, residual=None):
    """out = a @ w (+ bias) (+ residual); each sum rounded to a's dtype."""
    out = torch.matmul(a, w)
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    return out


def _gemm_operands(a, w, bias) -> tuple[int, int, int]:
    """Check a forward GEMM's operands on the card; returns (M, K, N)."""
    _require(a, "a", torch.bfloat16, 2)
    _require(w, "w", torch.bfloat16, 2)
    m, k = a.shape
    if w.shape[0] != k:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    if k % 8 or n % 8 or k == 0:
        raise ValueError(f"K={k} (> 0) and N={n} must be multiples of 8")
    if bias is not None:
        _require(bias, "bias", torch.bfloat16, 1)
        if bias.shape[0] != n:
            raise ValueError("bias must be [N]")
    return m, k, n


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
         residual: torch.Tensor | None = None) -> torch.Tensor:
    """[M, K] @ [K, N] (+ bias [N]) (+ residual [M, N]) -> [M, N].

    Replaces the projections inside the Pallas kernels
    (variantformer_tpu/ops/fused_encoder.py:_kernel, fused_modulator.py:_kernel).
    Bound on the H100 by tensor-core operations at every main-path shape
    (M >= 1536 rows, K, N in 512..4608); the kernel (``gemm_sm90.cu``) feeds
    128 x 256 tiles through TMA into a shared-memory ring and
    runs ``wgmma`` from it with f32 accumulators, on a persistent grid laid
    out by ``gemm_plan``. The epilogue rounds like the JAX package's
    ``linear``: bf16(acc), + bias, then + residual, each rounded to bf16.
    K > 0 and N must be multiples of 8; M is arbitrary (ragged edge masked).
    """
    if not a.is_cuda:
        return gemm_plain(a, w, bias, residual)
    m, k, n = _gemm_operands(a, w, bias)
    if residual is not None:
        _require(residual, "residual", torch.bfloat16, 2)
        if tuple(residual.shape) != (m, n):
            raise ValueError("residual must be [M, N]")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    if m == 0:
        return out
    _gemm_sm90("gemm_bf16", a, w, bias, residual, out, m, n, k, 0)
    return out


# Output columns of one gemm_geglu tile: a GEMM tile's 256 columns are its
# value and gate halves.
GEGLU_BLOCK_N = GEMM_BLOCK_N // 2


def gemm_geglu_plain(a, w, bias=None):
    """geglu(a @ w + bias): the chains' FFN-in projection then its GeGLU,
    the same ops in the same order as ``gemm`` then ``geglu``."""
    return geglu_plain(gemm_plain(a, w, bias))


def gemm_geglu(a: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """GeGLU of [M, K] @ [K, F] (+ bias [F]) -> [M, F/2]: value * gelu_erf(gate)
    over the product's [:F/2] | [F/2:] split.

    Replaces the FFN-in projection and the GeGLU gate of the Pallas forward
    kernels (variantformer_tpu/ops/fused_encoder.py:_kernel,
    fused_modulator.py:_kernel) in one launch: layout 3 of ``gemm``'s
    kernel takes each output tile's value and gate columns of W as it is
    stored (``gemm_plan`` at [M, F, K]: F / 256 output tiles of 128
    columns a tile row), rounds the pre-activation as ``gemm`` does, and its
    epilogue warps apply the GeGLU expression of ``geglu``'s kernel, so the
    result is the bits of ``geglu(gemm(a, w, bias))`` without the [M, F]
    pre-activation's write and read. Where F / 2 is not a multiple of 128
    the two launches run instead (``LAUNCHES["gemm_geglu"]`` counts only the
    fused ones). Bound by tensor-core operations.
    """
    if not a.is_cuda:
        return gemm_geglu_plain(a, w, bias)
    if w.shape[1] % (2 * GEGLU_BLOCK_N):
        return geglu(gemm(a, w, bias))
    m, k, n = _gemm_operands(a, w, bias)
    out = torch.empty((m, n // 2), dtype=torch.bfloat16, device=a.device)
    if m:
        _gemm_sm90("gemm_geglu", a, w, bias, None, out, m, n, k, 3)
    return out


def gemm_dgrad_plain(dy, w, residual=None):
    """dy @ w^T (+ residual), each sum rounded to dy's dtype."""
    out = torch.matmul(dy, w.t())
    if residual is not None:
        out = out + residual
    return out


def gemm_dgrad(dy: torch.Tensor, w: torch.Tensor,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """dX = dY [M, N] @ W^T for a forward weight W [K, N] (+ residual
    [M, K]) -> [M, K] bf16: the input cotangent of a projection.

    Replaces the ``matmul_t`` products of the Pallas backward kernels
    (fused_encoder.py:_bwd_kernel, fused_modulator.py:_bwd1_kernel,
    _bwd0_kernel). Layout 2 of the TMA + ``wgmma`` kernel of ``gemm``: both
    operands are K-major (dY along the contraction, W's stored rows too),
    so W is loaded in boxes of 256 of its rows and read untransposed, and
    W^T is never made; the same persistent plan (never split) and bf16
    epilogue, rounding as the plain version: bf16(acc), then + residual.
    Bound by tensor-core operations. N > 0 and K must be multiples of 8.
    """
    if not dy.is_cuda:
        return gemm_dgrad_plain(dy, w, residual)
    _require(dy, "dy", torch.bfloat16, 2)
    _require(w, "w", torch.bfloat16, 2)
    m, n = dy.shape
    k = w.shape[0]
    if w.shape[1] != n:
        raise ValueError(f"shape mismatch {tuple(dy.shape)} @ {tuple(w.shape)}^T")
    if k % 8 or n % 8 or n == 0:
        raise ValueError(f"K={k} and N={n} (> 0) must be multiples of 8")
    if residual is not None:
        _require(residual, "residual", torch.bfloat16, 2)
        if tuple(residual.shape) != (m, k):
            raise ValueError("residual must be [M, K]")
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    if m == 0 or k == 0:
        return out
    _gemm_sm90("gemm_dgrad", dy, w, None, residual, out, m, k, n, 2)
    return out


def gemm_wgrad_plain(x, dy, out=None):
    """x^T @ dy in f32 (added into ``out`` when given)."""
    dw = torch.matmul(x.float().t(), dy.float())
    if out is None:
        return dw
    out += dw
    return out


def gemm_wgrad(x: torch.Tensor, dy: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """dW = X [R, K]^T @ dY [R, N] -> [K, N] f32, added into ``out`` (a
    contiguous f32 [K, N], e.g. one layer of a stacked gradient) when given.

    Replaces the ``matmul_rows`` weight-gradient products of the Pallas
    backward kernels, which accumulate dW in VMEM across a sequential grid
    of row blocks. Here one GEMM contracts all R rows (up to ~80 000) on the
    TMA + ``wgmma`` kernel of ``gemm``, with X read in its stored layout
    (M-major, transposed by ``wgmma``) and, when [K, N] has fewer tiles
    than the card has SMs, the rows split across units (``gemm_plan``):
    each writes its f32 partial tile into a workspace [splits, K, N], and a
    second pass adds the partials in split order into ``out``, so the
    result is the same bits from run to run (no atomics). Bound by
    tensor-core operations. K and N must be multiples of 8.
    """
    if not x.is_cuda:
        return gemm_wgrad_plain(x, dy, out)
    _require(x, "x", torch.bfloat16, 2)
    _require(dy, "dy", torch.bfloat16, 2)
    rows, k = x.shape
    n = dy.shape[1]
    if dy.shape[0] != rows:
        raise ValueError(f"row mismatch {tuple(x.shape)} vs {tuple(dy.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8")
    if out is None:
        out = torch.zeros((k, n), dtype=torch.float32, device=x.device)
    else:
        _require(out, "out", torch.float32, 2)
        if tuple(out.shape) != (k, n):
            raise ValueError("out must be [K, N]")
    if rows == 0:
        return out
    _gemm_sm90("gemm_wgrad", x, dy, None, None, out, k, n, rows, 1)
    return out


# ---------------------------------------------------------------------------
# attention, attention_bwd
# ---------------------------------------------------------------------------


ATTN_BLOCK_Q = ATTN_BLOCK_K = 64  # query rows of a work item, keys per tile
ATTN_MAX_KEYS = 768                # the keys of a chunk: its K and V held whole in shared memory
ATTN_MAX_KEYS_WIDE = 320           # the same at head dim 128 (two 64-column boxes a tile)
ATTN_HEAD_DIMS = (48, 64, 128)     # the head dims the attention kernels are built for
SMEM_LIMIT = 232_448               # dynamic shared memory of one H100 block


def attn_max_keys(head_dim: int) -> int:
    """The most keys one forward launch holds at this head dim."""
    return ATTN_MAX_KEYS if head_dim <= 64 else ATTN_MAX_KEYS_WIDE


class AttnVariant(NamedTuple):
    """The softmax an attention call takes (``attention_sm90.cu``'s ALIBI and
    STATS template arguments): the ALiBi term where slopes are given, and
    where ``for_backward`` asks for them the statistics the backward reads
    (lse, the renormalised f32 output), each score then taking the
    arithmetic whose bits those outputs keep."""

    alibi: bool
    stats: bool


def attention_variant(slopes: torch.Tensor | None, for_backward: bool) -> AttnVariant:
    """The variant the kernel runs for a call with these arguments. The
    launch hands it over as which pointers it passes (slopes; lse and
    out32), and ``vf_attention`` picks the instantiation from them."""
    return AttnVariant(alibi=slopes is not None, stats=bool(for_backward))


# Host launches of the attention forward by variant (a replayed graph
# launches none; the device trace names the template in each kernel).
ATTN_VARIANTS = {AttnVariant(alibi, stats): 0 for alibi in (False, True)
                 for stats in (False, True)}


class AttentionPlan(NamedTuple):
    """Launch plan of ``attention_sm90.cu``: ``chunks`` launches in key
    order, each of grid (splits, H, B // kv_div). Launch c walks keys
    [c * chunk_keys, min(Sk, (c + 1) * chunk_keys)). Its block (s, h, r)
    loads those keys of K/V row r's head h once and takes work items
    [s * per_split, min(items, (s + 1) * per_split)), item i being query
    row r * kv_div + i // q_tiles, query tile i % q_tiles."""

    q_tiles: int     # 64-row query tiles of a batch row
    kv_tiles: int    # 64-key tiles of a chunk's K and V in shared memory
    consumers: int   # consumer warpgroups of a block
    groups: int      # (K/V row, head) pairs
    splits: int      # blocks per group
    per_split: int   # work items of a block
    blocks: int      # blocks of one launch
    chunks: int      # launches along the keys
    chunk_keys: int  # keys of a chunk: Sk when chunks == 1, else a multiple of 64


def key_chunks(sk: int, max_keys: int) -> tuple[int, int, int]:
    """(chunks, 64-key tiles a chunk, keys a chunk) of a walk over Sk keys
    in chunks of at most ``max_keys`` (a multiple of 64), the tiles spread
    evenly over the chunks."""
    if max_keys < ATTN_BLOCK_K or max_keys % ATTN_BLOCK_K:
        raise ValueError(f"max_keys={max_keys} must be a positive multiple of {ATTN_BLOCK_K}")
    tiles = _cdiv(sk, ATTN_BLOCK_K)
    chunks = max(1, _cdiv(tiles, max_keys // ATTN_BLOCK_K))
    per_chunk = _cdiv(tiles, chunks)
    return chunks, per_chunk, sk if chunks == 1 else per_chunk * ATTN_BLOCK_K


def attention_plan(b: int, heads: int, sq: int, sk: int, kv_div: int = 1,
                   sms: int = H100_SMS, max_keys: int = ATTN_MAX_KEYS,
                   head_dim: int = 64) -> AttentionPlan:
    """Blocks of one attention call. The keys are walked in chunks of at
    most ``max_keys`` (one when Sk <= ATTN_MAX_KEYS, every main-path call;
    at head dim 128, whose tiles are twice the bytes, ATTN_MAX_KEYS_WIDE);
    each chunk is one launch, which carries the rows' softmax state (f32 O,
    max and sums) to the next. Up to 256 keys a chunk (K and V in 64 KB),
    two blocks of two consumer warpgroups share an SM; past that one block
    of four does (up to 640 keys; two warpgroups up to ATTN_MAX_KEYS); at
    head dim 128 one block of two. A group's items go to one block (K/V
    read once) unless the groups alone give fewer than ~4 blocks per SM;
    then they are split, each block keeping at least one item per consumer
    warpgroup (the cross-attention: 54 tissues x 4 query tiles share each
    gene's K/V head)."""
    chunks, kv_tiles, chunk_keys = key_chunks(sk, min(max_keys, attn_max_keys(head_dim)))
    q_tiles = _cdiv(sq, ATTN_BLOCK_Q)
    consumers = 4 if 4 < kv_tiles <= 10 and head_dim <= 64 else 2
    groups = (b // kv_div) * heads
    items = kv_div * q_tiles
    splits = max(1, min(_cdiv(items, consumers), _cdiv(4 * sms, groups)))
    per_split = _cdiv(items, splits)
    splits = _cdiv(items, per_split)
    return AttentionPlan(q_tiles, kv_tiles, consumers, groups, splits, per_split,
                         groups * splits, chunks, chunk_keys)


ATTN_BWD_MAX_KEYS = 576  # the keys of a dQ chunk: K, V and four Q/dO buffers in 227 KB
ATTN_BWD_MAX_KEYS_WIDE = 320  # at head dim 128: K, V and two Q/dO buffers of one warpgroup


def attn_bwd_dq_consumers(head_dim: int) -> int:
    """Consumer warpgroups of a dQ block at this head dim."""
    return ATTN_BWD_DQ_CONSUMERS if head_dim <= 64 else ATTN_BWD_DQ_CONSUMERS_WIDE


def attn_bwd_max_keys(head_dim: int) -> int:
    """The most keys one dQ launch holds at this head dim."""
    return ATTN_BWD_MAX_KEYS if head_dim <= 64 else ATTN_BWD_MAX_KEYS_WIDE


def _attn_bwd_smem(consumers: int, dq_kv_tiles: int, head_dim: int = 64) -> tuple[int, int]:
    """Dynamic shared memory of a dK/dV and of a dQ block: 1 KB of
    alignment room, head tiles of one 8 KB [64][64] bf16 box (two at head
    dim 128), 512-byte lse/delta chunks and 8-byte mbarriers. dK/dV: its K and V
    tiles, a ring of (Q, dO, chunk), one K/V barrier and a full and an
    empty one a stage. dQ: a key chunk's K and V, two (Q, dO, chunk)
    buffers a consumer warpgroup, a barrier a key tile (room for
    ATTN_MAX_KEYS) and one a buffer. The kernels refuse a launch whose sizes
    differ from their own layout's."""
    boxes = _cdiv(head_dim, 64)  # the 128-byte TMA swizzle holds 64 bf16 columns
    tile, chunk = boxes * ATTN_BLOCK_Q * ATTN_BLOCK_K * 2, 4 * 2 * ATTN_BLOCK_Q
    nc = attn_bwd_dq_consumers(head_dim)
    dkv = (1024 + (2 * consumers + 2 * ATTN_BWD_STAGES) * tile + ATTN_BWD_STAGES * chunk
           + 8 * (1 + 2 * ATTN_BWD_STAGES))
    dq = (1024 + (2 * dq_kv_tiles + 4 * nc) * tile + 2 * nc * chunk
          + 8 * (ATTN_MAX_KEYS // ATTN_BLOCK_K + 2 * nc))
    return dkv, dq


class AttentionBwdPlan(NamedTuple):
    """Launch plan of ``attention_bwd_sm90.cu``.

    dK/dV pass: grid (key_blocks * splits, H, B // kv_div). Block (x, h, r)
    owns keys [kb * 64 * consumers, (kb + 1) * 64 * consumers) of K/V row
    r's head h, kb = x % key_blocks (consumer warpgroup c the 64-key tile
    kb * consumers + c), and walks items [s * per_split, min(items, (s + 1)
    * per_split)), s = x // key_blocks, item i being query row r * kv_div +
    i // q_tiles, query tile i % q_tiles. With splits > 1 each split writes
    f32 partials and a sum pass adds them in split order.
    dQ pass: ``dq_chunks`` launches in key order, launch c over keys
    [c * dq_chunk_keys, min(Sk, (c + 1) * dq_chunk_keys)), each of grid
    (dq_splits, H, B // kv_div); block (s, h, r) holds that chunk of K/V
    row r's head h and its two consumer warpgroups take items s *
    dq_per_split + c, + 2, ... (c the warpgroup), as the forward's; an
    item's f32 dQ is carried from one launch to the next."""

    q_tiles: int
    kv_tiles: int       # 64-key tiles of K and V
    consumers: int      # dK/dV consumer warpgroups of a block: 1 (Sk <= 64) or 2
    key_blocks: int     # dK/dV blocks along the keys of a (K/V row, head)
    groups: int         # (K/V row, head, key block)
    splits: int         # dK/dV blocks per group
    per_split: int      # items of a dK/dV block
    blocks: int
    dq_splits: int      # dQ blocks per (K/V row, head)
    dq_per_split: int   # items of a dQ block
    dq_blocks: int      # dQ blocks of one launch
    dkv_smem: int       # dynamic shared memory of a dK/dV block, bytes
    dq_smem: int        # of a dQ block
    dq_chunks: int      # dQ launches along the keys
    dq_chunk_keys: int  # keys of a dQ chunk: Sk when dq_chunks == 1, else a multiple of 64
    dq_consumers: int   # consumer warpgroups of a dQ block


def attention_bwd_plan(b: int, heads: int, sq: int, sk: int, kv_div: int = 1,
                       sms: int = H100_SMS, max_keys: int = ATTN_BWD_MAX_KEYS,
                       head_dim: int = 64) -> AttentionBwdPlan:
    """Blocks of one attention backward. A dK/dV block of two consumer
    warpgroups (one where a single key tile exists) takes one SM by its
    registers (two for one warpgroup); it holds at most two key tiles, so
    any Sk takes it. Its groups' items go to one block, so the K/V
    cotangent is summed inside it, unless the groups alone give fewer than
    ~4 blocks per SM: then each group's kv_div x q_tiles items are split
    over blocks (the cross-attention: 54 tissues x 4 query tiles per gene,
    head and key block, on 64-384 groups). The dQ pass walks the keys in
    chunks of at most ``max_keys`` (one when Sk <= ATTN_BWD_MAX_KEYS) and
    splits like ``attention_plan`` with two consumer warpgroups. At head
    dim 128 a dK/dV block takes one consumer warpgroup (two would spill
    their 128 dK/dV accumulators a thread), and a dQ block
    ATTN_BWD_DQ_CONSUMERS_WIDE with chunks of at most ATTN_BWD_MAX_KEYS_WIDE
    keys."""
    q_tiles, kv_tiles = _cdiv(sq, ATTN_BLOCK_Q), _cdiv(sk, ATTN_BLOCK_K)
    items = kv_div * q_tiles
    consumers = 1 if kv_tiles == 1 or head_dim > 64 else 2
    key_blocks = _cdiv(kv_tiles, consumers)
    groups = (b // kv_div) * heads * key_blocks
    target = 4 * sms * (1 if consumers == 2 else 2)
    splits = 1 if groups >= target else max(1, min(items, _cdiv(target, groups)))
    per_split = _cdiv(items, splits)
    splits = _cdiv(items, per_split)
    dq_chunks, dq_tiles, dq_chunk_keys = key_chunks(
        sk, min(max_keys, attn_bwd_max_keys(head_dim)))
    dq_nc = attn_bwd_dq_consumers(head_dim)
    dq_groups = (b // kv_div) * heads
    dq_splits = max(1, min(_cdiv(items, dq_nc), _cdiv(4 * sms, dq_groups)))
    dq_per_split = _cdiv(items, dq_splits)
    dq_splits = _cdiv(items, dq_per_split)
    return AttentionBwdPlan(q_tiles, kv_tiles, consumers, key_blocks, groups, splits, per_split,
                            groups * splits, dq_splits, dq_per_split, dq_groups * dq_splits,
                            *_attn_bwd_smem(consumers, dq_tiles, head_dim), dq_chunks,
                            dq_chunk_keys, dq_nc)


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, width = t.shape
    return t.reshape(b, s, num_heads, width // num_heads)


def attention_plain(q, k, v, kv_len, slopes, scale, num_heads, kv_div=1, len_div=1,
                    for_backward=False):
    b, sq, hd = q.shape
    lens = kv_len.repeat_interleave(len_div)
    k = k.repeat_interleave(kv_div, dim=0)
    v = v.repeat_interleave(kv_div, dim=0)
    res = attend(_split_heads(q, num_heads), _split_heads(k, num_heads),
                 _split_heads(v, num_heads), lens, slopes, scale, for_backward)
    if for_backward:
        out, lse, out32 = res
        return out.reshape(b, sq, hd), lse, out32.reshape(b, sq, hd)
    return res.reshape(b, sq, hd)


def attention(
    q: torch.Tensor,              # [B, Sq, H*D], last dim contiguous
    k: torch.Tensor,              # [B // kv_div, Sk, H*D]
    v: torch.Tensor,              # [B // kv_div, Sk, H*D]
    kv_len: torch.Tensor,         # [B // len_div] int32 valid keys
    slopes: torch.Tensor | None,  # [H] f32 ALiBi slopes, or None
    scale: float,
    num_heads: int,
    kv_div: int = 1,
    len_div: int = 1,
    for_backward: bool = False,
    *,
    max_keys: int = ATTN_MAX_KEYS,
):
    """Masked softmax attention; returns [B, Sq, H*D] (heads concatenated).
    With ``for_backward`` it returns (out, lse, out32): also the rows' f32
    log-sum-exp [B, H, Sq] and the f32 output with the bf16-rounded weights
    renormalised to sum to 1 [B, Sq, H*D], which ``attention_bwd`` reads.

    Query row b attends to K/V row ``b // kv_div`` with ``kv_len[b // len_div]``
    valid keys, so the gene stack's cross-attention reads donor-shared K/V
    through a stride and never materialises the tissue broadcast. q, k, v may
    be strided views (e.g. column slices of a fused QKV projection).

    Replaces the per-head attention loops of the Pallas kernels
    (variantformer_tpu/ops/fused_encoder.py:_kernel l.131-159,
    fused_modulator.py:_kernel l.180-247). At the main-path shapes
    (Sk <= 384, head_dim 48, 64 or 128) the self-attentions are bound by
    bytes, the gene cross-attention by operations, and at head dims 48 and
    64 the softmax's one ex2 a score sets a floor above both. The kernel
    (``attention_sm90.cu``) loads each (K/V row, head)'s K and V once by
    TMA and walks every query tile that reads them (``attention_plan``);
    per 64-key tile, S = Q K^T and O += P V run on ``wgmma`` with the
    online softmax in registers, the softmax of one tile running beside the
    previous tile's P V, stopping at the last valid key (a row with no
    valid key averages V over all keys, as the plain version does with the
    finite MASK_VALUE). The softmax takes only the call's work
    (``attention_variant``): no ALiBi term without ``slopes``, and without
    ``for_backward`` no statistics, the scale then folded into the
    exponent where ALiBi is off too (the serving cross-attentions; their
    outputs may differ from the statistics variant's in the last bits).
    Past ATTN_MAX_KEYS keys (or
    ``max_keys``, a multiple of 64) the walk is cut into key chunks, one
    launch each in key order, ALiBi and the masks taken at the absolute key
    index; each launch leaves a row's f32 O, running max and sums in a
    state buffer for the next, which resumes the online softmax exactly
    where the last stopped, so the outputs are those of one walk over all
    keys.
    """
    if not q.is_cuda:
        return attention_plain(q, k, v, kv_len, slopes, scale, num_heads, kv_div, len_div,
                               for_backward)
    b, sq, hd, sk, head_dim = _check_attention(q, k, v, kv_len, slopes, num_heads, kv_div,
                                               len_div)
    variant = attention_variant(slopes, for_backward)
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    lse = out32 = None
    if variant.stats:
        lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
        out32 = torch.empty((b, sq, hd), dtype=torch.float32, device=q.device)
    if b and sq:
        plan = attention_plan(b, num_heads, sq, sk, kv_div, _sm_count(q.device.index or 0),
                              max_keys, head_dim)
        o_state = stats = None
        if plan.chunks > 1:  # a row's O (out's layout) and per-lane (max, sums)
            o_state = torch.empty((b, sq, hd), dtype=torch.float32, device=q.device)
            stats = torch.empty((b, num_heads, sq, 4, 4), dtype=torch.float32, device=q.device)
        _launch(
            "attention", "attention_sm90.cu", "vf_attention",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            out.stride(0), out.stride(1),
            b, num_heads, sq, sk, head_dim,
            kv_len.data_ptr(), len_div, kv_div,
            _ptr(slopes), scale, _ptr(lse), _ptr(out32), plan.splits, plan.per_split,
            plan.consumers, plan.chunks, plan.chunk_keys, _ptr(o_state), _ptr(stats),
            _stream(q),
        )
        ATTN_VARIANTS[variant] += 1
    return (out, lse, out32) if for_backward else out


def _require_tma_rows(t: torch.Tensor, name: str) -> None:
    """A bf16 [B, S, W] view that a TMA tensor map can take: unit last
    stride, row and batch strides multiples of 16 bytes, 16-byte aligned
    base (a column slice of a fused projection is one). Checked on any
    device, so that the CPU tests can hold it."""
    if t.dtype != torch.bfloat16 or t.dim() != 3:
        raise ValueError(f"{name} must be a bf16 [B, S, W] tensor, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
        raise ValueError(f"{name} needs unit last stride and row and batch strides that are "
                         f"multiples of 16 bytes, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_attention(q, k, v, kv_len, slopes, num_heads, kv_div, len_div):
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require_tma_rows(t, name)
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
    b, sq, hd = q.shape
    bk, sk, _ = k.shape
    if hd % num_heads or k.shape[2] != hd or tuple(v.shape) != tuple(k.shape):
        raise ValueError("q, k, v widths disagree")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    head_dim = hd // num_heads
    if head_dim not in ATTN_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not built {ATTN_HEAD_DIMS}")
    if b > 65535 or num_heads > 65535:
        raise ValueError("B and H must fit the grid (<= 65535)")
    if bk * kv_div != b or b % len_div:
        raise ValueError("B must equal (K/V batch) * kv_div and divide by len_div")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b // len_div,) \
            or kv_len.device != q.device or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be contiguous int32 [B // len_div] on {q.device}")
    if slopes is not None and (slopes.dtype != torch.float32
                               or tuple(slopes.shape) != (num_heads,)
                               or slopes.device != q.device or not slopes.is_contiguous()):
        raise ValueError(f"slopes must be contiguous f32 [H] on {q.device}")
    if b and sq and sk == 0:
        raise ValueError("attention needs at least one key")
    return b, sq, hd, sk, head_dim


def _into(buf: torch.Tensor | None, val: torch.Tensor) -> torch.Tensor:
    if buf is None:
        return val
    buf.copy_(val)
    return buf


def attention_bwd_plain(q, k, v, o, lse, do, kv_len, slopes, scale, num_heads, kv_div=1,
                        len_div=1, dq=None, dk=None, dv=None):
    """The kernel's arithmetic in plain PyTorch: P = exp(s - lse) on valid
    keys (1/Sk for a row with kv_len = 0), dV = bf16(P)^T dO, dS = bf16(P *
    (dO V^T - rowsum(dO * O)) * scale) with O the renormalised f32 output
    of ``attention(for_backward=True)``, zero on
    masked keys and on rows with kv_len = 0, dQ = dS K, dK = dS^T Q; K/V
    cotangents summed over the kv_div rows that share them. Returns (dq in
    q's dtype, dk, dv in f32), each copied into the matching buffer when one
    is given."""
    b, sq, _ = q.shape
    lens = kv_len.repeat_interleave(len_div)
    qh, doh, oh = (_split_heads(t, num_heads).float() for t in (q, do, o))
    kh = _split_heads(k.repeat_interleave(kv_div, dim=0), num_heads).float()
    vh = _split_heads(v.repeat_interleave(kv_div, dim=0), num_heads).float()
    sk = kh.shape[1]
    valid = (torch.arange(sk, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    scores = masked_scores(qh, kh, lens, slopes, scale)
    p = torch.where(valid, torch.exp(scores - lse[..., None]), 0.0)
    p = torch.where((lens == 0)[:, None, None, None], 1.0 / sk, p)
    dvh = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), doh)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    delta = (doh * oh).sum(-1).transpose(1, 2)[..., None]   # [B, H, Sq, 1]
    ds = torch.where(valid, p * (dp - delta) * scale, 0.0).to(q.dtype).float()
    dqh = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dkh = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    fold = lambda t: t.reshape(b // kv_div, kv_div, sk, -1).sum(1)
    return (_into(dq, dqh.reshape(b, sq, -1).to(q.dtype)), _into(dk, fold(dkh)),
            _into(dv, fold(dvh)))


def attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    o: torch.Tensor,              # [B, Sq, H*D] f32 output  } from attention(
    lse: torch.Tensor,            # [B, H, Sq] f32           }   for_backward=True)
    do: torch.Tensor,             # [B, Sq, H*D] cotangent of o
    kv_len: torch.Tensor, slopes: torch.Tensor | None, scale: float, num_heads: int,
    kv_div: int = 1, len_div: int = 1,
    dq: torch.Tensor | None = None,  # [B, Sq, H*D] bf16 buffer (may be a strided view)
    dk: torch.Tensor | None = None,  # [B // kv_div, Sk, H*D] bf16 or f32 buffer
    dv: torch.Tensor | None = None,  # like dk, same strides
    *,
    max_keys: int = ATTN_BWD_MAX_KEYS,
):
    """Backward of ``attention``: returns (dq, dk, dv), written into the
    buffers given (dk, dv default to f32, dq to bf16).

    Replaces the attention backward of the Pallas recompute kernels
    (fused_encoder.py:_bwd_kernel, fused_modulator.py:_bwd1_kernel
    l.769-803, _bwd0_kernel). Bound by bytes at the main-path shapes. The
    kernels (``attention_bwd_sm90.cu``, laid out by ``attention_bwd_plan``)
    run on TMA and ``wgmma``: a prep pass takes delta = rowsum(dO * O) from
    the forward's f32 output and lays out each query tile's log-sum-exp and
    delta; a dK/dV pass, keys as the wgmma M, loads a (K/V row, head)'s key
    tiles once and streams the query tiles that read them through a ring,
    with P^T and dS^T rebuilt in registers; where a group's items would run
    in series on too few blocks (the cross-attention's tissues) they are
    split over blocks whose f32 partials a sum pass adds in a fixed order;
    a dQ pass, queries as M, walks the key tiles, in key chunks of at most
    ATTN_BWD_MAX_KEYS (or ``max_keys``), one launch each in key order, an
    item's f32 dQ carried from one to the next. No atomics. The same
    conventions as the forward: rows with kv_len = 0 average V (P = 1/Sk,
    no score gradient), keys past kv_len get exactly 0. q, k, v and do must
    be views a TMA tensor map takes (``_require_tma_rows``); o, dq, dk and
    dv need unit last stride and 16-byte strides.
    """
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, o, lse, do, kv_len, slopes, scale, num_heads,
                                   kv_div, len_div, dq, dk, dv)
    b, sq, hd, sk, head_dim = _check_attention(q, k, v, kv_len, slopes, num_heads, kv_div,
                                               len_div)
    _require_tma_rows(do, "do")
    _require_rows(o, "o", torch.float32)
    for t, name in ((o, "o"), (do, "do")):
        if tuple(t.shape) != (b, sq, hd) or t.device != q.device:
            raise ValueError(f"{name} must be [B, Sq, H*D] on {q.device}")
    _require(lse, "lse", torch.float32, 3)
    if tuple(lse.shape) != (b, num_heads, sq):
        raise ValueError("lse must be [B, H, Sq]")
    if dq is None:
        dq = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    if dk is None:
        dk = torch.empty((b // kv_div, sk, hd), dtype=torch.float32, device=q.device)
    if dv is None:
        dv = torch.empty_like(dk)
    _require_rows(dq, "dq", torch.bfloat16)
    for t, name in ((dk, "dk"), (dv, "dv")):
        _require_rows(t, name, dk.dtype)
        if tuple(t.shape) != tuple(k.shape):
            raise ValueError(f"{name} must be shaped like k")
    if dk.dtype not in (torch.bfloat16, torch.float32) or dk.stride() != dv.stride():
        raise ValueError("dk and dv must be bf16 or f32 and share strides")
    if tuple(dq.shape) != (b, sq, hd):
        raise ValueError("dq must be [B, Sq, H*D]")
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    plan = attention_bwd_plan(b, num_heads, sq, sk, kv_div, _sm_count(q.device.index or 0),
                              max_keys, head_dim)
    lse_delta = torch.empty((b, num_heads, plan.q_tiles, 2 * ATTN_BLOCK_Q), dtype=torch.float32,
                            device=q.device)
    part = dq_state = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, b // kv_div, sk, 2 * hd), dtype=torch.float32,
                           device=q.device)
    if plan.dq_chunks > 1:
        dq_state = torch.empty((b, sq, hd), dtype=torch.float32, device=q.device)
    _launch(
        "attention_bwd", "attention_bwd_sm90.cu", "vf_attention_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), lse_delta.data_ptr(), _ptr(part), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), o.stride(0), o.stride(1),
        do.stride(0), do.stride(1), dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        b, num_heads, sq, sk, head_dim, kv_len.data_ptr(), len_div, kv_div,
        _ptr(slopes), scale, int(dk.dtype == torch.float32),
        plan.consumers, plan.key_blocks, plan.splits, plan.per_split, plan.dq_splits,
        plan.dq_per_split, plan.dkv_smem, plan.dq_smem, plan.dq_chunks, plan.dq_chunk_keys,
        _ptr(dq_state), _stream(q),
    )
    return dq, dk, dv


# ---------------------------------------------------------------------------
# layernorm, geglu, masked_mean_pool, colsum and their backwards
# ---------------------------------------------------------------------------


def layernorm_plain(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim with f32 statistics; output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


LN_MAX_CHUNKS = 8  # 16-byte chunks of a row a lane holds in registers: E <= 2048


class LayernormPlan(NamedTuple):
    """Launch plan of ``rowwise.cu``'s LayerNorm forward: warp w of block i
    takes rows i * LN_WARPS + w + j * blocks * LN_WARPS, j = 0, 1, ..."""

    blocks: int
    chunks: int  # 16-byte chunks a lane holds (E / 256); 0: the general kernel


def layernorm_plan(rows: int, e: int, sms: int = H100_SMS) -> LayernormPlan:
    """Where E is a multiple of 256 up to 256 * LN_MAX_CHUNKS (512 and 1536
    on the main paths) a persistent grid whose lanes keep scale and bias in
    registers: one block of 8 warps an SM where those and the rows in
    flight take more than 128 registers a lane (E > 768), two otherwise,
    but no more blocks than there are rows for their warps. Any other E (a
    multiple of 8) takes the general kernel: a block per 8 rows."""
    chunks = e // 256 if e % 256 == 0 and e // 256 <= LN_MAX_CHUNKS else 0
    if not chunks:
        return LayernormPlan(max(1, _cdiv(rows, LN_WARPS)), 0)
    per_sm = 1 if e > 768 else 2
    return LayernormPlan(max(1, min(_cdiv(rows, LN_WARPS), sms * per_sm)), chunks)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of [rows, E]: f32 statistics, bf16 out.

    Replaces ``layer_norm`` inside the Pallas kernels. Bound by bytes (one
    read and one write of the rows). On the main paths' widths
    (``layernorm_plan``) a warp holds a whole row in registers from one set
    of 16-byte loads, with the next rows' loads in flight while it reduces
    this one, and scale and bias are loaded once per lane for all its rows;
    the mean and the centred variance come from the registers, in the
    order of the general kernel (one warp a row, three reads of it), whose
    output it gives bit for bit.
    """
    if not x.is_cuda:
        return layernorm_plain(x, scale, bias, eps)
    _require(x, "x", torch.bfloat16, 2)
    _require(scale, "scale", torch.float32, 1)
    _require(bias, "bias", torch.float32, 1)
    rows, e = x.shape
    if e % 8 or scale.shape[0] != e or bias.shape[0] != e:
        raise ValueError("E must be a multiple of 8 and match scale/bias")
    out = torch.empty_like(x)
    if rows:
        plan = layernorm_plan(rows, e, _sm_count(x.device.index or 0))
        _launch("layernorm", "rowwise.cu", "vf_layernorm", x.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), rows, e, eps, plan.blocks, plan.chunks,
                _stream(x))
    return out


def layernorm_bwd_plain(x, dy, scale, residuals=(), eps=1e-5):
    """(dx + sum(residuals) in x's dtype, dscale f32, dbias f32) of
    y = xhat * scale + bias over the last dim of [rows, E]."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    dyf = dy.float()
    dxhat = dyf * scale.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    for r in residuals:
        dx = dx + r.float()
    return dx.to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0)


LN_BWD_MAX_E = 2048  # 8 columns a lane in at most 8 chunks of 256


class LayernormBwdPlan(NamedTuple):
    """Launch plan of ``rowwise.cu``'s one-pass LayerNorm backward: block i
    takes rows [i * per_block, min(rows, (i + 1) * per_block)), its warp w
    rows w, w + LN_WARPS, ... of that span, and writes one partial row of
    dscale and of dbias; a second pass adds the blocks' rows in order."""

    blocks: int
    per_block: int


def layernorm_bwd_plan(rows: int, e: int, sms: int = H100_SMS) -> LayernormBwdPlan:
    """A persistent grid: one block of 8 warps an SM where a lane's 2 x E/32
    running sums take most of its registers (E > 1024), two otherwise, but
    no more blocks than there are rows for their warps."""
    per_sm = 1 if e > 1024 else 2
    blocks = max(1, min(_cdiv(rows, LN_WARPS), sms * per_sm))
    per_block = max(1, _cdiv(rows, blocks))
    return LayernormBwdPlan(max(1, _cdiv(rows, per_block)), per_block)


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                  residuals: tuple = (), eps: float = 1e-5):
    """LayerNorm backward over [rows, E]: returns (dx bf16, dscale [E] f32,
    dbias [E] f32), with up to two bf16 [rows, E] residual cotangents added
    to dx in f32 before its one rounding (the ``dnext + dh + dLN1`` sums of
    the Pallas backward kernels).

    Replaces ``_ln_bwd`` inside the Pallas backward kernels
    (fused_encoder.py:493-501). Bound by bytes. One pass
    (``layernorm_bwd_plan``): each warp reads a row's x, dy and residuals
    once, recomputes the statistics, writes dx and keeps its lanes' dscale
    and dbias sums in registers; each block writes one partial row of each,
    which a second small pass sums in block order (deterministic, no
    atomics). E <= LN_BWD_MAX_E.
    """
    if not x.is_cuda:
        return layernorm_bwd_plain(x, dy, scale, residuals, eps)
    if len(residuals) > 2:
        raise ValueError("at most two residuals")
    _require(x, "x", torch.bfloat16, 2)
    _require(dy, "dy", torch.bfloat16, 2)
    _require(scale, "scale", torch.float32, 1)
    rows, e = x.shape
    if e % 8 or e > LN_BWD_MAX_E or scale.shape[0] != e or tuple(dy.shape) != (rows, e):
        raise ValueError(f"E must be a multiple of 8 up to {LN_BWD_MAX_E}; dy and scale must "
                         "match x")
    for r in residuals:
        _require(r, "residual", torch.bfloat16, 2)
        if tuple(r.shape) != (rows, e):
            raise ValueError("residuals must be [rows, E]")
    res = list(residuals) + [None] * (2 - len(residuals))
    dx = torch.empty_like(x)
    dscale = torch.zeros(e, dtype=torch.float32, device=x.device)
    dbias = torch.zeros(e, dtype=torch.float32, device=x.device)
    if rows:
        plan = layernorm_bwd_plan(rows, e, _sm_count(x.device.index or 0))
        part = torch.empty((2, plan.blocks, e), dtype=torch.float32, device=x.device)
        _launch("layernorm_bwd", "rowwise.cu", "vf_layernorm_bwd",
                x.data_ptr(), dy.data_ptr(), scale.data_ptr(), _ptr(res[0]), _ptr(res[1]),
                dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), part.data_ptr(), rows, e,
                eps, plan.blocks, plan.per_block, _stream(x))
    return dx, dscale, dbias


def geglu_plain(h):
    """value * gelu(gate) over the [:half] | [half:] split, exact (erf) GELU."""
    value, gate = h.chunk(2, dim=-1)
    return value * F.gelu(gate)


def geglu(f: torch.Tensor) -> torch.Tensor:
    """[rows, F] -> [rows, F/2]: value * gelu_erf(gate), value = f[:, :F/2].

    Replaces the GeGLU gate of the Pallas kernels, which use tanh-GELU only
    because Mosaic has no erf; this kernel uses ``erff``. Bound by bytes;
    8 elements per thread with 16-byte loads.
    """
    if not f.is_cuda:
        return geglu_plain(f)
    _require(f, "f", torch.bfloat16, 2)
    rows, width = f.shape
    if width % 16:
        raise ValueError("F must be a multiple of 16")
    out = torch.empty((rows, width // 2), dtype=torch.bfloat16, device=f.device)
    if rows:
        _launch("geglu", "rowwise.cu", "vf_geglu", f.data_ptr(), out.data_ptr(), rows,
                width // 2, _stream(f))
    return out


def geglu_bwd_plain(f, dm):
    """d(f) = [dm * gelu(gate) | dm * value * gelu'(gate)] with the exact
    erf GELU; gelu(gate) rounded to f's dtype as in the forward."""
    value, gate = f.float().chunk(2, dim=-1)
    cdf = 0.5 * (1.0 + torch.erf(gate * 0.7071067811865476))
    pdf = torch.exp(-0.5 * gate * gate) * 0.3989422804014327
    gelu = (gate * cdf).to(f.dtype).float()
    dmf = dm.float()
    return torch.cat([dmf * gelu, dmf * value * (cdf + gate * pdf)], dim=-1).to(f.dtype)


def geglu_bwd(f: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """GeGLU backward: f [rows, F] (the forward's input), dm [rows, F/2]
    (the output's cotangent) -> df [rows, F] bf16.

    Replaces the GeGLU backward of the Pallas kernels (fused_encoder.py
    l.639-643), with the exact erf derivative where they use tanh's
    (``_gelu_tanh_grad``, Mosaic has no erf). Bound by bytes; 8 elements
    per thread with 16-byte loads.
    """
    if not f.is_cuda:
        return geglu_bwd_plain(f, dm)
    _require(f, "f", torch.bfloat16, 2)
    _require(dm, "dm", torch.bfloat16, 2)
    rows, width = f.shape
    if width % 16 or tuple(dm.shape) != (rows, width // 2):
        raise ValueError("F must be a multiple of 16 and dm [rows, F/2]")
    df = torch.empty_like(f)
    if rows:
        _launch("geglu_bwd", "rowwise.cu", "vf_geglu_bwd", f.data_ptr(), dm.data_ptr(),
                df.data_ptr(), rows, width // 2, _stream(f))
    return df


def masked_mean_pool_plain(x, tok_len):
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < tok_len[:, None]
    total = torch.where(valid[:, :, None], x.float(), 0.0).sum(dim=1)
    denom = tok_len.clamp(min=1).float()[:, None]
    return (total / denom).to(x.dtype)


def masked_mean_pool(x: torch.Tensor, tok_len: torch.Tensor) -> torch.Tensor:
    """[N, L, E], [N] -> [N, E]: f32 sum of the first tok_len rows / max(len, 1).

    Replaces the pool of the Pallas encoder (fused_encoder.py:_kernel
    l.191-201). Bound by bytes; invalid rows are never read, so a pad
    window gives exactly 0. One block per window.
    """
    if not x.is_cuda:
        return masked_mean_pool_plain(x, tok_len)
    _require(x, "x", torch.bfloat16, 3)
    _require(tok_len, "tok_len", torch.int32, 1)
    n, length, e = x.shape
    if e % 8 or tok_len.shape[0] != n:
        raise ValueError("E must be a multiple of 8 and tok_len [N]")
    out = torch.empty((n, e), dtype=torch.bfloat16, device=x.device)
    if n:
        _launch("masked_mean_pool", "rowwise.cu", "vf_masked_mean_pool", x.data_ptr(),
                tok_len.data_ptr(), out.data_ptr(), n, length, e, _stream(x))
    return out


def masked_mean_pool_bwd_plain(dpool, tok_len, length):
    valid = torch.arange(length, device=dpool.device)[None, :] < tok_len[:, None]
    denom = tok_len.clamp(min=1).float()[:, None]
    dx = torch.where(valid[:, :, None], (dpool.float() / denom)[:, None, :], 0.0)
    return dx.to(dpool.dtype)


def masked_mean_pool_bwd(dpool: torch.Tensor, tok_len: torch.Tensor,
                         length: int) -> torch.Tensor:
    """[N, E] pooled cotangent -> [N, L, E] bf16: dpool / max(len, 1) on the
    first tok_len rows of each window and exactly 0 on the rest.

    Replaces the pool backward that seeds the Pallas encoder backward
    (fused_encoder.py:1100-1111). Bound by bytes (the write of [N, L, E]);
    one block per window.
    """
    if not dpool.is_cuda:
        return masked_mean_pool_bwd_plain(dpool, tok_len, length)
    _require(dpool, "dpool", torch.bfloat16, 2)
    _require(tok_len, "tok_len", torch.int32, 1)
    n, e = dpool.shape
    if e % 8 or tok_len.shape[0] != n:
        raise ValueError("E must be a multiple of 8 and tok_len [N]")
    dx = torch.empty((n, length, e), dtype=torch.bfloat16, device=dpool.device)
    if n and length:
        _launch("masked_mean_pool_bwd", "rowwise.cu", "vf_masked_mean_pool_bwd",
                dpool.data_ptr(), tok_len.data_ptr(), dx.data_ptr(), n, length, e,
                _stream(dpool))
    return dx


def colsum_plain(x):
    return x.float().sum(0)


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of [rows, N] (bf16 or f32) -> [N] f32: the bias
    gradients of the Pallas backward kernels, which carry them in VMEM
    across a sequential grid. Bound by bytes; per-block column partials over
    row splits, then a second pass sums them (deterministic).
    """
    if not x.is_cuda:
        return colsum_plain(x)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("colsum takes bf16 or f32")
    _require(x, "x", x.dtype, 2)
    rows, n = x.shape
    if n % 8:
        raise ValueError("N must be a multiple of 8")
    out = torch.zeros(n, dtype=torch.float32, device=x.device)
    if rows:
        splits = _splits(rows, n)
        part = torch.empty((splits, n), dtype=torch.float32, device=x.device)
        _launch("colsum", "rowwise.cu", "vf_colsum", x.data_ptr(), out.data_ptr(),
                part.data_ptr(), rows, n, splits, int(x.dtype == torch.float32), _stream(x))
    return out


# ---------------------------------------------------------------------------
# The capability probes (scripts/mosaic_capability_probe.py)
# ---------------------------------------------------------------------------

PROBE_WIDTH, PROBE_HEAD, PROBE_HEADS = 192, 48, 4
PROBE_MM_ROWS, PROBE_MM_OUT = 32, 16


def _probe_input(x: torch.Tensor, dtype: torch.dtype, rows: int | None = None) -> None:
    _require(x, "x", dtype, 2)
    if x.shape[1] != PROBE_WIDTH or (rows is not None and x.shape[0] != rows):
        raise ValueError(f"x must be [{rows or 'rows'}, {PROBE_WIDTH}], got {tuple(x.shape)}")


def probe_48slice_plain(x):
    scale = torch.arange(1, PROBE_HEADS + 1, dtype=x.dtype, device=x.device)
    return x * scale.repeat_interleave(PROBE_HEAD)


def probe_48slice(x: torch.Tensor) -> torch.Tensor:
    """out[:, 48h:48h+48] = x[:, 48h:48h+48] * (h + 1) for h < 4, x [rows,
    192] f32: lane slices at 48-element offsets.

    Replaces ``probe_48slice`` (scripts/mosaic_capability_probe.py:29). One
    block, 16-byte loads at 192-byte head offsets; bound by launch latency."""
    if not x.is_cuda:
        return probe_48slice_plain(x)
    _probe_input(x, torch.float32)
    out = torch.empty_like(x)
    _launch("probe_48slice", "probes.cu", "vf_probe_48slice", x.data_ptr(), out.data_ptr(),
            x.shape[0], _stream(x))
    return out


def probe_3dreshape_plain(x):
    h = x.view(-1, PROBE_HEADS, PROBE_HEAD)
    return ((h[:, 0] + h[:, 1]) + h[:, 2]) + h[:, 3]


def probe_3dreshape(x: torch.Tensor) -> torch.Tensor:
    """x [rows, 192] f32 -> x.reshape(rows, 4, 48).sum(1), summed in head
    order: a lane-splitting reshape.

    Replaces ``probe_3dreshape`` (scripts/mosaic_capability_probe.py:49).
    One block, 16-byte loads; bound by launch latency."""
    if not x.is_cuda:
        return probe_3dreshape_plain(x)
    _probe_input(x, torch.float32)
    out = torch.empty((x.shape[0], PROBE_HEAD), dtype=x.dtype, device=x.device)
    _launch("probe_3dreshape", "probes.cu", "vf_probe_3dreshape", x.data_ptr(), out.data_ptr(),
            x.shape[0], _stream(x))
    return out


def probe_48slice_bf16_matmul_plain(x):
    heads = []
    for h in range(PROBE_HEADS):
        q = x[:, h * PROBE_HEAD:(h + 1) * PROBE_HEAD].float()
        heads.append((q @ q.t())[:, :PROBE_MM_OUT])
    return torch.cat(heads, dim=1).to(x.dtype)


def probe_48slice_bf16_matmul(x: torch.Tensor) -> torch.Tensor:
    """x [32, 192] bf16 -> [32, 64] bf16: per head h < 4, s = q_h q_h^T
    with q_h = x[:, 48h:48h+48] (f32 accumulation), out[:, 16h:16h+16] =
    bf16(s[:, :16]): 48-wide head slices feeding a product.

    Replaces ``probe_48slice_bf16_matmul`` (scripts/mosaic_capability_probe
    .py:79). The smallest ``wgmma`` program: one warpgroup, q_h zero-padded
    to 64 rows in a 128-byte-swizzled shared-memory tile that is both A and
    (K-major) B, three m64n32k16 steps; bound by launch latency."""
    if not x.is_cuda:
        return probe_48slice_bf16_matmul_plain(x)
    _probe_input(x, torch.bfloat16, PROBE_MM_ROWS)
    out = torch.empty((PROBE_MM_ROWS, PROBE_HEADS * PROBE_MM_OUT), dtype=x.dtype,
                      device=x.device)
    _launch("probe_48slice_bf16_matmul", "probes.cu", "vf_probe_48slice_bf16_matmul",
            x.data_ptr(), out.data_ptr(), _stream(x))
    return out


class Ops(NamedTuple):
    """The chains' operations: the kernel wrappers or their plain versions."""

    gemm: Callable
    gemm_geglu: Callable
    gemm_dgrad: Callable
    gemm_wgrad: Callable
    attention: Callable
    attention_bwd: Callable
    layernorm: Callable
    layernorm_bwd: Callable
    geglu: Callable
    geglu_bwd: Callable
    masked_mean_pool: Callable
    masked_mean_pool_bwd: Callable
    colsum: Callable


KERNELS = Ops(gemm, gemm_geglu, gemm_dgrad, gemm_wgrad, attention, attention_bwd, layernorm,
              layernorm_bwd, geglu, geglu_bwd, masked_mean_pool, masked_mean_pool_bwd, colsum)
PLAIN = Ops(gemm_plain, gemm_geglu_plain, gemm_dgrad_plain, gemm_wgrad_plain, attention_plain,
            attention_bwd_plain, layernorm_plain, layernorm_bwd_plain, geglu_plain,
            geglu_bwd_plain, masked_mean_pool_plain, masked_mean_pool_bwd_plain, colsum_plain)


def ops_for(t: torch.Tensor) -> Ops:
    """The kernels for a CUDA tensor, the plain versions for a CPU one."""
    return KERNELS if t.is_cuda else PLAIN
