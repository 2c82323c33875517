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
                        the output has few tiles);
  ``gemm_dgrad``        dX = dY W^T (+ residual), bf16 out, reading the
                        weight transposed (``nvcuda::wmma``, ``gemm.cu``);
  ``attention``         masked (ALiBi) softmax attention, one block per
                        (64 queries, head, batch row), keys in tiles of 64
                        with an online softmax; optionally each row's
                        log-sum-exp for the backward;
  ``attention_bwd``     its backward: dK/dV per key tile, then dQ per query
                        tile, from P rebuilt with the log-sum-exp;
  ``layernorm``         f32 statistics, bf16 out;
  ``layernorm_bwd``     dx (+ residual cotangents) and f32 dscale/dbias;
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
use, under ``_build/<hash of the sources>/``; the libraries are loaded with
ctypes. Each C entry point returns ``cudaGetLastError()`` and the wrapper
raises when it is not 0.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``, same
signature) when the tensor it was given lies on the CPU, and on a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts the launches of
each wrapper. ``KERNELS`` and ``PLAIN`` bundle the wrappers and the plain
versions for the chains that run on either.
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

from variantformer_tpu_torch.models.core import geglu as geglu_plain
from variantformer_tpu_torch.models.core import layer_norm
from variantformer_tpu_torch.ops.attention import attend, masked_scores

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("gemm_sm90.cu", "gemm.cu", "attention.cu", "attention_bwd.cu", "rowwise.cu",
           "probes.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "gemm_bf16": 0,
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
    "probe_48slice": 0,
    "probe_3dreshape": 0,
    "probe_48slice_bf16_matmul": 0,
}

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
            _P,                      # stream
        ]
    },
    "gemm.cu": {"vf_gemm_dgrad": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "attention.cu": {
        "vf_attention": [
            _P, _P, _P, _P,          # q, k, v, out
            _L, _L, _L, _L, _L, _L,  # batch and row strides of q, k/v, out
            _I, _I, _I, _I, _I,      # B, H, Sq, Sk, head_dim
            _P, _I, _I,              # kv_len, len_div, kv_div
            _P, _F, _P, _P, _P,      # slopes, scale, lse, out32, stream
        ]
    },
    "attention_bwd.cu": {
        "vf_attention_bwd": [
            _P, _P, _P, _P, _P,      # q, k, v, o, d_o
            _P, _P,                  # lse, delta (scratch)
            _P, _P, _P,              # dq, dk, dv
            _L, _L, _L, _L, _L, _L,  # strides of q, k/v, o
            _L, _L, _L, _L, _L, _L,  # strides of d_o, dq, dk/dv
            _I, _I, _I, _I, _I,      # B, H, Sq, Sk, head_dim
            _P, _I, _I,              # kv_len, len_div, kv_div
            _P, _F, _I, _P,          # slopes, scale, dkv_f32, stream
        ]
    },
    "rowwise.cu": {
        "vf_layernorm": [_P, _P, _P, _P, _I, _I, _F, _P],
        "vf_geglu": [_P, _P, _I, _I, _P],
        "vf_masked_mean_pool": [_P, _P, _P, _I, _I, _I, _P],
        "vf_layernorm_bwd": [_P] * 10 + [_I, _I, _F, _I, _P],
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
    plan = gemm_plan(m, n, k, split=layout == 1, sms=_sm_count(a.device.index or 0))
    _launch(name, "gemm_sm90.cu", "vf_gemm_sm90", a.data_ptr(), b.data_ptr(), _ptr(bias),
            _ptr(res), out.data_ptr(), m, n, k, layout, plan.splits, plan.per_split,
            plan.blocks, plan.group_m, _stream(a))


def gemm_plain(a, w, bias=None, residual=None):
    """out = a @ w (+ bias) (+ residual); each sum rounded to a's dtype."""
    out = torch.matmul(a, w)
    if bias is not None:
        out = out + bias
    if residual is not None:
        out = out + residual
    return out


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
    if residual is not None:
        _require(residual, "residual", torch.bfloat16, 2)
        if tuple(residual.shape) != (m, n):
            raise ValueError("residual must be [M, N]")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    if m == 0:
        return out
    _gemm_sm90("gemm_bf16", a, w, bias, residual, out, m, n, k, 0)
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
    _bwd0_kernel). The GEMM kernel reads W in its stored layout and stages
    it transposed (a col_major wmma fragment), so W^T is never made. Bound
    by tensor-core operations. N and K must be multiples of 8.
    """
    if not dy.is_cuda:
        return gemm_dgrad_plain(dy, w, residual)
    _require(dy, "dy", torch.bfloat16, 2)
    _require(w, "w", torch.bfloat16, 2)
    m, n = dy.shape
    k = w.shape[0]
    if w.shape[1] != n:
        raise ValueError(f"shape mismatch {tuple(dy.shape)} @ {tuple(w.shape)}^T")
    if k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8")
    if residual is not None:
        _require(residual, "residual", torch.bfloat16, 2)
        if tuple(residual.shape) != (m, k):
            raise ValueError("residual must be [M, K]")
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    if m == 0:
        return out
    _launch("gemm_dgrad", "gemm.cu", "vf_gemm_dgrad", dy.data_ptr(), w.data_ptr(),
            _ptr(residual), out.data_ptr(), m, k, n, _stream(dy))
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
    than the card has SMs, the rows split across units whose partial sums
    meet in f32 atomics (``gemm_plan``). Bound by tensor-core operations.
    K and N must be multiples of 8.
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
    fused_modulator.py:_kernel l.189-247). At the main-path shapes
    (S <= 384, head_dim 48 or 64) it is bound by tensor-core operations on
    paper, in practice by the f32 softmax between the two products; the
    kernel keeps a 64-query tile's scores, probabilities and output in
    shared memory and walks the keys in tiles of 64 with an online softmax,
    stopping at the last valid key (a row with no valid key walks them all
    with the finite MASK_VALUE, as the plain version does).
    """
    if not q.is_cuda:
        return attention_plain(q, k, v, kv_len, slopes, scale, num_heads, kv_div, len_div,
                               for_backward)
    b, sq, hd, sk, head_dim = _check_attention(q, k, v, kv_len, slopes, num_heads, kv_div,
                                               len_div)
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    lse = out32 = None
    if for_backward:
        lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
        out32 = torch.empty((b, sq, hd), dtype=torch.float32, device=q.device)
    if b and sq:
        _launch(
            "attention", "attention.cu", "vf_attention",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            out.stride(0), out.stride(1),
            b, num_heads, sq, sk, head_dim,
            kv_len.data_ptr(), len_div, kv_div,
            _ptr(slopes), scale, _ptr(lse), _ptr(out32), _stream(q),
        )
    return (out, lse, out32) if for_backward else out


def _check_attention(q, k, v, kv_len, slopes, num_heads, kv_div, len_div):
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require_rows(t, name, torch.bfloat16)
    b, sq, hd = q.shape
    bk, sk, _ = k.shape
    if hd % num_heads or k.shape[2] != hd or tuple(v.shape) != tuple(k.shape):
        raise ValueError("q, k, v widths disagree")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    head_dim = hd // num_heads
    if head_dim not in (48, 64):
        raise ValueError(f"head_dim {head_dim} not built (48, 64)")
    if b > 65535 or num_heads > 65535:
        raise ValueError("B and H must fit the grid (<= 65535)")
    if bk * kv_div != b or b % len_div:
        raise ValueError("B must equal (K/V batch) * kv_div and divide by len_div")
    _require(kv_len, "kv_len", torch.int32, 1)
    if kv_len.shape[0] != b // len_div:
        raise ValueError("kv_len must be [B // len_div]")
    if slopes is not None:
        _require(slopes, "slopes", torch.float32, 1)
        if slopes.shape[0] != num_heads:
            raise ValueError("slopes must be [H]")
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
):
    """Backward of ``attention``: returns (dq, dk, dv), written into the
    buffers given (dk, dv default to f32, dq to bf16).

    Replaces the attention backward of the Pallas recompute kernels
    (fused_encoder.py:_bwd_kernel l.664-711, fused_modulator.py:_bwd1_kernel
    l.769-803, _bwd0_kernel l.912-958). Three launches in one C call: delta
    = rowsum(dO * O); a dK/dV pass, one block per (64 keys, head, K/V row)
    walking every query row that shares the K/V row (so the cross-attention
    cotangent is summed over the tissues in the block, without atomics);
    a dQ pass, one block per (64 queries, head, batch row). P is rebuilt
    from the forward's log-sum-exp. The same conventions as the forward:
    MASK_VALUE rows average V (P = 1/Sk, no score gradient), keys past
    kv_len get exactly 0.
    """
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, o, lse, do, kv_len, slopes, scale, num_heads,
                                   kv_div, len_div, dq, dk, dv)
    b, sq, hd, sk, head_dim = _check_attention(q, k, v, kv_len, slopes, num_heads, kv_div,
                                               len_div)
    for t, name, dtype in ((o, "o", torch.float32), (do, "do", torch.bfloat16)):
        _require_rows(t, name, dtype)
        if tuple(t.shape) != (b, sq, hd):
            raise ValueError(f"{name} must be [B, Sq, H*D]")
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
    delta = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    _launch(
        "attention_bwd", "attention_bwd.cu", "vf_attention_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), o.stride(0), o.stride(1),
        do.stride(0), do.stride(1), dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        b, num_heads, sq, sk, head_dim, kv_len.data_ptr(), len_div, kv_div,
        _ptr(slopes), scale, int(dk.dtype == torch.float32), _stream(q),
    )
    return dq, dk, dv


# ---------------------------------------------------------------------------
# layernorm, geglu, masked_mean_pool, colsum and their backwards
# ---------------------------------------------------------------------------


def layernorm_plain(x, scale, bias, eps=1e-5):
    return layer_norm({"scale": scale, "bias": bias}, x, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of [rows, E]: f32 statistics, bf16 out.

    Replaces ``layer_norm`` inside the Pallas kernels. Bound by bytes (one
    read and one write of the rows); one warp per row with 16-byte loads.
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
        _launch("layernorm", "rowwise.cu", "vf_layernorm", x.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), rows, e, eps, _stream(x))
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


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                  residuals: tuple = (), eps: float = 1e-5):
    """LayerNorm backward over [rows, E]: returns (dx bf16, dscale [E] f32,
    dbias [E] f32), with up to two bf16 [rows, E] residual cotangents added
    to dx in f32 before its one rounding (the ``dnext + dh + dLN1`` sums of
    the Pallas backward kernels).

    Replaces ``_ln_bwd`` inside the Pallas backward kernels
    (fused_encoder.py:493). Bound by bytes. One warp per row recomputes the
    statistics from x and writes dx and (mean, rstd); dscale and dbias are
    per-block column partials over row splits, then summed by a second pass
    (deterministic, no atomics).
    """
    if not x.is_cuda:
        return layernorm_bwd_plain(x, dy, scale, residuals, eps)
    if len(residuals) > 2:
        raise ValueError("at most two residuals")
    _require(x, "x", torch.bfloat16, 2)
    _require(dy, "dy", torch.bfloat16, 2)
    _require(scale, "scale", torch.float32, 1)
    rows, e = x.shape
    if e % 8 or scale.shape[0] != e or tuple(dy.shape) != (rows, e):
        raise ValueError("E must be a multiple of 8; dy and scale must match x")
    for r in residuals:
        _require(r, "residual", torch.bfloat16, 2)
        if tuple(r.shape) != (rows, e):
            raise ValueError("residuals must be [rows, E]")
    res = list(residuals) + [None] * (2 - len(residuals))
    dx = torch.empty_like(x)
    dscale = torch.zeros(e, dtype=torch.float32, device=x.device)
    dbias = torch.zeros(e, dtype=torch.float32, device=x.device)
    if rows:
        splits = _splits(rows, e)
        stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
        part = torch.empty((2, splits, e), dtype=torch.float32, device=x.device)
        _launch("layernorm_bwd", "rowwise.cu", "vf_layernorm_bwd",
                x.data_ptr(), dy.data_ptr(), scale.data_ptr(), _ptr(res[0]), _ptr(res[1]),
                dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), stats.data_ptr(),
                part.data_ptr(), rows, e, eps, splits, _stream(x))
    return dx, dscale, dbias


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


KERNELS = Ops(gemm, gemm_dgrad, gemm_wgrad, attention, attention_bwd, layernorm,
              layernorm_bwd, geglu, geglu_bwd, masked_mean_pool, masked_mean_pool_bwd, colsum)
PLAIN = Ops(gemm_plain, gemm_dgrad_plain, gemm_wgrad_plain, attention_plain,
            attention_bwd_plain, layernorm_plain, layernorm_bwd_plain, geglu_plain,
            geglu_bwd_plain, masked_mean_pool_plain, masked_mean_pool_bwd_plain, colsum_plain)


def ops_for(t: torch.Tensor) -> Ops:
    """The kernels for a CUDA tensor, the plain versions for a CPU one."""
    return KERNELS if t.is_cuda else PLAIN
