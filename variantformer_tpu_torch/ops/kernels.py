"""The shared CUDA kernels, their build, and their wrappers.

Both whole-stack Pallas kernels of the JAX package
(``variantformer_tpu/ops/fused_encoder.py:_kernel`` and
``variantformer_tpu/ops/fused_modulator.py:_kernel``) become chains of five
kernels written by hand for Hopper (``csrc/``):

  ``gemm_bf16``         [M, K] @ [K, N] bf16 tiles on the tensor cores
                        (``nvcuda::wmma``), f32 accumulation, bias and
                        residual epilogue, bf16 out;
  ``attention``         masked (ALiBi) softmax attention, one block per
                        (64 queries, head, batch row), keys in tiles of 64
                        with an online softmax;
  ``layernorm``         f32 statistics, bf16 out;
  ``geglu``             value * gelu_erf(gate);
  ``masked_mean_pool``  mean over the valid rows of each window.

Build: every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface, at first
use, under ``_build/<hash of the sources>/``; the libraries are loaded with
ctypes. Each C entry point returns ``cudaGetLastError()`` and the wrapper
raises when it is not 0.

Each wrapper takes its kernel's plain PyTorch version when the tensor it was
given lies on the CPU, and on a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts the launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from variantformer_tpu_torch.models.core import geglu as geglu_plain
from variantformer_tpu_torch.models.core import layer_norm
from variantformer_tpu_torch.ops.attention import attend

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("gemm.cu", "attention.cu", "rowwise.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "gemm_bf16": 0,
    "attention": 0,
    "layernorm": 0,
    "geglu": 0,
    "masked_mean_pool": 0,
    "fused_window_encoder": 0,
    "fused_gene_modulator": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "gemm.cu": {"vf_gemm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "attention.cu": {
        "vf_attention": [
            _P, _P, _P, _P,          # q, k, v, out
            _L, _L, _L, _L, _L, _L,  # batch and row strides of q, k/v, out
            _I, _I, _I, _I, _I,      # B, H, Sq, Sk, head_dim
            _P, _I, _I,              # kv_len, len_div, kv_div
            _P, _F, _P,              # slopes, scale, stream
        ]
    },
    "rowwise.cu": {
        "vf_layernorm": [_P, _P, _P, _P, _I, _I, _F, _P],
        "vf_geglu": [_P, _P, _I, _I, _P],
        "vf_masked_mean_pool": [_P, _P, _P, _I, _I, _I, _P],
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


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


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


# ---------------------------------------------------------------------------
# gemm_bf16
# ---------------------------------------------------------------------------


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
    (M >= 1536 rows, K, N in 512..4608); the kernel stages 128x128x32 tiles
    through a 3-stage cp.async ring in shared memory and runs bf16 wmma with
    f32 accumulators. The epilogue rounds like the JAX package's ``linear``:
    bf16(acc), + bias, then + residual, each rounded to bf16.
    K and N must be multiples of 8; M is arbitrary (ragged edge masked).
    """
    if not a.is_cuda:
        return gemm_plain(a, w, bias, residual)
    _require(a, "a", torch.bfloat16, 2)
    _require(w, "w", torch.bfloat16, 2)
    m, k = a.shape
    if w.shape[0] != k:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8")
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
    rc = _fn("gemm.cu", "vf_gemm_bf16")(
        a.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), m, n, k, _stream(a),
    )
    _check_rc(rc, "gemm_bf16")
    LAUNCHES["gemm_bf16"] += 1
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_plain(q, k, v, kv_len, slopes, scale, num_heads, kv_div=1, len_div=1):
    b, sq, hd = q.shape
    d = hd // num_heads
    lens = kv_len.repeat_interleave(len_div)
    k = k.repeat_interleave(kv_div, dim=0)
    v = v.repeat_interleave(kv_div, dim=0)
    sk = k.shape[1]
    out = attend(
        q.reshape(b, sq, num_heads, d), k.reshape(b, sk, num_heads, d),
        v.reshape(b, sk, num_heads, d), lens, slopes, scale,
    )
    return out.reshape(b, sq, hd)


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
) -> torch.Tensor:
    """Masked softmax attention; returns [B, Sq, H*D] (heads concatenated).

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
        return attention_plain(q, k, v, kv_len, slopes, scale, num_heads, kv_div, len_div)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require(t, name, torch.bfloat16, 3, contiguous=False)
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
            raise ValueError(f"{name} needs unit last stride and strides % 8 == 0")
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
    out = torch.empty((b, sq, hd), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("attention needs at least one key")
    rc = _fn("attention.cu", "vf_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        out.stride(0), out.stride(1),
        b, num_heads, sq, sk, head_dim,
        kv_len.data_ptr(), len_div, kv_div,
        slopes.data_ptr() if slopes is not None else None, scale, _stream(q),
    )
    _check_rc(rc, "attention")
    LAUNCHES["attention"] += 1
    return out


# ---------------------------------------------------------------------------
# layernorm, geglu, masked_mean_pool
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
    if rows == 0:
        return out
    rc = _fn("rowwise.cu", "vf_layernorm")(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, e, eps, _stream(x),
    )
    _check_rc(rc, "layernorm")
    LAUNCHES["layernorm"] += 1
    return out


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
    if rows == 0:
        return out
    rc = _fn("rowwise.cu", "vf_geglu")(
        f.data_ptr(), out.data_ptr(), rows, width // 2, _stream(f)
    )
    _check_rc(rc, "geglu")
    LAUNCHES["geglu"] += 1
    return out


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
    if n == 0:
        return out
    rc = _fn("rowwise.cu", "vf_masked_mean_pool")(
        x.data_ptr(), tok_len.data_ptr(), out.data_ptr(), n, length, e, _stream(x)
    )
    _check_rc(rc, "masked_mean_pool")
    LAUNCHES["masked_mean_pool"] += 1
    return out
