"""ctypes bridge to the port's C++ host engines, built at first use.

``native/bpe.cpp`` (BPE merges over token ids) and ``native/consensus.cpp``
(diploid IUPAC consensus, reverse complement) are the port's copies of the
JAX package's engines, with the same C interface. Each is compiled by g++
into a shared library under ``_build/native-<hash>/``, the hash covering the
sources, the compiler and its flags. A build writes a name of its own (the
process id) and renames it into place with ``os.replace``, so processes that
build at once each end with a whole library, and only the final name is ever
loaded. The flags hold no ``-march=native``: a library does not depend on the
machine that built it.

The Python engines (``utils/bpe.py``, ``utils/vcf.py``) are the plain
versions, chosen only by an explicit ``use_native=False``. A failed build or
load raises and says so; nothing carries on quietly in Python.

``CALLS`` counts the calls into each native entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from itertools import chain
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = NATIVE_DIR.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
SOURCES = {"bpe": "bpe.cpp", "seq": "consensus.cpp"}
CALLS = {"bpe_encode": 0, "bpe_encode_batch": 0, "consensus": 0}

_lock = threading.Lock()
_calls_lock = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C")
_SIGNATURES = {
    "bpe": {
        "vfx_bpe_create": (ctypes.c_void_p, [ctypes.c_int32, _I32, _I32, _I32, _I32]),
        "vfx_bpe_destroy": (None, [ctypes.c_void_p]),
        "vfx_bpe_encode": (ctypes.c_int32, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, _I32, _I32, _I32,
            ctypes.c_int32,
        ]),
        "vfx_bpe_encode_batch": (ctypes.c_int64, [
            ctypes.c_void_p, ctypes.c_char_p, _I64, ctypes.c_int32, _I32, _I32,
            ctypes.c_int64,
        ]),
    },
    "seq": {
        "vfx_consensus": (ctypes.c_int64, [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _I64,
            ctypes.c_char_p, _I64, _I64, _I64, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]),
        "vfx_reverse_complement": (None, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]),
    },
}


def build_dir() -> Path:
    """``BUILD_ROOT/native-<hash of the sources, compiler and flags>``."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    for src in sorted(SOURCES.values()):
        h.update(src.encode())
        h.update((NATIVE_DIR / src).read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def build(name: str) -> Path:
    """The shared library of ``SOURCES[name]``, compiled now if it is not
    built yet. Raises ``RuntimeError`` when the compiler cannot run or fails."""
    lib = build_dir() / f"libvfx{name}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / SOURCES[name])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native build of {SOURCES[name]} could not run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build of {SOURCES[name]} failed (rc {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _LIBS:
            try:
                lib = ctypes.CDLL(str(build(name)))
            except (RuntimeError, OSError) as exc:
                raise RuntimeError(
                    f"the native {name} engine is unavailable ({exc}); pass "
                    "use_native=False to run the Python engine"
                ) from exc
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return _LIBS[name]


def _count(name: str) -> None:
    with _calls_lock:  # the builders call from several threads
        CALLS[name] += 1


def get_library() -> ctypes.CDLL:
    """The BPE library (``native/bpe.cpp``), built and loaded at first call."""
    return _load("bpe")


def get_seq_library() -> ctypes.CDLL:
    """The sequence library (``native/consensus.cpp``), built and loaded at
    first call."""
    return _load("seq")


def native_consensus(seq: str, region_start: int, variants, snps_only: bool) -> tuple[str, int]:
    """C++ consensus over [region_start, region_start+len(seq)); ``variants``
    are ``VcfVariant``s sorted by position. Returns (sequence, n_applied)."""
    lib = get_seq_library()
    variants = list(variants)
    n = len(variants)
    pos = np.asarray([v.pos for v in variants], np.int64)
    refs = [v.ref.encode() for v in variants]
    a0s = [v.alleles[0].encode() for v in variants]
    a1s = [v.alleles[1].encode() for v in variants]
    # One blob of refs, then first alleles, then second alleles; field k of
    # variant i spans offs[k*n + i] .. offs[k*n + i + 1].
    offs = np.zeros(3 * n + 1, np.int64)
    np.cumsum([len(b) for b in chain(refs, a0s, a1s)], out=offs[1:])
    blob = b"".join(chain(refs, a0s, a1s))
    seq_b = seq.encode()
    max_out = len(seq_b) + int(offs[3 * n] - offs[n]) + 16
    out = ctypes.create_string_buffer(max_out)
    applied = ctypes.c_int32(0)
    written = lib.vfx_consensus(
        seq_b, len(seq_b), region_start, n, pos, blob, offs[: n + 1], offs[n: 2 * n + 1],
        offs[2 * n:], int(snps_only), out, max_out, ctypes.byref(applied),
    )
    _count("consensus")
    if written < 0:
        raise RuntimeError(f"vfx_consensus failed (code {written})")
    return out.raw[:written].decode(), applied.value


class NativeBPE:
    """The C++ BPE encoder over id-space merges (lowest rank first, the
    leftmost occurrence first within a rank: the Python engine's order)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self._lib = get_library()
        n = len(merges)
        left = np.empty(n, np.int32)
        right = np.empty(n, np.int32)
        result = np.empty(n, np.int32)
        for i, (a, b) in enumerate(merges):
            left[i], right[i], result[i] = vocab[a], vocab[b], vocab[a + b]
        char_to_id = np.full(256, -1, np.int32)
        for token, tid in vocab.items():
            if len(token) == 1:
                char_to_id[ord(token)] = tid
        self._handle = self._lib.vfx_bpe_create(n, left, right, result, char_to_id)
        if not self._handle:
            raise RuntimeError("vfx_bpe_create failed")

    def encode_word_ids_offsets(self, word: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, starts, ends) int32 of one normalised subsequence: token i
        covers the word's characters starts[i] .. ends[i] - 1."""
        n = len(word)
        if n == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        out_ids = np.empty(n, np.int32)
        out_starts = np.empty(n, np.int32)
        out_ends = np.empty(n, np.int32)
        count = self._lib.vfx_bpe_encode(
            self._handle, word.encode("ascii"), n, out_ids, out_starts, out_ends, n
        )
        _count("bpe_encode")
        if count < 0:
            raise ValueError(f"native BPE encode failed (code {count})")
        return out_ids[:count], out_starts[:count], out_ends[:count]

    def encode_word_ids(self, word: str) -> np.ndarray:
        """Token ids (int32) of one normalised subsequence."""
        return self.encode_word_ids_offsets(word)[0]

    def encode_word(self, word: str) -> tuple[list[int], list[tuple[int, int]]]:
        """(ids, [(start, end), ...]) of one normalised subsequence, as lists:
        the Python engine's ``_encode_word_py`` form."""
        ids, starts, ends = self.encode_word_ids_offsets(word)
        return ids.tolist(), list(zip(starts.tolist(), ends.tolist()))

    def encode_words_ids(self, words: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Encode many words in ONE native call (one release of the GIL
        instead of one a word, which convoy across builder threads).
        Returns (flat ids, per-word token counts)."""
        if not words:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        text = "".join(words).encode("ascii")
        bounds = np.zeros(len(words) + 1, np.int64)
        np.cumsum([len(w) for w in words], out=bounds[1:])
        out_ids = np.empty(len(text), np.int32)
        out_counts = np.empty(len(words), np.int32)
        total = self._lib.vfx_bpe_encode_batch(
            self._handle, text, bounds, len(words), out_ids, out_counts, len(text)
        )
        _count("bpe_encode_batch")
        if total < 0:
            raise ValueError(f"native BPE encode failed (code {total})")
        return out_ids[:total], out_counts

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.vfx_bpe_destroy(handle)
