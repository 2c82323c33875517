"""BGZF (blocked gzip) reader with random access, and BGZF writers.

The port's copy of ``variantformer_tpu/utils/bgzf.py``. BGZF files are
concatenated gzip members of <=64 KiB
uncompressed payload each, with the compressed block size recorded in a BC
extra field — enabling random access through a (compressed offset,
uncompressed offset) block index. Supports the .gzi index format written by
``bgzip -r`` and builds the index by scanning when absent. The virtual-offset
readers (``compressed_offset << 16 | offset_in_block``) serve tabix queries
(``utils/tabix.py``).
"""

from __future__ import annotations

import bisect
import io
import os
import struct
import threading
import zlib
from pathlib import Path

_BGZF_MAGIC = b"\x1f\x8b\x08\x04"
_MAX_BLOCK = 65536  # BSIZE is u16, total block size = BSIZE+1 <= 65536
_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _compress_block(payload: bytes) -> bytes:
    """One BGZF block: gzip member with BC extra field holding BSIZE-1."""
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + data + crc(4) + isize(4)
    header = _BGZF_MAGIC + b"\x00" * 6 + struct.pack(
        "<HBBHH", 6, 0x42, 0x43, 2, bsize - 1
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + cdata + footer


def write_bgzf(path: str, data: bytes, block_size: int = 65280):
    """Write ``data`` as a BGZF file (bgzip-compatible), with EOF marker."""
    with open(path, "wb") as fh:
        for off in range(0, len(data), block_size):
            fh.write(_compress_block(data[off : off + block_size]))
        fh.write(_EOF_BLOCK)


def write_bgzf_lines(path: str, lines, block_size: int = 65280):
    """Write an iterable of lines (str or bytes, no trailing newline) as a
    BGZF file without materializing the payload — O(block_size) memory, so
    multi-million-record VCF merges can stream straight to disk."""
    buf = bytearray()
    with open(path, "wb") as fh:
        for line in lines:
            if isinstance(line, str):
                line = line.encode()
            buf += line
            buf += b"\n"
            while len(buf) >= block_size:
                fh.write(_compress_block(bytes(buf[:block_size])))
                del buf[:block_size]
        if buf:
            fh.write(_compress_block(bytes(buf)))
        fh.write(_EOF_BLOCK)


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(18)
    if len(head) < 18 or head[:4] != _BGZF_MAGIC:
        return False
    xlen = struct.unpack("<H", head[10:12])[0]
    return xlen >= 6


def _block_size_from_header(buf: bytes) -> int:
    """Total compressed block size (BSIZE+1) from a block's first bytes."""
    if buf[:4] != _BGZF_MAGIC:
        raise ValueError("not a BGZF block")
    xlen = struct.unpack_from("<H", buf, 10)[0]
    extra = buf[12 : 12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2 = extra[pos], extra[pos + 1]
        slen = struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return struct.unpack_from("<H", extra, pos + 4)[0] + 1
        pos += 4 + slen
    raise ValueError("BGZF block missing BC extra field")


def _read_block_header(fh) -> int | None:
    """Returns the total compressed block size (BSIZE+1), or None at EOF."""
    header = fh.read(12)
    if len(header) < 12:
        return None
    xlen = struct.unpack("<H", header[10:12])[0]
    return _block_size_from_header(header + fh.read(xlen))


class BGZFReader:
    """Random-access reader over a BGZF file.

    Thread-safe for reads: block fetches use ``os.pread`` (atomic positioned
    reads, no shared file-position state) and the decompressed-block cache is
    per-thread, so one reader can back many builder workers concurrently."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        self._fd = self._fh.fileno()
        self._coffs: list[int] = []   # compressed offset per block
        self._uoffs: list[int] = []   # uncompressed offset per block
        self._load_or_build_index()
        self._local = threading.local()

    # -- index ------------------------------------------------------------
    def _load_or_build_index(self):
        gzi = Path(self.path + ".gzi")
        if gzi.exists():
            raw = gzi.read_bytes()
            (n,) = struct.unpack_from("<Q", raw, 0)
            coffs, uoffs = [0], [0]
            for i in range(n):
                c, u = struct.unpack_from("<QQ", raw, 8 + 16 * i)
                coffs.append(c)
                uoffs.append(u)
            self._coffs, self._uoffs = coffs, uoffs
            return
        # Scan the file once to build the block index.
        fh = self._fh
        fh.seek(0)
        coff = 0
        uoff = 0
        coffs, uoffs = [], []
        while True:
            fh.seek(coff)
            bsize = _read_block_header(fh)
            if bsize is None:
                break
            fh.seek(coff + bsize - 8)
            tail = fh.read(8)
            if len(tail) < 8:
                break
            isize = struct.unpack("<I", tail[4:8])[0]
            coffs.append(coff)
            uoffs.append(uoff)
            coff += bsize
            uoff += isize
        self._coffs, self._uoffs = coffs, uoffs

    def save_index(self, path: str | None = None):
        """Write a .gzi-compatible index for faster reopening."""
        path = path or self.path + ".gzi"
        entries = list(zip(self._coffs, self._uoffs))[1:]
        with open(path, "wb") as fh:
            fh.write(struct.pack("<Q", len(entries)))
            for c, u in entries:
                fh.write(struct.pack("<QQ", c, u))

    # -- block access -----------------------------------------------------
    def _read_block(self, idx: int) -> bytes:
        cache = getattr(self._local, "cache", None)
        if cache is not None and cache[0] == idx:
            return cache[1]
        coff = self._coffs[idx]
        # One positioned read of the max block size covers any block; slicing
        # to the header-declared size yields exactly one gzip member.
        raw = os.pread(self._fd, _MAX_BLOCK, coff)
        bsize = _block_size_from_header(raw)
        data = zlib.decompress(raw[:bsize], wbits=31)
        self._local.cache = (idx, data)
        return data

    def read_at(self, uoffset: int, length: int) -> bytes:
        """Read ``length`` bytes at uncompressed offset ``uoffset``."""
        out = io.BytesIO()
        idx = bisect.bisect_right(self._uoffs, uoffset) - 1
        remaining = length
        pos = uoffset
        while remaining > 0 and idx < len(self._coffs):
            data = self._read_block(idx)
            start = pos - self._uoffs[idx]
            if start >= len(data):
                break
            chunk = data[start : start + remaining]
            out.write(chunk)
            remaining -= len(chunk)
            pos += len(chunk)
            idx += 1
        return out.getvalue()

    def stream_lines(self):
        """Iterate decompressed lines (for whole-file parses, e.g. VCF scan)."""
        buf = b""
        for idx in range(len(self._coffs)):
            data = self._read_block(idx)
            buf += data
            *lines, buf = buf.split(b"\n")
            yield from lines
        if buf:
            yield buf

    def stream_lines_with_voffsets(self):
        """Like stream_lines but yields (virtual_offset, line): the BGZF
        virtual offset (compressed_block_offset << 16 | within_block_offset)
        of each line's first byte — the tabix addressing scheme."""
        carry = b""
        carry_voff = 0
        for idx in range(len(self._coffs)):
            data = self._read_block(idx)
            coff = self._coffs[idx]
            pos = 0
            while True:
                nl = data.find(b"\n", pos)
                if nl == -1:
                    rest = data[pos:]
                    if rest:
                        if not carry:
                            carry_voff = (coff << 16) | pos
                        carry += rest
                    break
                if carry:
                    yield carry_voff, carry + data[pos:nl]
                    carry = b""
                else:
                    yield (coff << 16) | pos, data[pos:nl]
                pos = nl + 1
        if carry:
            yield carry_voff, carry

    def read_lines_from_voffset(self, voffset: int):
        """Iterate lines starting at a BGZF virtual offset."""
        coff = voffset >> 16
        within = voffset & 0xFFFF
        idx = bisect.bisect_left(self._coffs, coff)
        if idx >= len(self._coffs) or self._coffs[idx] != coff:
            raise ValueError(f"virtual offset {voffset} not at a block boundary")
        buf = b""
        first = True
        for i in range(idx, len(self._coffs)):
            data = self._read_block(i)
            if first:
                data = data[within:]
                first = False
            buf += data
            *lines, buf = buf.split(b"\n")
            yield from lines
        if buf:
            yield buf

    def close(self):
        self._fh.close()
