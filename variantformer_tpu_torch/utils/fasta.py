"""FAI-indexed FASTA reader (plain or BGZF-compressed).

A copy of ``variantformer_tpu/utils/fasta.py``: the .fai index maps
each contig to (length, byte offset, bases per line, bytes per line); random
access is a seek + newline-stripping read. For .gz inputs the byte-level
access goes through the BGZF reader. Builds .fai (and .gzi) when absent.
"""

from __future__ import annotations

import os
from pathlib import Path

from variantformer_tpu_torch.utils.bgzf import BGZFReader, is_bgzf


class FaiRecord:
    __slots__ = ("name", "length", "offset", "linebases", "linewidth")

    def __init__(self, name, length, offset, linebases, linewidth):
        self.name = name
        self.length = int(length)
        self.offset = int(offset)
        self.linebases = int(linebases)
        self.linewidth = int(linewidth)


class FastaReader:
    def __init__(self, path: str | Path):
        self.path = str(path)
        self._bgzf: BGZFReader | None = None
        if self.path.endswith(".gz") or (
            os.path.exists(self.path) and is_bgzf(self.path)
        ):
            self._bgzf = BGZFReader(self.path)
            self._fh = None
            self._fd = None
        else:
            self._fh = open(self.path, "rb")
            self._fd = self._fh.fileno()
        self.index: dict[str, FaiRecord] = {}
        self._load_or_build_fai()

    # -- index ------------------------------------------------------------
    def _fai_path(self) -> str:
        return self.path + ".fai"

    def _load_or_build_fai(self):
        fai = self._fai_path()
        if os.path.exists(fai):
            with open(fai) as fh:
                for line in fh:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 5:
                        rec = FaiRecord(parts[0], *parts[1:5])
                        self.index[rec.name] = rec
            return
        self._build_fai()
        try:
            with open(fai, "w") as fh:
                for rec in self.index.values():
                    fh.write(
                        f"{rec.name}\t{rec.length}\t{rec.offset}"
                        f"\t{rec.linebases}\t{rec.linewidth}\n"
                    )
        except OSError:
            pass  # read-only location; keep the in-memory index

    def _iter_raw_lines(self):
        if self._bgzf is not None:
            offset = 0
            for line in self._bgzf.stream_lines():
                yield offset, line
                offset += len(line) + 1
        else:
            self._fh.seek(0)
            offset = 0
            for line in self._fh:
                yield offset, line.rstrip(b"\n")
                offset += len(line)

    def _build_fai(self):
        name = None
        length = 0
        seq_offset = 0
        linebases = 0
        linewidth = 0
        first_line = True

        def flush():
            if name is not None:
                self.index[name] = FaiRecord(
                    name, length, seq_offset, linebases, linewidth
                )

        for offset, line in self._iter_raw_lines():
            if line.startswith(b">"):
                flush()
                name = line[1:].split()[0].decode()
                length = 0
                seq_offset = offset + len(line) + 1
                first_line = True
            elif line and name is not None:
                if first_line:
                    linebases = len(line)
                    linewidth = len(line) + 1
                    first_line = False
                length += len(line)
        flush()

    # -- access -----------------------------------------------------------
    def _read_bytes(self, offset: int, length: int) -> bytes:
        if self._bgzf is not None:
            return self._bgzf.read_at(offset, length)
        # os.pread: atomic positioned read — no shared-file-position race, so
        # one reader safely serves concurrent builder threads.
        return os.pread(self._fd, length, offset)

    def fetch(self, chrom: str, start: int, end: int) -> str:
        """Fetch [start, end) 0-based; clamps to contig bounds."""
        rec = self.index[chrom]
        start = max(0, start)
        end = min(end, rec.length)
        if end <= start:
            return ""
        line_start = start // rec.linebases
        byte_start = rec.offset + line_start * rec.linewidth + start % rec.linebases
        line_end = (end - 1) // rec.linebases
        byte_end = rec.offset + line_end * rec.linewidth + (end - 1) % rec.linebases + 1
        raw = self._read_bytes(byte_start, byte_end - byte_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode()

    def close(self):
        if self._fh is not None:
            self._fh.close()
        if self._bgzf is not None:
            self._bgzf.close()
