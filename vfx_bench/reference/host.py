"""The plain reference of the host pipeline: (FASTA, VCF, CRE map) -> tokens.

Frozen copies, in plain Python and numpy, of the semantics of the port's
consensus, BPE and windowing (``utils/vcf.py`` ``ConsensusEngine``'s Python
loop, ``utils/bpe.py``'s Python merge loop, ``data/pipeline.py``
``GeneSampleBuilder.build``):

  * consensus over a 0-based [start, end): a homozygous SNV writes its
    allele, a heterozygous one the IUPAC code of its two alleles;
  * CRE regions are the map's rows +-``cre_neighbour_hood`` bp, in start
    order, reversed (and each reverse-complemented) on the minus strand;
  * the gene window is [TSS - up, min(end, TSS - up + down)) on '+' and
    [max(start, end - down), end + up) on '-', reverse-complemented there;
  * BPE: uppercase, split at non-IUPAC characters, merges in rank order
    (lowest rank first, leftmost first), ids from the released vocabulary;
  * windows of ``max_length`` tokens (at most ``max_chunks`` for the gene).

It imports neither the port nor JAX; it reads the repository's ``vocabs/``.
"""

from __future__ import annotations

import gzip
import heapq
import json
import re
from pathlib import Path

import numpy as np

IUPAC = "ACGTRYSWKMBDHV"
HET = {"AC": "M", "CA": "M", "AG": "R", "GA": "R", "AT": "W", "TA": "W",
       "CG": "S", "GC": "S", "CT": "Y", "TC": "Y", "GT": "K", "TG": "K"}
_COMP = str.maketrans("ACGTRYSWKMBDHVNacgtryswkmbdhvn", "TGCAYRSWMKVHDBNtgcayrswmkvhdbn")
_SPLIT = re.compile("[^" + IUPAC + "]+")
REF_CRES = (
    "CTCF-only,CTCF-bound", "DNase-H3K4me3", "DNase-H3K4me3,CTCF-bound", "PLS",
    "PLS,CTCF-bound", "dELS", "dELS,CTCF-bound", "pELS", "pELS,CTCF-bound",
)
VOCAB = Path(__file__).resolve().parents[2] / "vocabs" / "bpe_vocabulary_500.json"


def revcomp(s: str) -> str:
    return s[::-1].translate(_COMP)


class Bpe:
    def __init__(self, path: Path = VOCAB):
        model = json.loads(Path(path).read_text())["model"]
        self.vocab = model["vocab"]
        self.ranks = {tuple(m.split(" ") if isinstance(m, str) else m): r
                      for r, m in enumerate(model["merges"])}
        self.pad = self.vocab.get("<pad>", 0)

    def word(self, w: str) -> list[int]:
        n = len(w)
        if n == 1:
            return [self.vocab[w]]
        sym, nxt, prv, alive = list(w), list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        nxt[-1] = -1
        heap = [(self.ranks[(sym[i], sym[i + 1])], i, sym[i], sym[i + 1])
                for i in range(n - 1) if (sym[i], sym[i + 1]) in self.ranks]
        heapq.heapify(heap)
        while heap:
            _, i, a, b = heapq.heappop(heap)
            if not alive[i] or sym[i] != a:
                continue
            j = nxt[i]
            if j == -1 or sym[j] != b:
                continue
            sym[i] = a + b
            alive[j] = False
            k = nxt[j]
            nxt[i] = k
            if k != -1:
                prv[k] = i
                r = self.ranks.get((sym[i], sym[k]))
                if r is not None:
                    heapq.heappush(heap, (r, i, sym[i], sym[k]))
            p = prv[i]
            if p != -1:
                r = self.ranks.get((sym[p], sym[i]))
                if r is not None:
                    heapq.heappush(heap, (r, p, sym[p], sym[i]))
        out, i = [], 0
        while i != -1:
            if alive[i]:
                out.append(self.vocab[sym[i]])
            i = nxt[i]
        return out

    def encode(self, seq: str) -> list[int]:
        return [t for w in _SPLIT.split(seq.upper()) if w for t in self.word(w)]


def read_fasta(path: str) -> dict[str, str]:
    seqs, name, parts = {}, None, []
    for line in Path(path).read_text().splitlines():
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(parts)
            name, parts = line[1:].split()[0], []
        else:
            parts.append(line.strip())
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


def read_vcf(path: str) -> dict[str, list[tuple[int, str, tuple[str, str]]]]:
    """chrom -> sorted (pos, ref, (allele0, allele1)) of non-reference calls."""
    out: dict[str, list] = {}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            alts = f[4].split(",")
            gt = f[9].split(":")[f[8].split(":").index("GT")].replace("/", "|").split("|")
            ids = [0 if a == "." else int(a) for a in gt[:2]] * (2 if len(gt) == 1 else 1)
            if ids[0] == 0 and ids[1] == 0:
                continue
            alleles = tuple(f[3] if i == 0 else alts[i - 1] for i in ids[:2])
            out.setdefault(f[0], []).append((int(f[1]), f[3], alleles))
    for v in out.values():
        v.sort(key=lambda r: r[0])
    return out


def consensus(seq: str, start: int, end: int, variants) -> str:
    """SNVs (and the rest of the calls, as the port's loop) applied to
    seq[start:end]; ``variants`` are the chromosome's sorted calls."""
    ref = seq[start:end]
    out, cursor = [], 0
    for pos, r, (a0, a1) in variants:
        if pos <= start or pos > end:
            continue
        vs = pos - 1 - start
        ve = vs + len(r)
        if vs < cursor or ve > len(ref) or ref[vs:ve].upper() != r.upper():
            continue
        out.append(ref[cursor:vs])
        if a0 == a1:
            out.append(a0)
        elif len(r) == 1 and len(a0) == 1 and len(a1) == 1:
            out.append(HET.get((a0 + a1).upper(), "N"))
        else:
            out.append(a0 if a0.upper() != r.upper() else a1)
        cursor = ve
    out.append(ref[cursor:])
    return "".join(out)


def _fit(ids: list[int], length: int, pad: int) -> tuple[np.ndarray, int]:
    n = min(len(ids), length)
    arr = np.full(length, pad, np.int32)
    arr[:n] = ids[:n]
    return arr, n


def build_gene(gene: dict, cre_map: list[tuple[int, int, str]], seq: str, variants,
               dataset: dict, bpe: Bpe) -> dict:
    """One gene's CRE and gene windows for one donor: int32 arrays
    ``cre_tokens`` [C, L], ``cre_tok_len`` [C], ``cre_labels`` [C],
    ``gene_tokens`` [G, L], ``gene_tok_len`` [G]."""
    L, nb = dataset["max_length"], dataset["cre_neighbour_hood"]
    rows = sorted(cre_map, key=lambda r: r[0])
    if gene["strand"] == "-":
        rows = rows[::-1]
    cre_t, cre_n, cre_l = [], [], []
    for s, e, name in rows:
        cs = consensus(seq, max(0, s - nb), e + nb, variants)
        if not cs:
            continue
        if gene["strand"] == "-":
            cs = revcomp(cs)
        arr, n = _fit(bpe.encode(cs), L, bpe.pad)
        cre_t.append(arr)
        cre_n.append(n)
        cre_l.append(REF_CRES.index(name))
    start, end = int(gene["start"]), int(gene["end"])
    up, down = dataset["gene_upstream_neighbour_hood"], dataset["gene_downstream_neighbour_hood"]
    if gene["strand"] == "-":
        w0, w1 = max(start, end - down), end + up
    else:
        w0 = max(0, start - up)
        w1 = min(end, w0 + down)
    gs = consensus(seq, w0, w1, variants)
    if gene["strand"] == "-":
        gs = revcomp(gs)
    ids = bpe.encode(gs)
    gene_t, gene_n = [], []
    for c in range(0, len(ids), L):
        if len(gene_t) >= dataset["max_chunks"]:
            break
        arr, n = _fit(ids[c:c + L], L, bpe.pad)
        gene_t.append(arr)
        gene_n.append(n)
    return {
        "cre_tokens": np.stack(cre_t), "cre_tok_len": np.asarray(cre_n, np.int32),
        "cre_labels": np.asarray(cre_l, np.int32), "gene_tokens": np.stack(gene_t),
        "gene_tok_len": np.asarray(gene_n, np.int32),
    }


def build_job(job: tuple) -> dict:
    """``build_gene`` from files: (fasta, vcf, gencode row, CRE rows,
    dataset), for a worker process; the FASTA and VCF are read once per
    worker."""
    fasta, vcf, gene, cre_rows, dataset = job
    key = (fasta, vcf)
    if _CACHE.get("key") != key:
        _CACHE.clear()
        _CACHE.update(key=key, seqs=read_fasta(fasta), vcf=read_vcf(vcf) if vcf else {},
                      bpe=Bpe())
    chrom = gene["chromosome"]
    return build_gene(gene, cre_rows, _CACHE["seqs"][chrom], _CACHE["vcf"].get(chrom, []),
                      dataset, _CACHE["bpe"])


_CACHE: dict = {}


def build_many(jobs: list[tuple], workers: int) -> list[dict]:
    """``build_job`` over ``jobs`` on ``workers`` spawned processes (in this
    process when ``workers`` <= 1); the pool is closed and joined."""
    if workers <= 1 or len(jobs) <= 1:
        return [build_job(j) for j in jobs]
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(jobs))) as pool:
        out = pool.map(build_job, jobs, chunksize=1)
        pool.close()
        pool.join()
    return out
