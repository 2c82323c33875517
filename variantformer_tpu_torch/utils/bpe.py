"""DNA BPE tokenizer over the released 500-token vocabulary.

The port's copy of ``variantformer_tpu/utils/bpe.py``:

  * ``normalize``: uppercase, split into subsequences at any non-IUPAC
    character (N runs and gaps are hard token boundaries),
  * BPE merges applied in rank order (lowest-rank pair first, all
    occurrences left-to-right), the standard HuggingFace BPE algorithm.

The merges run in the C++ engine (``native/bpe.cpp`` through
``utils/native.py``) unless the tokenizer is made with ``use_native=False``;
the pure-Python merge loop (``_encode_word_py``) is the plain version, and
both give the same ids and character offsets. Variant-effect prediction uses
the offset-tracking encoders: ``encode_with_offsets`` (each token's span in
the raw sequence), ``encode_with_position`` (the token covering a raw
coordinate) and ``splice_encode`` (the ids of a one-character edit, re-encoding
only a neighbourhood of the edit). ``encode`` tokenizes both strands,
``decode`` maps ids back to sequence, ``train_bpe`` learns a vocabulary and
merges from sequences, ``save_vocabulary`` writes them in the HuggingFace
tokenizers JSON that ``from_file`` reads, and ``default_tokenizer`` loads
the released 500-token vocabulary from the repo's ``vocabs/``.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
from typing import Iterable

import numpy as np

from variantformer_tpu_torch.utils.assets import resolve_vocab_path
from variantformer_tpu_torch.utils.constants import IUPAC_CODES, SPECIAL_TOKENS
from variantformer_tpu_torch.utils.native import NativeBPE

_IUPAC_SET = frozenset(IUPAC_CODES)
_NON_IUPAC_RE = re.compile("[^" + "".join(sorted(_IUPAC_SET)) + "]+")
_IUPAC_RUN_RE = re.compile("[" + "".join(sorted(_IUPAC_SET)) + "]+")


class BPETokenizer:
    def __init__(
        self, vocab: dict[str, int], merges: list[tuple[str, str]], use_native: bool = True
    ):
        """``use_native``: merge in the C++ engine (built at first use; raises
        when it cannot be) or, when False, in the Python loop."""
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merge_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.pad_token_id = self.vocab.get(SPECIAL_TOKENS["pad_token"], 0)
        self._native = NativeBPE(self.vocab, merges) if use_native else None

    @property
    def use_native(self) -> bool:
        return self._native is not None

    @classmethod
    def from_file(cls, path: str, use_native: bool = True) -> "BPETokenizer":
        """Load a HuggingFace tokenizers JSON file (BPE model)."""
        with open(path) as fh:
            data = json.load(fh)
        model = data["model"]
        merges = [
            tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            for m in model["merges"]
        ]
        return cls(model["vocab"], merges, use_native=use_native)

    def _encode_word(self, word: str) -> tuple[list[int], list[tuple[int, int]]]:
        """BPE-encode one subsequence; returns (ids, char offsets)."""
        if self._native is not None:
            return self._native.encode_word(word)
        return self._encode_word_py(word)

    def _encode_word_py(self, word: str) -> tuple[list[int], list[tuple[int, int]]]:
        """BPE-encode one subsequence in Python (the plain version of the
        native engine): (ids, [(start, end) of each token in the word])."""
        n = len(word)
        if n == 0:
            return [], []
        if n == 1:
            return [self.vocab[word]], [(0, 1)]
        # Doubly-linked list over symbols with a lazy heap of merge candidates.
        sym = list(word)                  # symbol strings
        end = [i + 1 for i in range(n)]   # char end per node (a node starts at its index)
        prev = [i - 1 for i in range(n)]
        nxt = [i + 1 for i in range(n)]
        nxt[-1] = -1
        alive = [True] * n

        ranks = self.merge_ranks
        heap: list[tuple[int, int, str, str]] = []
        for i in range(n - 1):
            r = ranks.get((sym[i], sym[i + 1]))
            if r is not None:
                heap.append((r, i, sym[i], sym[i + 1]))
        heapq.heapify(heap)

        while heap:
            r, i, left, right = heapq.heappop(heap)
            if not alive[i] or sym[i] != left:
                continue
            j = nxt[i]
            if j == -1 or sym[j] != right:
                continue
            # merge node j into node i
            sym[i] = left + right
            end[i] = end[j]
            alive[j] = False
            k = nxt[j]
            nxt[i] = k
            if k != -1:
                prev[k] = i
                nr = ranks.get((sym[i], sym[k]))
                if nr is not None:
                    heapq.heappush(heap, (nr, i, sym[i], sym[k]))
            p = prev[i]
            if p != -1:
                nr = ranks.get((sym[p], sym[i]))
                if nr is not None:
                    heapq.heappush(heap, (nr, p, sym[p], sym[i]))

        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        i = 0
        while i != -1:
            if alive[i]:
                ids.append(self.vocab[sym[i]])
                offsets.append((i, end[i]))
            i = nxt[i]
        return ids, offsets

    @staticmethod
    def normalize(sequences: Iterable[str]) -> list[str]:
        """Uppercase and split each sequence at non-IUPAC characters."""
        out: list[str] = []
        for seq in sequences:
            out.extend(s for s in _NON_IUPAC_RE.split(seq.upper()) if s)
        return out

    def encode_ids(self, sequence: str) -> np.ndarray:
        """Normalize + encode one raw sequence to an int32 id array."""
        parts = [
            self._native.encode_word_ids(sub) if self._native is not None
            else np.asarray(self._encode_word_py(sub)[0], np.int32)
            for sub in self.normalize([sequence])
        ]
        if not parts:
            return np.zeros(0, np.int32)
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def encode_ids_batch(self, sequences: list[str]) -> list[np.ndarray]:
        """``[self.encode_ids(s) for s in sequences]``, with ONE native call
        for all of them: a gene's few hundred CRE windows cost one release
        of the GIL, not one a word."""
        if self._native is None:
            return [self.encode_ids(s) for s in sequences]
        words: list[str] = []
        spans: list[tuple[int, int]] = []  # word range of each sequence
        for seq in sequences:
            w0 = len(words)
            words.extend(self.normalize([seq]))
            spans.append((w0, len(words)))
        flat_ids, counts = self._native.encode_words_ids(words)
        bounds = np.zeros(len(words) + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        return [flat_ids[bounds[w0]:bounds[w1]] for w0, w1 in spans]

    def encode_strand(self, subsequences: list[str]) -> tuple[list[int], list[str]]:
        """Encode normalized subsequences: (ids, token strings)."""
        ids: list[int] = []
        tokens: list[str] = []
        for sub in subsequences:
            sub_ids, offs = self._encode_word(sub)
            ids.extend(sub_ids)
            tokens.extend(sub[a:b] for a, b in offs)
        return ids, tokens

    def encode(self, sequences) -> tuple[list[int], list[str], list[int], list[str]]:
        """encode([fwd, rev]) (or "fwd,rev") -> (fwd ids, fwd tokens, rev ids,
        rev tokens): both strands tokenized independently."""
        if isinstance(sequences, str):
            sequences = sequences.split(",")
        ids_f, tok_f = self.encode_strand(self.normalize([sequences[0]]))
        ids_r, tok_r = self.encode_strand(self.normalize([sequences[1]]))
        return ids_f, tok_f, ids_r, tok_r

    def decode(self, ids: Iterable[int]) -> str:
        """The sequence of ``ids``, special tokens (ids 0-3) dropped."""
        return "".join(self.id_to_token[i] for i in ids if i > 3)

    def encode_with_offsets(self, sequence: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode one raw sequence, returning (ids, starts, ends) where the
        offsets are RAW-sequence coordinates (non-IUPAC runs leave gaps in
        the offset ranges; they never produce tokens). The token covering a
        raw position p is the unique index with starts[i] <= p < ends[i]."""
        ids_parts: list[np.ndarray] = []
        st_parts: list[np.ndarray] = []
        en_parts: list[np.ndarray] = []
        for m in _IUPAC_RUN_RE.finditer(sequence.upper()):
            sub = m.group(0)
            if self._native is not None:
                ids, st, en = self._native.encode_word_ids_offsets(sub)
            else:
                py_ids, offs = self._encode_word_py(sub)
                ids = np.asarray(py_ids, np.int32)
                st = np.asarray([a for a, _ in offs], np.int32)
                en = np.asarray([b for _, b in offs], np.int32)
            ids_parts.append(ids)
            st_parts.append(st + m.start())
            en_parts.append(en + m.start())
        if not ids_parts:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        return np.concatenate(ids_parts), np.concatenate(st_parts), np.concatenate(en_parts)

    def encode_with_position(self, sequence: str, position: int) -> dict:
        """Encode and locate the token covering ``position`` (raw coordinate).

        Non-IUPAC characters before the position shift it left; the returned
        position_id is global across all subsequences."""
        if position < 0 or position >= len(sequence):
            raise ValueError(f"Position {position} out of range for length {len(sequence)}")
        sequence = sequence.upper()
        if sequence[position] not in _IUPAC_SET:
            raise ValueError(
                f"Position {position} points to invalid character '{sequence[position]}'"
            )
        invalid_before = sum(1 for i in range(position) if sequence[i] not in _IUPAC_SET)
        adjusted = position - invalid_before

        all_ids: list[int] = []
        all_tokens: list[str] = []
        pos_in_norm = 0
        global_token_offset = 0
        result = None
        for sub in self.normalize([sequence]):
            ids, offs = self._encode_word(sub)
            all_ids.extend(ids)
            all_tokens.extend(sub[a:b] for a, b in offs)
            sub_start, sub_end = pos_in_norm, pos_in_norm + len(sub)
            if result is None and sub_start <= adjusted < sub_end:
                pos_in_sub = adjusted - sub_start
                token_idx = next(i for i, (a, b) in enumerate(offs) if a <= pos_in_sub < b)
                result = {
                    "offsets": offs,
                    "position_id": global_token_offset + token_idx,
                    "position_token": sub[offs[token_idx][0]:offs[token_idx][1]],
                    "target_subsequence": sub,
                }
            global_token_offset += len(ids)
            pos_in_norm = sub_end
        if result is None:
            raise ValueError(f"Could not locate adjusted position {adjusted}")
        result["encoded_ids"] = all_ids
        result["all_tokens"] = all_tokens
        return result


def splice_encode(
    tok: BPETokenizer,
    seq: str,
    ids: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    pos: int,
    repl: str,
    margin: int = 2048,
) -> tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]:
    """Token stream of ``seq[:pos] + repl + seq[pos+1:]`` computed
    incrementally from the already-encoded reference stream (``ids``,
    ``starts``, ``ends`` from ``encode_with_offsets(seq)``).

    Only a window of ~2*margin chars around the edit is re-tokenized; the
    rest of the reference ids are reused. Exactness is enforced by two
    checks, escalating the margin (and finally falling back to a full
    re-encode) when either fails:

      * sync check: standalone-encoding the REFERENCE window must reproduce
        the in-context token slice exactly (the cut points are then BPE
        synchronization points),
      * containment check: the EDITED window's boundary tokens must match
        the reference window's (the edit did not propagate to the cut).

    Windows are cut at token boundaries of the reference encoding and
    ``encode_ids`` re-applies the same normalization, so interior non-IUPAC
    runs split identically.

    Returns (new_ids, win_token_start, win_ids, win_starts, win_ends): the
    full spliced id array, the global token index where the re-encoded
    window begins, and the window's ids with ABSOLUTE raw-coordinate offsets
    in the edited sequence.
    """
    n = len(seq)
    if len(ids) == 0:
        out, st, en = tok.encode_with_offsets(seq[:pos] + repl + seq[pos + 1:])
        return out, 0, out, st, en
    while True:
        a_char = max(0, pos - margin)
        b_char = min(n, pos + 1 + margin)
        ta = int(np.searchsorted(ends, a_char, side="right"))
        tb = int(np.searchsorted(starts, b_char, side="left")) - 1
        ta = min(max(ta, 0), len(ids) - 1)
        tb = min(max(tb, ta), len(ids) - 1)
        a, b = int(starts[ta]), int(ends[tb])
        exhausted = ta == 0 and tb == len(ids) - 1
        rw_ids = tok.encode_ids(seq[a:b])
        if not np.array_equal(rw_ids, ids[ta:tb + 1]):
            if exhausted:
                break
            margin *= 4
            continue
        ew_ids, ew_starts, ew_ends = tok.encode_with_offsets(seq[a:pos] + repl + seq[pos + 1:b])
        k = 2  # boundary tokens that must re-synchronize
        head_ok = ta == 0 or (len(ew_ids) >= k and np.array_equal(ew_ids[:k], rw_ids[:k]))
        tail_ok = tb == len(ids) - 1 or (
            len(ew_ids) >= k and np.array_equal(ew_ids[-k:], rw_ids[-k:])
        )
        if not (head_ok and tail_ok):
            if exhausted:
                break
            margin *= 4
            continue
        out = np.concatenate([ids[:ta], ew_ids, ids[tb + 1:]])
        return out, ta, ew_ids, ew_starts + a, ew_ends + a
    # full fallback (pathological propagation): always exact
    out, st, en = tok.encode_with_offsets(seq[:pos] + repl + seq[pos + 1:])
    return out, 0, out, st, en


def train_bpe(
    sequences: Iterable[str],
    vocab_size: int,
    min_frequency: int = 2,
    special_tokens: list[str] | None = None,
) -> tuple[dict[str, int], list[tuple[str, str]]]:
    """Learn a BPE vocabulary over DNA sequences, as HuggingFace's
    ``BpeTrainer`` does: ids 0..3 are the special tokens, then the corpus
    alphabet in sorted order, then the merges in creation order. Each merge
    takes the pair with the highest count, ties broken by the smallest
    (left id, right id); training stops at ``vocab_size`` or when the best
    pair occurs fewer than ``min_frequency`` times. Sequences are normalized
    first (uppercase, split at non-IUPAC characters), so N runs never
    merge across."""
    if special_tokens is None:
        special_tokens = list(SPECIAL_TOKENS.values())
    words: dict[tuple[str, ...], int] = {}
    for sub in BPETokenizer.normalize(sequences):
        key = tuple(sub)
        words[key] = words.get(key, 0) + 1

    vocab: dict[str, int] = {}
    for tok in special_tokens:
        vocab[tok] = len(vocab)
    for c in sorted({c for w in words for c in w}):
        vocab[c] = len(vocab)

    merges: list[tuple[str, str]] = []
    work = [(list(w), f) for w, f in words.items()]
    while len(vocab) < vocab_size:
        counts: dict[tuple[str, str], int] = {}
        for syms, freq in work:
            for a, b in zip(syms, syms[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + freq
        if not counts:
            break
        (left, right), freq = min(
            counts.items(), key=lambda kv: (-kv[1], vocab[kv[0][0]], vocab[kv[0][1]])
        )
        if freq < min_frequency:
            break
        merged = left + right
        merges.append((left, right))
        vocab[merged] = len(vocab)
        for syms, _ in work:
            i = 0
            while i < len(syms) - 1:
                if syms[i] == left and syms[i + 1] == right:
                    syms[i] = merged
                    del syms[i + 1]
                else:
                    i += 1
    return vocab, merges


def save_vocabulary(path: str, vocab: dict[str, int], merges: list[tuple[str, str]]) -> None:
    """Write a HuggingFace-tokenizers-format JSON (what ``from_file`` reads)."""
    data = {
        "version": "1.0",
        "model": {"type": "BPE", "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    with open(path, "w") as fh:
        json.dump(data, fh)


def default_tokenizer(vocab_path: str | None = None) -> BPETokenizer:
    """The framework's default 500-token DNA vocabulary (loaded once and
    kept), or the vocabulary at ``vocab_path`` (loaded anew)."""
    if vocab_path is not None:
        return BPETokenizer.from_file(vocab_path)
    return _released_tokenizer()


@functools.cache
def _released_tokenizer() -> BPETokenizer:
    return BPETokenizer.from_file(resolve_vocab_path("bpe_vocabulary_500.json"))
