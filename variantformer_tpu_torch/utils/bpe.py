"""DNA BPE tokenizer over the released 500-token vocabulary.

The port's copy of ``variantformer_tpu/utils/bpe.py``:

  * ``normalize``: uppercase, split into subsequences at any non-IUPAC
    character (N runs and gaps are hard token boundaries),
  * BPE merges applied in rank order (lowest-rank pair first, all
    occurrences left-to-right), the standard HuggingFace BPE algorithm.

The merges run in the C++ engine (``native/bpe.cpp`` through
``utils/native.py``) unless the tokenizer is made with ``use_native=False``;
the pure-Python merge loop (``_encode_word``) is the plain version, and both
give the same ids. The offset-tracking encoders of variant-effect prediction
are not ported yet.
"""

from __future__ import annotations

import heapq
import json
import re
from typing import Iterable

import numpy as np

from variantformer_tpu_torch.utils.constants import IUPAC_CODES, SPECIAL_TOKENS
from variantformer_tpu_torch.utils.native import NativeBPE

_IUPAC_SET = frozenset(IUPAC_CODES)
_NON_IUPAC_RE = re.compile("[^" + "".join(sorted(_IUPAC_SET)) + "]+")


class BPETokenizer:
    def __init__(
        self, vocab: dict[str, int], merges: list[tuple[str, str]], use_native: bool = True
    ):
        """``use_native``: merge in the C++ engine (built at first use; raises
        when it cannot be) or, when False, in the Python loop."""
        self.vocab = dict(vocab)
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

    def _encode_word(self, word: str) -> list[int]:
        """BPE-encode one subsequence into token ids in Python (the plain
        version of the native engine)."""
        n = len(word)
        if n == 0:
            return []
        if n == 1:
            return [self.vocab[word]]
        # Doubly-linked list over symbols with a lazy heap of merge candidates.
        sym = list(word)                  # symbol strings
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
        i = 0
        while i != -1:
            if alive[i]:
                ids.append(self.vocab[sym[i]])
            i = nxt[i]
        return ids

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
            else np.asarray(self._encode_word(sub), np.int32)
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
