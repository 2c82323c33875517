// DNA BPE encoder — native core of the port's tokenizer (utils/bpe.py).
//
// The port's copy of variantformer_tpu/native/bpe.cpp, with the same C
// interface and the same merges. Replaces the reference's Rust `tokenizers`
// dependency for the hot path: greedy lowest-rank-first pair merging over a doubly-linked symbol list with
// a lazy binary heap, operating in token-id space (utils/native.py maps the
// HuggingFace-JSON vocabulary/merges to (left_id, right_id) -> result_id
// triples once at load).
//
// Hot-path design (this is ~80% of host-side gene sample building time —
// ~550 kbp of consensus sequence is tokenized per gene):
//   * merge lookup is an open-addressing FLAT hash table sized to stay
//     L1/L2-resident (500 merges -> 2048 slots, 32 KB): one multiply-shift
//     hash + linear probe, no bucket pointer chasing. (A direct-addressed
//     [id, id] table was measured SLOWER — 2 MB of random probes thrash the
//     cache, while the table data here is tiny.) Every adjacent pair is
//     probed once at init plus twice per merge, so this probe is the
//     dominant constant.
//   * all per-call scratch (symbol list, heap storage) is thread_local and
//     grown monotonically: a 300 kb gene window needs ~7 MB of scratch,
//     which the old per-call std::vector allocation paid on every call.
//   * merge scheduling is a MONOTONE BUCKET QUEUE by rank, not a heap:
//     well-formed BPE merge lists guarantee that a merge consuming the
//     result of merge r has rank > r (the training process can only learn
//     a merge after its components exist), so processing rank buckets in
//     increasing order never needs to revisit a lower rank — O(n) total
//     scheduling instead of O(n log n) heap churn. Each bucket is sorted
//     by position before processing to keep HF's exact leftmost-first
//     semantics for overlapping same-rank occurrences (runs like "ababab").
//     The invariant is VERIFIED at vfx_bpe_create; a violating merge list
//     (never produced by real BPE training) falls back to a lazy binary
//     heap with identical semantics.
//
// C ABI (ctypes-friendly):
//   vfx_bpe_create(n_merges, left[], right[], result[], char_to_id[256])
//   vfx_bpe_encode(handle, seq, n, out_ids, out_starts, out_ends, max_out)
//   vfx_bpe_encode_batch(handle, text, bounds[n+1], n_words, out_ids,
//                        out_counts, max_out)
//   vfx_bpe_destroy(handle)
//
// The batch entry exists for the GIL: a gene sample tokenizes ~350 CRE
// windows, and ctypes releases/reacquires the GIL around every call — at
// ~2800 transitions per gene the convoy effect made 4 builder threads
// SLOWER than one on a 4-core host. One call per gene's word set keeps the
// GIL transitions O(1) per gene.

#include <algorithm>
#include <cstdint>
#include <cstring>

#include <vector>

namespace {

struct MergeInfo {
  int32_t rank;
  int32_t result;
};

constexpr int32_t kNoMerge = INT32_MAX;
constexpr uint64_t kEmptyKey = UINT64_MAX;  // ids are int32 -> never all-ones

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct Slot {
  uint64_t key;
  MergeInfo info;
};

struct Encoder {
  std::vector<Slot> slots;  // power-of-2 open addressing, linear probing
  uint64_t mask = 0;
  int32_t n_merges = 0;
  bool monotone = false;  // bucket-queue invariant verified
  int32_t char_to_id[256];

  void build(int32_t n, const int32_t* left, const int32_t* right,
             const int32_t* result) {
    n_merges = n;
    size_t cap = 16;
    while (cap < static_cast<size_t>(n) * 4) cap <<= 1;
    slots.assign(cap, Slot{kEmptyKey, {kNoMerge, -1}});
    mask = cap - 1;
    for (int32_t r = 0; r < n; ++r) {
      uint64_t key = pair_key(left[r], right[r]);
      size_t i = hash(key);
      while (slots[i].key != kEmptyKey) i = (i + 1) & mask;
      slots[i] = Slot{key, {r, result[r]}};
    }
    // Verify the monotone invariant: every merge's components must either
    // be base symbols or results of STRICTLY earlier merges.
    int32_t max_id = 0;
    for (int32_t r = 0; r < n; ++r) {
      max_id = std::max({max_id, left[r], right[r], result[r]});
    }
    std::vector<int32_t> produced_at(max_id + 1, -1);  // id -> producing rank
    monotone = true;
    for (int32_t r = 0; r < n; ++r) {
      // Two merges producing the SAME id break the bucket-queue assumption:
      // a pair created by the later producer could map into an already
      // drained rank bucket and silently never merge. Trained vocabularies
      // never do this, but force the (semantically identical) heap fallback
      // if one does.
      if (produced_at[result[r]] >= 0) monotone = false;
      produced_at[result[r]] = r;
    }
    for (int32_t r = 0; r < n && monotone; ++r) {
      // -1 = base symbol (single char, never a merge result)
      if (produced_at[left[r]] >= r || produced_at[right[r]] >= r) {
        monotone = false;
      }
    }
  }

  inline size_t hash(uint64_t key) const {
    // Fibonacci multiply-shift; table is power-of-2 sized.
    return (key * 0x9E3779B97F4A7C15ull >> 32) & mask;
  }

  inline MergeInfo lookup(int32_t a, int32_t b) const {
    uint64_t key = pair_key(a, b);
    size_t i = hash(key);
    while (true) {
      const Slot& s = slots[i];
      if (s.key == key) return s.info;
      if (s.key == kEmptyKey) return MergeInfo{kNoMerge, -1};
      i = (i + 1) & mask;
    }
  }
};

struct HeapItem {
  int32_t rank;
  int32_t pos;       // node index of the left element
  int32_t left_id;   // expected symbol ids at push time (lazy validation)
  int32_t right_id;
};

inline bool heap_less(const HeapItem& a, const HeapItem& b) {
  // min-heap on (rank, pos) -> "less" means higher priority
  if (a.rank != b.rank) return a.rank < b.rank;
  return a.pos < b.pos;
}

// Manual binary min-heap over a reusable buffer.
inline void heap_push(std::vector<HeapItem>& h, HeapItem item) {
  h.push_back(item);
  size_t i = h.size() - 1;
  while (i > 0) {
    size_t parent = (i - 1) / 2;
    if (!heap_less(h[i], h[parent])) break;
    std::swap(h[i], h[parent]);
    i = parent;
  }
}

inline HeapItem heap_pop(std::vector<HeapItem>& h) {
  HeapItem top = h[0];
  h[0] = h.back();
  h.pop_back();
  size_t i = 0, n = h.size();
  while (true) {
    size_t l = 2 * i + 1, r = l + 1, best = i;
    if (l < n && heap_less(h[l], h[best])) best = l;
    if (r < n && heap_less(h[r], h[best])) best = r;
    if (best == i) break;
    std::swap(h[i], h[best]);
    i = best;
  }
  return top;
}

struct Scratch {
  std::vector<int32_t> sym, start, end, prev, next;
  std::vector<uint8_t> alive;
  std::vector<HeapItem> heap;
  std::vector<std::vector<int32_t>> buckets;  // rank -> candidate left nodes

  void ensure(int32_t n) {
    if (static_cast<int32_t>(sym.size()) < n) {
      sym.resize(n);
      start.resize(n);
      end.resize(n);
      prev.resize(n);
      next.resize(n);
      alive.resize(n);
    }
  }
};

thread_local Scratch tls;

}  // namespace

extern "C" {

void* vfx_bpe_create(int32_t n_merges, const int32_t* left, const int32_t* right,
                     const int32_t* result, const int32_t* char_to_id) {
  auto* enc = new Encoder();
  enc->build(n_merges, left, right, result);
  std::memcpy(enc->char_to_id, char_to_id, 256 * sizeof(int32_t));
  return enc;
}

void vfx_bpe_destroy(void* handle) { delete static_cast<Encoder*>(handle); }

// Encode one subsequence (all chars must be alphabet members).
// Returns the token count, or -1 on invalid char, or -2 if max_out too small.
int32_t vfx_bpe_encode(void* handle, const char* seq, int32_t n,
                       int32_t* out_ids, int32_t* out_starts,
                       int32_t* out_ends, int32_t max_out) {
  const Encoder* enc = static_cast<const Encoder*>(handle);
  if (n <= 0) return 0;

  Scratch& s = tls;
  s.ensure(n);
  int32_t* sym = s.sym.data();
  int32_t* start = s.start.data();
  int32_t* end = s.end.data();
  int32_t* prev = s.prev.data();
  int32_t* next = s.next.data();
  uint8_t* alive = s.alive.data();

  for (int32_t i = 0; i < n; ++i) {
    int32_t id = enc->char_to_id[static_cast<uint8_t>(seq[i])];
    if (id < 0) return -1;
    sym[i] = id;
    start[i] = i;
    end[i] = i + 1;
    prev[i] = i - 1;
    next[i] = (i + 1 < n) ? i + 1 : -1;
    alive[i] = 1;
  }

  if (enc->monotone) {
    // Monotone bucket queue: process ranks in increasing order; every pair
    // created while processing rank r has rank > r (see header note), so no
    // bucket is ever revisited. Entries are lazily validated (a stale entry
    // whose pair changed simply fails the rank re-check).
    std::vector<std::vector<int32_t>>& buckets = s.buckets;
    if (buckets.size() < static_cast<size_t>(enc->n_merges)) {
      buckets.resize(enc->n_merges);
    }
    for (int32_t i = 0; i + 1 < n; ++i) {
      MergeInfo m = enc->lookup(sym[i], sym[i + 1]);
      if (m.rank != kNoMerge) buckets[m.rank].push_back(i);
    }
    for (int32_t r = 0; r < enc->n_merges; ++r) {
      std::vector<int32_t>& b = buckets[r];
      if (b.empty()) continue;
      // position order preserves HF's leftmost-first semantics for
      // overlapping same-rank occurrences; pushes during this loop go to
      // strictly higher ranks, so b is stable.
      std::sort(b.begin(), b.end());
      for (size_t qi = 0; qi < b.size(); ++qi) {
        int32_t i = b[qi];
        if (!alive[i]) continue;
        int32_t j = next[i];
        if (j < 0) continue;
        MergeInfo m = enc->lookup(sym[i], sym[j]);
        if (m.rank != r) continue;

        sym[i] = m.result;
        end[i] = end[j];
        alive[j] = 0;
        int32_t k = next[j];
        next[i] = k;
        if (k >= 0) {
          prev[k] = i;
          MergeInfo nm = enc->lookup(sym[i], sym[k]);
          if (nm.rank != kNoMerge) buckets[nm.rank].push_back(i);
        }
        int32_t p = prev[i];
        if (p >= 0) {
          MergeInfo pm = enc->lookup(sym[p], sym[i]);
          if (pm.rank != kNoMerge) buckets[pm.rank].push_back(p);
        }
      }
      b.clear();
    }
  } else {
    std::vector<HeapItem>& heap = s.heap;
    heap.clear();
    for (int32_t i = 0; i + 1 < n; ++i) {
      MergeInfo m = enc->lookup(sym[i], sym[i + 1]);
      if (m.rank != kNoMerge) {
        heap_push(heap, {m.rank, i, sym[i], sym[i + 1]});
      }
    }

    while (!heap.empty()) {
      HeapItem item = heap_pop(heap);
      int32_t i = item.pos;
      if (!alive[i] || sym[i] != item.left_id) continue;
      int32_t j = next[i];
      if (j < 0 || sym[j] != item.right_id) continue;
      MergeInfo m = enc->lookup(sym[i], sym[j]);
      if (m.rank != item.rank) continue;

      sym[i] = m.result;
      end[i] = end[j];
      alive[j] = 0;
      int32_t k = next[j];
      next[i] = k;
      if (k >= 0) {
        prev[k] = i;
        MergeInfo nm = enc->lookup(sym[i], sym[k]);
        if (nm.rank != kNoMerge) {
          heap_push(heap, {nm.rank, i, sym[i], sym[k]});
        }
      }
      int32_t p = prev[i];
      if (p >= 0) {
        MergeInfo pm = enc->lookup(sym[p], sym[i]);
        if (pm.rank != kNoMerge) {
          heap_push(heap, {pm.rank, p, sym[p], sym[i]});
        }
      }
    }
  }

  int32_t count = 0;
  for (int32_t i = 0; i >= 0; i = next[i]) {
    if (!alive[i]) continue;
    if (count >= max_out) return -2;
    out_ids[count] = sym[i];
    out_starts[count] = start[i];
    out_ends[count] = end[i];
    ++count;
  }
  return count;
}

// Encode n_words subsequences in ONE call. ``text`` is the concatenation of
// all words; ``bounds`` has n_words+1 prefix offsets (word w spans
// text[bounds[w], bounds[w+1])). Flat token ids land in out_ids, per-word
// token counts in out_counts. Returns the total token count, -1 on an
// invalid character, -2 if max_out is too small.
int64_t vfx_bpe_encode_batch(void* handle, const char* text,
                             const int64_t* bounds, int32_t n_words,
                             int32_t* out_ids, int32_t* out_counts,
                             int64_t max_out) {
  // The scratch start/end outputs of the word encode are sized by the
  // longest word; reuse one thread_local pair across words.
  static thread_local std::vector<int32_t> starts, ends;
  int64_t total = 0;
  for (int32_t w = 0; w < n_words; ++w) {
    int64_t n = bounds[w + 1] - bounds[w];
    if (static_cast<int64_t>(starts.size()) < n) {
      starts.resize(n);
      ends.resize(n);
    }
    int32_t count = vfx_bpe_encode(handle, text + bounds[w],
                                   static_cast<int32_t>(n), out_ids + total,
                                   starts.data(), ends.data(),
                                   static_cast<int32_t>(
                                       std::min<int64_t>(max_out - total,
                                                         INT32_MAX)));
    if (count < 0) return count;
    out_counts[w] = count;
    total += count;
  }
  return total;
}

}  // extern "C"
