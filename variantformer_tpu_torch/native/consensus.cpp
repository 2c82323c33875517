// Diploid IUPAC consensus — native core of the sequence engine.
//
// The port's copy of variantformer_tpu/native/consensus.cpp, with the same C
// interface. Applies sorted diploid variants to a reference slice with the
// `bcftools consensus -H I` semantics of the port's utils/vcf.py:
// heterozygous SNPs become IUPAC ambiguity codes, homozygous sites apply the
// allele, indels shift downstream coordinates, REF mismatches and overlaps
// of prior edits are skipped.
//
// C ABI: variant alleles arrive as one packed byte blob with offsets
// (ctypes-friendly; no per-string marshalling).

#include <cstdint>
#include <cstring>

namespace {

inline char upper(char c) { return (c >= 'a' && c <= 'z') ? c - 32 : c; }

inline char het_code(char a, char b) {
  a = upper(a);
  b = upper(b);
  if (a == b) return a;
  auto pair = [&](char x, char y) { return (a == x && b == y) || (a == y && b == x); };
  if (pair('A', 'C')) return 'M';
  if (pair('A', 'G')) return 'R';
  if (pair('A', 'T')) return 'W';
  if (pair('C', 'G')) return 'S';
  if (pair('C', 'T')) return 'Y';
  if (pair('G', 'T')) return 'K';
  return 'N';
}

struct ComplementTable {
  char map[256];
  ComplementTable() {
    for (int i = 0; i < 256; ++i) map[i] = static_cast<char>(i);
    const char* from = "ACGTRYSWKMBDHVacgtryswkmbdhv";
    const char* to = "TGCAYRSWMKVHDBtgcayrswmkvhdb";
    for (int i = 0; from[i]; ++i) map[static_cast<uint8_t>(from[i])] = to[i];
  }
};

}  // namespace

extern "C" {

// Returns the output length, or -1 if out_cap is too small.
//
//   seq, seq_len      : reference slice covering [region_start, ...) 0-based
//   region_start      : genomic coordinate of seq[0] (0-based)
//   n                 : number of variants (sorted by pos ascending)
//   pos[i]            : 1-based genomic POS
//   blob + offsets    : ref allele = blob[ref_off[i]..ref_off[i+1]),
//                       allele0   = blob[a0_off[i]..a0_off[i+1]),
//                       allele1   = blob[a1_off[i]..a1_off[i+1])
//   snps_only         : skip variants where any allele length != 1
//   n_applied_out     : number of edits applied
int64_t vfx_consensus(const char* seq, int64_t seq_len, int64_t region_start,
                      int32_t n, const int64_t* pos, const char* blob,
                      const int64_t* ref_off, const int64_t* a0_off,
                      const int64_t* a1_off, int32_t snps_only, char* out,
                      int64_t out_cap, int32_t* n_applied_out) {
  int64_t cursor = 0;  // within seq
  int64_t written = 0;
  int32_t applied = 0;
  for (int32_t i = 0; i < n; ++i) {
    const char* ref = blob + ref_off[i];
    int64_t ref_len = ref_off[i + 1] - ref_off[i];
    const char* a0 = blob + a0_off[i];
    int64_t a0_len = a0_off[i + 1] - a0_off[i];
    const char* a1 = blob + a1_off[i];
    int64_t a1_len = a1_off[i + 1] - a1_off[i];

    // hom-ref calls contribute nothing
    if (a0_len == ref_len && a1_len == ref_len &&
        std::memcmp(a0, ref, ref_len) == 0 && std::memcmp(a1, ref, ref_len) == 0)
      continue;
    bool is_snp = (ref_len == 1 && a0_len == 1 && a1_len == 1);
    if (snps_only && !is_snp) continue;

    int64_t vstart = pos[i] - 1 - region_start;
    int64_t vend = vstart + ref_len;
    if (vstart < cursor || vend > seq_len) continue;  // overlap or runs past
    bool match = true;
    for (int64_t j = 0; j < ref_len; ++j) {
      if (upper(seq[vstart + j]) != upper(ref[j])) { match = false; break; }
    }
    if (!match) continue;

    int64_t chunk = vstart - cursor;
    if (written + chunk > out_cap) return -1;
    std::memcpy(out + written, seq + cursor, chunk);
    written += chunk;

    bool same = (a0_len == a1_len) && std::memcmp(a0, a1, a0_len) == 0;
    if (same) {                         // homozygous: apply the allele
      if (written + a0_len > out_cap) return -1;
      std::memcpy(out + written, a0, a0_len);
      written += a0_len;
    } else if (is_snp) {                // het SNP: IUPAC of the two GT alleles
      // (REF,ALT) for 0/1; (ALT1,ALT2) for multi-allelic 1/2 hets.
      if (written + 1 > out_cap) return -1;
      out[written++] = het_code(a0[0], a1[0]);
    } else {                            // het indel: apply the non-ref allele
      const char* alt = a0;
      int64_t alt_len = a0_len;
      if (a0_len == ref_len && std::memcmp(a0, ref, ref_len) == 0) {
        alt = a1;
        alt_len = a1_len;
      }
      if (written + alt_len > out_cap) return -1;
      std::memcpy(out + written, alt, alt_len);
      written += alt_len;
    }
    cursor = vend;
    ++applied;
  }
  int64_t tail = seq_len - cursor;
  if (written + tail > out_cap) return -1;
  std::memcpy(out + written, seq + cursor, tail);
  written += tail;
  *n_applied_out = applied;
  return written;
}

// IUPAC reverse complement (byte-wise table) of seq[0..n) into out.
void vfx_reverse_complement(const char* seq, int64_t n, char* out) {
  // A function-local static is initialised once, thread-safely (C++11).
  static const ComplementTable table;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = table.map[static_cast<uint8_t>(seq[n - 1 - i])];
  }
}

}  // extern "C"
