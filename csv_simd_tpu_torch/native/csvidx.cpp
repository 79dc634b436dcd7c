// Native host engine for csv_simd_tpu.
//
// Two roles (mirroring the runtime split of the framework):
//   1. host_stage1        — a complete CPU stage-1 indexer over raw bytes:
//                           uint64 SWAR classify + in-word prefix-XOR quote
//                           parity + offset extraction, multithreaded with
//                           the same two-phase parity stitch the device
//                           shards use (phase A: per-chunk quote parity;
//                           phase B: parallel masked extraction).
//                           This is the fallback/serving-host engine — the
//                           role the whole Rust reference plays
//                           (avx/stage1.rs:193-430), generalized to any
//                           single-byte dialect and actually parallel
//                           (the reference's Chunk layer was never wired
//                           to threads, tape.rs:13-40).
//   2. extract_offsets_v3 — decode the TPU kernel's fold-packed bitmask
//                           words (ops/stage1_v3.py layout) into ascending
//                           absolute byte offsets without expanding to a
//                           byte mask.
//
// Exact SWAR byte-equality (no cross-byte borrows; the naive
// (v-0x0101..)&~v&0x8080.. detector is wrong for 0x01-after-0x00):
//   y = x ^ (C * 0x0101..); t = (y & 0x7f7f..) + 0x7f7f..; t |= y;
//   flags = ~t & 0x8080..
//
// On x86-64 a runtime-dispatched AVX2 path widens the hot loops to
// 64 B/iteration: per-byte equality via vpcmpeqb + vpmovmskb packs a
// 64-bit structural/quote mask per block, and the in-block quote
// parity is a BIT-level prefix XOR (six shift-XOR doubling steps —
// cheaper and more portable than a carry-less multiply). The SWAR
// path remains the fallback on every other ISA and for sub-64 B tails.
//
// Build: g++ -O3 -march=native -shared -fPIC csvidx.cpp -o _csvidx.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#include <unistd.h>
#endif

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define CSVIDX_X86 1
#endif

namespace {

constexpr uint64_t kLo7 = 0x7f7f7f7f7f7f7f7fULL;
constexpr uint64_t kHi1 = 0x8080808080808080ULL;
constexpr uint64_t kOnes = 0x0101010101010101ULL;

static inline uint64_t swar_eq(uint64_t x, uint64_t byte_bcast) {
  uint64_t y = x ^ byte_bcast;
  uint64_t t = (y & kLo7) + kLo7;
  t |= y;
  return ~t & kHi1;
}

static inline uint64_t prefix_xor_bytes(uint64_t f) {
  f ^= f << 8;
  f ^= f << 16;
  f ^= f << 32;
  return f;
}

struct Dialect64 {
  uint64_t delim, quote, nl0, nl1;
};

// Bit-level prefix XOR over a 64-bit mask: bit i of the result is the
// parity of bits 0..i of the input (six doubling steps).
static inline uint64_t prefix_xor_bits(uint64_t f) {
  f ^= f << 1;
  f ^= f << 2;
  f ^= f << 4;
  f ^= f << 8;
  f ^= f << 16;
  f ^= f << 32;
  return f;
}

#ifdef CSVIDX_X86
static inline bool cpu_has_avx2() {
  // the extraction fast path uses _tzcnt_u64/_blsr_u64 (BMI1); every
  // AVX2-era x86 has BMI1 but dispatch checks both to be exact
  static const bool ok =
      __builtin_cpu_supports("avx2") && __builtin_cpu_supports("bmi");
  return ok;
}

// 64 bytes -> one 64-bit per-byte-equality mask.
__attribute__((target("avx2"))) static inline uint64_t avx2_eq_mask(
    __m256i a, __m256i b, __m256i needle) {
  uint64_t lo = static_cast<uint32_t>(
      _mm256_movemask_epi8(_mm256_cmpeq_epi8(a, needle)));
  uint64_t hi = static_cast<uint32_t>(
      _mm256_movemask_epi8(_mm256_cmpeq_epi8(b, needle)));
  return lo | (hi << 32);
}

// Quote parity of the leading floor(n/64)*64 bytes; *done = bytes consumed.
__attribute__((target("avx2"))) static int chunk_quote_parity_avx2(
    const uint8_t* data, int64_t n, uint8_t quote, int64_t* done) {
  const __m256i vq = _mm256_set1_epi8(static_cast<char>(quote));
  const int64_t lim = n & ~63LL;
  int64_t total = 0;
  for (int64_t i = 0; i < lim; i += 64) {
    __m256i a =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i));
    __m256i b =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i + 32));
    total += __builtin_popcountll(avx2_eq_mask(a, b, vq));
  }
  *done = lim;
  return static_cast<int>(total & 1);
}

// Stage-1 over the leading floor(n/64)*64 bytes. Offsets rebased by
// +base; returns count or -1 on cap overflow. *parity_io carries quote
// parity in and out; *done = bytes consumed (tail goes to the SWAR core).
__attribute__((target("avx2,bmi"))) static int64_t chunk_stage1_avx2(
    const uint8_t* data, int64_t n, int64_t base, const Dialect64& d,
    int carry_in, int64_t* out, int64_t cap, int* parity_io, int64_t* done) {
  const __m256i vq = _mm256_set1_epi8(static_cast<char>(d.quote & 0xff));
  const __m256i vd = _mm256_set1_epi8(static_cast<char>(d.delim & 0xff));
  const __m256i v0 = _mm256_set1_epi8(static_cast<char>(d.nl0 & 0xff));
  const __m256i v1 = _mm256_set1_epi8(static_cast<char>(d.nl1 & 0xff));
  uint64_t carry = carry_in ? ~0ULL : 0ULL;
  const int64_t lim = n & ~63LL;
  int64_t k = 0;
  for (int64_t i = 0; i < lim; i += 64) {
    __m256i a =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i));
    __m256i b =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i + 32));
    uint64_t q = avx2_eq_mask(a, b, vq);
    __m256i sa = _mm256_or_si256(
        _mm256_cmpeq_epi8(a, vd),
        _mm256_or_si256(_mm256_cmpeq_epi8(a, v0), _mm256_cmpeq_epi8(a, v1)));
    __m256i sb = _mm256_or_si256(
        _mm256_cmpeq_epi8(b, vd),
        _mm256_or_si256(_mm256_cmpeq_epi8(b, v0), _mm256_cmpeq_epi8(b, v1)));
    uint64_t s = static_cast<uint32_t>(_mm256_movemask_epi8(sa)) |
                 (static_cast<uint64_t>(
                      static_cast<uint32_t>(_mm256_movemask_epi8(sb)))
                  << 32);
    uint64_t pin = prefix_xor_bits(q);
    uint64_t m = s & ~(pin ^ carry);
    // The plain tzcnt/blsr loop measured FASTEST here: branch-free 8x
    // unconditional writes (simdjson flatten / the reference's
    // reserve-64 trick, stage1.rs:211-292), two independent 32-bit
    // chains, and 32-bit staging were all measured equal-or-slower on
    // real corpus data (tools/ablate_native.py r4) — real CSV has
    // near-periodic structure, so the loop branch predicts well, and
    // this host is uop-throughput-bound (classify alone measures
    // ~4.9 GB/s 1T), not mispredict- or chain-latency-bound.
    if (m) {
      if (k + __builtin_popcountll(m) > cap) return -1;
      do {
        out[k++] = base + i + __builtin_ctzll(m);
        m &= m - 1;
      } while (m);
    }
    carry ^= static_cast<uint64_t>(-static_cast<int64_t>(pin >> 63));
  }
  *done = lim;
  *parity_io = static_cast<int>(carry & 1);
  return k;
}
#endif  // CSVIDX_X86

// Phase-A reduce for the threaded build: quote parity of the chunk plus
// the masked structural count under BOTH entry-parity hypotheses
// (cnt[p] = offsets the chunk emits if it starts with quote parity p).
// Within a chunk the block-carry chain under hypothesis 1 is the
// hypothesis-0 chain with every in-quote mask complemented, so one pass
// tracking the p=0 chain yields both counts: kept(p=0) = s & ~inq,
// kept(p=1) = s & inq. This is the reference's planned "speculative
// split" (README.md:24) made exact — the exclusive XOR scan between
// phases picks the real hypothesis, and phase B writes straight into
// the final output at exclusive-summed positions (no scratch, no
// compaction memcpy).
struct ChunkStat {
  int parity;
  int64_t cnt[2];
};

#ifdef CSVIDX_X86
__attribute__((target("avx2"))) static void chunk_counts_avx2(
    const uint8_t* data, int64_t n, const Dialect64& d, ChunkStat* st,
    int64_t* done) {
  const __m256i vq = _mm256_set1_epi8(static_cast<char>(d.quote & 0xff));
  const __m256i vd = _mm256_set1_epi8(static_cast<char>(d.delim & 0xff));
  const __m256i v0 = _mm256_set1_epi8(static_cast<char>(d.nl0 & 0xff));
  const __m256i v1 = _mm256_set1_epi8(static_cast<char>(d.nl1 & 0xff));
  uint64_t carry = 0;  // hypothesis-0 chain
  int64_t c0 = 0, c1 = 0;
  const int64_t lim = n & ~63LL;
  for (int64_t i = 0; i < lim; i += 64) {
    __m256i a =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i));
    __m256i b =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i + 32));
    uint64_t q = avx2_eq_mask(a, b, vq);
    __m256i sa = _mm256_or_si256(
        _mm256_cmpeq_epi8(a, vd),
        _mm256_or_si256(_mm256_cmpeq_epi8(a, v0), _mm256_cmpeq_epi8(a, v1)));
    __m256i sb = _mm256_or_si256(
        _mm256_cmpeq_epi8(b, vd),
        _mm256_or_si256(_mm256_cmpeq_epi8(b, v0), _mm256_cmpeq_epi8(b, v1)));
    uint64_t s = static_cast<uint32_t>(_mm256_movemask_epi8(sa)) |
                 (static_cast<uint64_t>(
                      static_cast<uint32_t>(_mm256_movemask_epi8(sb)))
                  << 32);
    uint64_t pin = prefix_xor_bits(q);
    uint64_t inq = pin ^ carry;
    c0 += __builtin_popcountll(s & ~inq);
    c1 += __builtin_popcountll(s & inq);
    carry ^= static_cast<uint64_t>(-static_cast<int64_t>(pin >> 63));
  }
  st->parity = static_cast<int>(carry & 1);
  st->cnt[0] = c0;
  st->cnt[1] = c1;
  *done = lim;
}
#endif  // CSVIDX_X86

static ChunkStat chunk_counts(const uint8_t* data, int64_t n,
                              const Dialect64& d) {
  ChunkStat st{0, {0, 0}};
  int64_t i = 0;
#ifdef CSVIDX_X86
  if (cpu_has_avx2() && n >= 64) {
    chunk_counts_avx2(data, n, d, &st, &i);
  }
#endif
  uint64_t carry = st.parity ? ~0ULL : 0ULL;
  int64_t c0 = st.cnt[0], c1 = st.cnt[1];
  for (; i + 8 <= n; i += 8) {
    uint64_t x;
    std::memcpy(&x, data + i, 8);
    uint64_t qf = swar_eq(x, d.quote);
    uint64_t sf = swar_eq(x, d.delim) | swar_eq(x, d.nl0) | swar_eq(x, d.nl1);
    uint64_t pin = prefix_xor_bytes(qf);
    uint64_t inq = pin ^ (carry & kHi1);
    c0 += __builtin_popcountll(sf & ~inq);
    c1 += __builtin_popcountll(sf & inq);
    carry ^= static_cast<uint64_t>(-static_cast<int64_t>(pin >> 63));
  }
  int par = static_cast<int>(carry & 1);
  for (; i < n; ++i) {
    uint8_t b = data[i];
    if (b == (d.quote & 0xff)) {
      par ^= 1;
    } else if (b == (d.delim & 0xff) || b == (d.nl0 & 0xff) ||
               b == (d.nl1 & 0xff)) {
      c0 += !par;
      c1 += par;
    }
  }
  st.parity = par;
  st.cnt[0] = c0;
  st.cnt[1] = c1;
  return st;
}

// Quote parity of [data, data+n) — the phase-A reduce.
static int chunk_quote_parity(const uint8_t* data, int64_t n, uint64_t quote) {
  int64_t i = 0;
  uint64_t par = 0;
#ifdef CSVIDX_X86
  if (cpu_has_avx2() && n >= 64) {
    int64_t done = 0;
    par = chunk_quote_parity_avx2(data, n, static_cast<uint8_t>(quote & 0xff),
                                  &done);
    i = done;
  }
#endif
  for (; i + 8 <= n; i += 8) {
    uint64_t x;
    std::memcpy(&x, data + i, 8);
    par ^= prefix_xor_bytes(swar_eq(x, quote)) >> 63;
  }
  int p = static_cast<int>(par & 1);
  for (; i < n; ++i) p ^= (data[i] == (quote & 0xff));
  return p;
}

// Stage-1 over [data, data+n), byte offsets rebased by +base. Returns the
// number of offsets written, or -1 if `cap` would be exceeded;
// *parity_out = quote parity after the chunk. The SWAR core; the
// dispatching wrapper below runs the AVX2 path first where available.
static int64_t chunk_stage1_swar(const uint8_t* data, int64_t n, int64_t base,
                                 const Dialect64& d, int carry_in,
                                 int64_t* out, int64_t cap, int* parity_out) {
  int64_t k = 0;
  uint64_t carry = carry_in ? ~0ULL : 0ULL;  // broadcast parity
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t x;
    std::memcpy(&x, data + i, 8);
    uint64_t qf = swar_eq(x, d.quote);
    uint64_t sf = swar_eq(x, d.delim) | swar_eq(x, d.nl0) | swar_eq(x, d.nl1);
    uint64_t pin = prefix_xor_bytes(qf);
    uint64_t inq = pin ^ (carry & kHi1);
    uint64_t m = sf & ~inq;
    if (m) {
      if (k + __builtin_popcountll(m) > cap) return -1;
      do {
        out[k++] = base + i + (__builtin_ctzll(m) >> 3);
        m &= m - 1;
      } while (m);
    }
    carry ^= static_cast<uint64_t>(-static_cast<int64_t>(pin >> 63));
  }
  int par = static_cast<int>(carry & 1);
  for (; i < n; ++i) {
    uint8_t b = data[i];
    if (b == (d.quote & 0xff)) par ^= 1;
    else if (!par && (b == (d.delim & 0xff) || b == (d.nl0 & 0xff) ||
                      b == (d.nl1 & 0xff))) {
      if (k >= cap) return -1;
      out[k++] = base + i;
    }
  }
  *parity_out = par;
  return k;
}

// ISA dispatch: AVX2 over the 64 B-aligned body, SWAR core for the rest.
static int64_t chunk_stage1(const uint8_t* data, int64_t n, int64_t base,
                            const Dialect64& d, int carry_in, int64_t* out,
                            int64_t cap, int* parity_out) {
#ifdef CSVIDX_X86
  if (cpu_has_avx2() && n >= 64) {
    int par = 0;
    int64_t done = 0;
    int64_t k = chunk_stage1_avx2(data, n, base, d, carry_in, out, cap, &par,
                                  &done);
    if (k < 0) return -1;
    if (done >= n) {
      *parity_out = par;
      return k;
    }
    int64_t k2 = chunk_stage1_swar(data + done, n - done, base + done, d, par,
                                   out + k, cap - k, parity_out);
    if (k2 < 0) return -1;
    return k + k2;
  }
#endif
  return chunk_stage1_swar(data, n, base, d, carry_in, out, cap, parity_out);
}

static const int kSigma[8] = {7, 3, 5, 1, 6, 2, 4, 0};  // 7 - bitrev3(j)

}  // namespace

extern "C" {

// CPU stage-1: data[n] -> ascending offsets into out[out_cap]. Returns
// the count, or -1 if out_cap would be exceeded (caller grows and
// retries — the reference's len/6 density heuristic applies). Parity
// after the buffer in *parity_out. n_threads <= 1 runs serially.
// Two-phase: chunk parities first, then parallel extraction with carried
// parity and exact offset rebasing — chunk boundaries may cut quoted
// regions.
int64_t host_stage1(const uint8_t* data, int64_t n, int delim, int quote,
                    int nl0, int nl1, int carry_in, int n_threads,
                    int64_t* out, int64_t out_cap, int* parity_out) {
  Dialect64 d{kOnes * static_cast<uint64_t>(delim),
              kOnes * static_cast<uint64_t>(quote),
              kOnes * static_cast<uint64_t>(nl0),
              kOnes * static_cast<uint64_t>(nl1)};
  if (n <= 0) {
    *parity_out = carry_in & 1;
    return 0;
  }
#if defined(__linux__) && defined(MADV_HUGEPAGE)
  // The caller hands a fresh hundreds-of-MB output buffer; with THP in
  // madvise mode (this rig) first-touch pays a 4 KiB fault per page
  // inside the hot extraction loop. Ask for 2 MiB faults instead —
  // harmless no-op where unsupported.
  if (out_cap >= (1 << 18)) {
    uintptr_t a = reinterpret_cast<uintptr_t>(out);
    uintptr_t pg = static_cast<uintptr_t>(sysconf(_SC_PAGESIZE));
    uintptr_t lo = a & ~(pg - 1);
    madvise(reinterpret_cast<void*>(lo),
            static_cast<size_t>(out_cap) * 8 + (a - lo), MADV_HUGEPAGE);
  }
#endif
  if (n_threads <= 1 || n < (1 << 20)) {
    return chunk_stage1(data, n, 0, d, carry_in & 1, out, out_cap,
                        parity_out);
  }
  const int t = n_threads;
  const int64_t chunk = (n + t - 1) / t;
  // phase A: per-chunk {quote parity, structural count under each entry-
  // parity hypothesis} — one read pass, no output traffic.
  std::vector<ChunkStat> st(t, ChunkStat{0, {0, 0}});
  {
    std::vector<std::thread> ths;
    for (int i = 0; i < t; ++i) {
      ths.emplace_back([&, i] {
        int64_t lo = i * chunk, hi = std::min<int64_t>(n, lo + chunk);
        if (hi > lo) st[i] = chunk_counts(data + lo, hi - lo, d);
      });
    }
    for (auto& th : ths) th.join();
  }
  // exclusive XOR scan of parities + exclusive SUM of the resolved
  // counts (the collectives, on host) -> exact output position per chunk.
  std::vector<int> carry(t, 0);
  std::vector<int64_t> pos(t, 0);
  int acc = carry_in & 1;
  int64_t total = 0;
  for (int i = 0; i < t; ++i) {
    carry[i] = acc;
    pos[i] = total;
    total += st[i].cnt[acc];
    acc ^= st[i].parity;
  }
  if (total > out_cap) return -1;  // exact requirement: caller grows once
  // phase B: parallel extraction straight into the final output — each
  // chunk's slot range is exact, so no scratch and no compaction pass.
  {
    std::vector<std::thread> ths;
    for (int i = 0; i < t; ++i) {
      ths.emplace_back([&, i] {
        int64_t lo = i * chunk, hi = std::min<int64_t>(n, lo + chunk);
        if (hi <= lo) return;
        int p;
        chunk_stage1(data + lo, hi - lo, lo, d, carry[i], out + pos[i],
                     st[i].cnt[carry[i]], &p);
      });
    }
    for (auto& th : ths) th.join();
  }
  *parity_out = acc;
  return total;
}

// Quote parity only (phase-A as a standalone export, for streaming).
int host_quote_parity(const uint8_t* data, int64_t n, int quote,
                      int carry_in) {
  return (carry_in & 1) ^
         chunk_quote_parity(data, n, kOnes * static_cast<uint64_t>(quote));
}

// Decode the v3 fold-pack layout (ops/stage1_v3.py): packed words
// (g_total, 128) int32; bit (8b + sigma(j)) of word (s*gp + g, lane)
// covers flat byte ((s*tile + j*gp + g)*128 + lane)*4 + b. Emits
// ascending absolute offsets (+base), never past cap entries and never
// an offset >= n_bytes (set bits in padding rows only exist in
// corrupted/foreign packed arrays — the kernel zero-pads — but this
// entry point must not trust its input into a heap overflow).
// Returns count, or -1 if the output would exceed cap.
int64_t extract_offsets_v3(const uint32_t* packed, int64_t g_total,
                           int64_t tile, int64_t n_bytes, int64_t base,
                           int64_t cap, int64_t* out) {
  const int64_t gp = tile / 8;
  const int64_t steps = g_total / gp;
  int64_t k = 0;
  for (int64_t s = 0; s < steps; ++s) {
    const uint32_t* step_words = packed + s * gp * 128;
    const int64_t step_byte0 = s * tile * 512;
    for (int64_t r = 0; r < tile; ++r) {
      const int64_t j = r / gp, g = r % gp;
      const uint32_t row_mask = 0x01010101u << kSigma[j];
      const uint32_t* wrow = step_words + g * 128;
      const int64_t row_byte0 = step_byte0 + r * 512;
      if (row_byte0 >= n_bytes) return k;
      for (int64_t lane = 0; lane < 128; ++lane) {
        uint32_t w = wrow[lane] & row_mask;
        while (w) {
          int bit = __builtin_ctz(w);
          const int64_t off = row_byte0 + lane * 4 + (bit >> 3);
          if (off < n_bytes) {
            if (k >= cap) return -1;
            out[k++] = base + off;
          }
          w &= w - 1;
        }
      }
    }
  }
  return k;
}

}  // extern "C"
