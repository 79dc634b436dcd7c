// Rank-select on the packed tape for Hopper (sm_90a): K1 `kth_positions`,
// the flat byte positions of the k-th set bits of the packed structural
// words, and K2 `serve_packed`, the whole batched serve of (record, field)
// queries on that tape, both on one row search and one in-word select.
//
// K1 replaces csv_simd_tpu/offsetfree.py `_kth_positions` (line 215). It is
// XLA code, no pallas_call: a searchsorted on the row prefix, a gather of each
// hit row's 16 words into a (Q, 16) array, a popcount, a cumsum along the 16
// words and the select of the bit, which XLA fuses. The port's plain
// version, offsetfree.py `_kth_positions_plain`, is eager torch:
// about 176 launches a call, and several (Q, 16) int32 temporaries written to
// and read from device memory, most of its time in torch's scan along the
// 16-wide axis.
//
// What K1 computes: for each k, out = row * 512 + bit, where row is the
// upper bound of k in the inclusive row prefix `cum` (rows entries: the set
// bits in rows 0..r) and bit the position (0..511) of the set bit of rank
// k - cum[row - 1] in that row's 16 words (bit m of word w covers byte
// 32 w + m). The narrow (rows, 16) and wide (rows/8, 128) layouts are the
// same memory, so one kernel serves both. For 0 <= k < total the answer is
// the plain version's, bit for bit. For any other k the answer is
// unspecified, as the plain version's is, and the kernel still reads only
// inside the index: it clamps the row to the last one, as the plain
// version's gather does. The answer is int32 for words that cover fewer
// than 2^31 bytes and int64 from there (`device_tape._position_dtype`):
// one kernel, instantiated for both, whose int32 answers wrap as torch's
// int32 arithmetic does.
//
// What bounds K1 on an H100: the latency of the binary search's dependent
// loads, about log2(rows) of them a query (21 for TPC-H LINEITEM at SF 1,
// 22 for a month of NYC taxi trips). The prefix (6-16 MB) stays in the 50 MB
// L2. The bytes are a query's k and answer, 8 bytes, and once each row of
// words, 64 bytes; a column of 6 M records is 12 M queries, about 0.2 GB.
//
// What the design does about it: one thread a query, everything in
// registers and nothing written but the answer. A column gather passes
// its queries sorted, so the threads of a warp search for neighbouring k:
// their searches take the same top levels, one L2 transaction a level for
// the warp, and their rows' loads coalesce. The row comes in four 16-byte
// loads; a running __popc over its words finds the word, and five halving
// steps the bit inside it, with no (Q, 16) intermediate and no second pass.
//
// K2 replaces csv_simd_tpu/offsetfree.py `_serve` (line 249), XLA code too:
// the validity rule and slot arithmetic, `_kth_positions` on the start and
// end bits of every query, and the (N, max_len) byte window. The port's
// plain version, offsetfree.py `_serve_plain`, is about 26 torch launches a
// call around K1, and the window alone writes and rereads an (N, max_len)
// int32 grid of positions and two masks, about 27 bytes per output byte.
//
// What K2 computes, for query i with record r and field f: valid when
// 0 <= r < record_cnt - 1 and 0 <= f < field_cnt; then slot = (r + 1) *
// jump + f, start = pos(slot - 1) + 1, end = pos(slot), lengths[i] = end -
// start (the TRUE length, beyond max_len too) and out[i, j] = data[start +
// j] for j < min(length, max_len), 0 past it. An invalid query reads nothing
// and answers zeros and length 0. Reads are clamped into [0, n_bytes).
// Positions are int32 or int64 as K1's, by the same template. The one
// difference from the plain version: its validity test `records + 1 <
// record_cnt` wraps in int32 at r = 2^31 - 1 and takes that record as valid
// (with unspecified bytes); K2 takes it as invalid.
//
// What bounds K2: for a lookup batch (19,456 queries) the launch itself,
// a few microseconds; for a column of 6 M records the search's dependent
// loads, as K1's, then the output: max_len + 5 bytes a query written, and
// the window's bytes read. The design: one thread a query for the start's
// search (K1's), and no second search for the end in the common case: the
// end's rank is the start's plus one, so it is the next set bit after the
// start's, in the row already in registers unless the start was its row's
// last bit; only then does the thread gallop forward from the next row, one
// load in the usual case of a field that ends in the next row. The warp's
// 32 queries own 32 x max_len contiguous output bytes (16-byte aligned,
// since 32 x max_len is a multiple of 16): the lanes write them as 16-byte
// stores in turn, each byte's (start, kept length) fetched from the lane
// that owns its query by a shuffle, with byte stores only for the ragged
// tail of the last warp.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;

// Position (0..31) of the set bit of rank j (0-based) in w: five halving
// steps over the popcounts of the low halves, as offsetfree._select_bit.
__device__ __forceinline__ unsigned select_bit(uint32_t w, int j) {
  unsigned pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const uint32_t low = w & ((1u << width) - 1u);
    const int c = __popc(low);
    const bool high = j >= c;
    j -= high ? c : 0;
    pos += high ? width : 0;
    w = high ? (w >> width) : low;
  }
  return pos;
}

// The first row in [lo, lo + len) whose inclusive prefix exceeds k, or
// lo + len where there is none: a binary search, one dependent load a
// level.
__device__ __forceinline__ int upper_row(const int* __restrict__ cum, int lo,
                                         int len, int k) {
  while (len > 0) {
    const int half = len >> 1;
    const bool right = __ldg(cum + lo + half) <= k;
    lo = right ? lo + half + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo;
}

// The first row from lo on whose inclusive prefix exceeds k, or rows,
// given that every row before lo has a prefix of at most k: probes at lo,
// lo + 1, lo + 3, lo + 7, ... until one exceeds k, then the binary search
// between the last two probes.
__device__ __forceinline__ int gallop_row(const int* __restrict__ cum, int lo,
                                          int rows, int k) {
  int hi = rows;
  for (long long step = 1;; step <<= 1) {
    const long long p = lo + step - 1;
    if (p >= rows) break;
    if (__ldg(cum + p) > k) {
      hi = (int)p;
      break;
    }
    lo = (int)p + 1;
  }
  return upper_row(cum, lo, hi - lo, k);
}

// A row's 16 words in four 16-byte loads.
__device__ __forceinline__ void load_row(const uint4* __restrict__ words,
                                         int row, uint32_t (&w)[16]) {
  const uint4* src = words + (long long)row * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = __ldg(src + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

// Position (0..511) of the set bit of rank j in a row's words: a running
// __popc finds the word, select_bit the bit in it.
__device__ __forceinline__ unsigned select_in_row(const uint32_t (&w)[16],
                                                  int j) {
  // g: the words whose inclusive running count is at most j; before: that
  // count; hit: word g (the last word when g is 16, as the plain version
  // clamps it)
  int run = 0, g = 0, before = 0;
  uint32_t hit = w[0];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    run += __popc(w[q]);
    if (run <= j) {
      g = q + 1;
      before = run;
    }
  }
#pragma unroll
  for (int q = 1; q < 16; ++q) hit = (g >= q) ? w[q] : hit;
  return (unsigned)g * 32u + select_bit(hit, j - before);
}

// Position (0..511) of the first set bit of a row's words after bit
// `after` (-1: the row's first), or 512 where there is none.
__device__ __forceinline__ int next_in_row(const uint32_t (&w)[16],
                                           int after) {
  int found = 512;
#pragma unroll
  for (int q = 15; q >= 0; --q) {
    const int s = after - 32 * q;  // `after`'s place in word q
    const uint32_t m =
        s < 0 ? w[q] : (s < 31 ? w[q] & (~1u << s) : 0u);
    found = m ? 32 * q + __ffs(m) - 1 : found;
  }
  return found;
}

// The flat byte position of bit `bit` of row `row`; int32 arithmetic
// wraps as torch's does.
template <typename Pos>
__device__ __forceinline__ Pos position(int row, unsigned bit) {
  if constexpr (sizeof(Pos) == 8) {
    return (long long)row * 512 + bit;
  } else {
    return (int)((unsigned)row * 512u + bit);
  }
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
kth_positions(const uint4* __restrict__ words, const int* __restrict__ cum,
              int rows, const int* __restrict__ ks, long long n,
              Out* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = __ldg(ks + i);
  const int row = upper_row(cum, 0, rows, k);
  const int j = k - (row > 0 ? __ldg(cum + row - 1) : 0);
  uint32_t w[16];
  load_row(words, min(row, rows - 1), w);
  out[i] = position<Out>(row, select_in_row(w, j));
}

template <typename Pos>
__global__ void __launch_bounds__(kThreads)
serve_packed(const uint4* __restrict__ words, const int* __restrict__ cum,
             int rows, const uint8_t* __restrict__ data, long long n_bytes,
             const int* __restrict__ records, const int* __restrict__ fields,
             long long n, int jump, int field_cnt, long long record_cnt,
             int max_len, uint8_t* __restrict__ out,
             int* __restrict__ lengths, uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long first = i - lane;  // the warp's first query
  if (first >= n) return;            // the whole warp: no query of its own
  // the query's start and the bytes of it the window keeps
  Pos start = 0;
  int keep = 0;
  if (i < n) {
    const int r = __ldg(records + i), f = __ldg(fields + i);
    const bool ok = r >= 0 && (long long)r + 1 < record_cnt && f >= 0 &&
                    f < field_cnt;
    int length = 0;
    if (ok) {
      // slot < record_cnt * jump, the structural count: below 2^31
      const int slot = (r + 1) * jump + f;
      const int row = upper_row(cum, 0, rows, slot - 1);
      const int j = slot - 1 - (row > 0 ? __ldg(cum + row - 1) : 0);
      uint32_t w[16];
      load_row(words, min(row, rows - 1), w);
      const int bit = (int)select_in_row(w, j);
      // the end, rank slot: the next set bit, in this row unless the
      // start was the row's last
      int end_row = row;
      int end_bit = next_in_row(w, bit);
      if (end_bit == 512) {
        end_row = gallop_row(cum, row + 1, rows, slot);
        load_row(words, min(end_row, rows - 1), w);
        end_bit = next_in_row(w, -1);
      }
      start = position<Pos>(row, (unsigned)bit) + 1;
      length = (int)(position<Pos>(end_row, (unsigned)end_bit) - start);
      keep = max(0, min(length, max_len));
    }
    lengths[i] = length;
    valid[i] = ok ? 1 : 0;
  }
  // the warp's nq queries own region bytes of out from first * max_len;
  // every lane runs every round, for the shuffles
  const int nq = (int)min(32LL, n - first);
  const long long region = (long long)nq * max_len;
  uint8_t* dst = out + first * max_len;
  for (long long o = 16LL * lane; o - 16LL * lane < region; o += 16 * 32) {
    // the query and column of the chunk's first byte
    int q = (int)(o / max_len);
    int col = (int)(o - (long long)q * max_len);
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int owner = min(q, 31);
      const Pos s = __shfl_sync(kFullWarp, start, owner);
      const int kept = __shfl_sync(kFullWarp, keep, owner);
      if (q < nq && col < kept) {
        const long long p =
            min(max((long long)s + col, 0LL), n_bytes - 1);
        word[t >> 2] |= (uint32_t)__ldg(data + p) << (8 * (t & 3));
      }
      if (++col == max_len) {
        col = 0;
        ++q;
      }
    }
    if (o + 16 <= region) {
      *reinterpret_cast<uint4*>(dst + o) =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else if (o < region) {
      const long long rest = region - o;
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if (t < rest) dst[o + t] = (uint8_t)(word[t >> 2] >> (8 * (t & 3)));
    }
  }
}

}  // namespace

extern "C" {

// words: rows * 16 int32, 16-byte aligned; cum: rows int32, the inclusive
// row prefix; ks: n int32; out: n int32, or n int64 when wide is not 0.
// Launches nothing for n == 0. Returns cudaGetLastError() after the launch.
int csv_kth_positions(const void* words, const void* cum, long long rows,
                      const void* ks, long long n, void* out, int wide,
                      void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (rows <= 0 || rows > 0x7fffffffLL || n < 0 ||
      reinterpret_cast<uintptr_t>(words) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* w = static_cast<const uint4*>(words);
  const int* c = static_cast<const int*>(cum);
  const int* k = static_cast<const int*>(ks);
  if (wide)
    kth_positions<long long><<<(unsigned)blocks, kThreads, 0, st>>>(
        w, c, (int)rows, k, n, static_cast<long long*>(out));
  else
    kth_positions<int><<<(unsigned)blocks, kThreads, 0, st>>>(
        w, c, (int)rows, k, n, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// words, cum as csv_kth_positions'; data: n_bytes uint8 (at least one);
// records, fields: n int32; out: n * max_len uint8, 16-byte aligned;
// lengths: n int32; valid: n bytes of 0 or 1. Positions are int64 when
// wide is not 0. Launches nothing for n == 0. Returns cudaGetLastError()
// after the launch.
int csv_serve_packed(const void* words, const void* cum, long long rows,
                     const void* data, long long n_bytes,
                     const void* records, const void* fields, long long n,
                     int jump, int field_cnt, long long record_cnt,
                     int max_len, void* out, void* lengths, void* valid,
                     int wide, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (rows <= 0 || rows > 0x7fffffffLL || n < 0 || n_bytes <= 0 ||
      jump <= 0 || max_len < 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* w = static_cast<const uint4*>(words);
  const int* c = static_cast<const int*>(cum);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const int* r = static_cast<const int*>(records);
  const int* f = static_cast<const int*>(fields);
  uint8_t* o = static_cast<uint8_t*>(out);
  int* len = static_cast<int*>(lengths);
  uint8_t* v = static_cast<uint8_t*>(valid);
  if (wide)
    serve_packed<long long><<<(unsigned)blocks, kThreads, 0, st>>>(
        w, c, (int)rows, d, n_bytes, r, f, n, jump, field_cnt, record_cnt,
        max_len, o, len, v);
  else
    serve_packed<int><<<(unsigned)blocks, kThreads, 0, st>>>(
        w, c, (int)rows, d, n_bytes, r, f, n, jump, field_cnt, record_cnt,
        max_len, o, len, v);
  return (int)cudaGetLastError();
}

}  // extern "C"
