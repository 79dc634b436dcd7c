// Rank-select on the packed tape for Hopper (sm_90a): the flat byte
// positions of the k-th set bits of the packed structural words.
//
// Replaces csv_simd_tpu/offsetfree.py `_kth_positions` (line 215). It is XLA
// code, no pallas_call: a searchsorted on the row prefix, a gather of each
// hit row's 16 words into a (Q, 16) array, a popcount, a cumsum along the 16
// words and the select of the bit, which XLA fuses. The port's plain
// version, offsetfree.py `_kth_positions_plain`, is eager torch:
// about 176 launches a call, and several (Q, 16) int32 temporaries written to
// and read from device memory, most of its time in torch's scan along the
// 16-wide axis.
//
// What it computes: for each k, out = row * 512 + bit, where row is the
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
// What bounds it on an H100: the latency of the binary search's dependent
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
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

template <typename Out>
__global__ void __launch_bounds__(kThreads)
kth_positions(const uint4* __restrict__ words, const int* __restrict__ cum,
              int rows, const int* __restrict__ ks, long long n,
              Out* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = __ldg(ks + i);
  // the upper bound: the first row whose inclusive prefix exceeds k
  int lo = 0, len = rows;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = __ldg(cum + lo + half) <= k;
    lo = right ? lo + half + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  const int row = lo;
  const int j = k - (row > 0 ? __ldg(cum + row - 1) : 0);
  const uint4* src = words + (long long)min(row, rows - 1) * 4;
  uint32_t w[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = __ldg(src + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
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
  const unsigned bit = (unsigned)g * 32u + select_bit(hit, j - before);
  if constexpr (sizeof(Out) == 8) {
    out[i] = (long long)row * 512 + bit;
  } else {
    // int32 arithmetic that wraps as torch's does
    out[i] = (int)((unsigned)row * 512u + bit);
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

}  // extern "C"
