// The UTF-8 validator's error count for Hopper (sm_90a).
//
// Replaces csv_simd_tpu/ops/utf8.py `_utf8_errs_jit` (line 97), the JAX
// package's device validator. It is plain XLA, no pallas_call: XLA fuses its
// twenty-odd compares into one pass that reads each byte once, and this kernel
// is that pass. Its plain version, ops/utf8.py `_utf8_errs_plain`, is eager
// torch and makes an int32 copy of the input for every shifted stream.
//
// What it computes: the number of positions i where byte i breaks RFC 3629
// given bytes i-1, i-2 and i-3 (zero before the start): a continuation byte
// where none is due or none where one is due, an overlong form, a surrogate or
// a code point past U+10FFFF at the first continuation, or a byte >= 0xF5 (or
// 0xC0, 0xC1) before it; plus one for each of a[n-1] >= 0xC0, a[n-2] >= 0xE0
// and a[n-3] >= 0xF0 (a multi-byte sequence cut off by the end). Zero iff the
// bytes are valid UTF-8. The count is an int64, so no input size wraps it.
//
// What bounds it on an H100: HBM bandwidth for its bytes, one read of n bytes
// and one 8-byte write; on text that is not ASCII, its integer operations.
//
// What the design does about it. Each thread takes two 16-byte chunks a step
// (a warp 1 KiB), both loaded with 16-byte loads while the step before is
// checked. The three bytes before a chunk are the top of the previous chunk's
// last word, taken from the neighbouring lane by __shfl_up_sync (lane 0 of the
// first chunk loads one word; lane 0 of the second takes lane 31's first
// chunk). A warp whose kilobyte and the three bytes before each word are all
// below 0x80 has no error and goes on. Otherwise the words with a byte >= 0x80
// in them or in the three bytes before them need the full check. When they are
// few (text mostly ASCII), the warp lists them by ballot, each with its
// previous word, in shared memory, and spreads the list over its lanes: one
// check a few words, not one for every word of every warp that holds such a
// byte. When they are more than kDenseWords of the step's 256 (text in another
// script), each lane checks its own eight in place. The full check tests four
// bytes at once, against the previous bytes funnel-shifted into place: every
// RFC 3629 range is a test of a few bits of a byte, and shifting a word left
// by 7 - k brings bit k of all four bytes to their bit 7. __popc of the error
// bits counts the bad bytes; bytes past n are masked out. Warp and block
// reductions end in one atomicAdd a block. The check is integer work, not
// memory traffic, wherever text is not ASCII: a first version that checked
// each 16-byte chunk holding a byte >= 0x80 with the __vcmp*4 byte compares
// (several instructions each on this card) took 5x the byte bound.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunksPerThread = 2;  // 16-byte chunks a thread a step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpWords = 32 * kChunksPerThread * 4;  // 4-byte words a step
// past this many words to check in a warp's step, each lane checks its own
// (listing them costs about two checks a lane)
constexpr unsigned kDenseWords = 192;

constexpr uint32_t kHigh = 0x80808080u;  // bit 7 of each byte

// bit 7 of each byte of x set where it equals the same byte of k (exact:
// the add of the low seven bits cannot carry into the next byte)
__device__ __forceinline__ uint32_t eq_bytes(uint32_t x, uint32_t k) {
  const uint32_t y = x ^ k;
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & kHigh;
}

// bit 7 of each byte of `cur` set where that byte is an error, given the
// word before it; four bytes with one 32-bit operation a step.
__device__ __forceinline__ uint32_t word_errs(uint32_t prev, uint32_t cur) {
  // byte i of p_k is the byte k places before byte i of cur
  const uint32_t p1 = __funnelshift_l(prev, cur, 8);
  const uint32_t p2 = __funnelshift_l(prev, cur, 16);
  const uint32_t p3 = __funnelshift_l(prev, cur, 24);
  const uint32_t is_cont = cur & ~(cur << 1) & kHigh;       // 10xxxxxx
  // leads: 11xxxxxx, 111xxxxx and 1111xxxx, none of them 11111xxx
  const uint32_t c0_1 = p1 & (p1 << 1) & kHigh;
  const uint32_t f0_1 = c0_1 & (p1 << 2) & (p1 << 3);
  const uint32_t e0_2 = p2 & (p2 << 1) & (p2 << 2) & kHigh;
  const uint32_t f0_3 = p3 & (p3 << 1) & (p3 << 2) & (p3 << 3) & kHigh;
  // a 2-, 3- or 4-byte lead one back, a 3- or 4-byte lead two back, a
  // 4-byte lead three back
  const uint32_t must_cont = (c0_1 & ~(f0_1 & (p1 << 4))) |
                             (e0_2 & ~((p2 << 3) & (p2 << 4))) |
                             (f0_3 & ~(p3 << 4));
  // at the first continuation, whose bits 5 and 4 split its range: after
  // E0 it must be A0-BF (bit 5), after ED 80-9F, after F0 90-BF (bit 5 or
  // 4), after F4 80-8F. So the lead that makes it an error is E0 or ED as
  // bit 5 is clear or set, and F0 or F4 as bits 5 and 4 are clear or not.
  const uint32_t c5 = ((cur << 2) & kHigh) >> 7;            // 0 or 1 a byte
  const uint32_t c54 = (((cur << 2) | (cur << 3)) & kHigh) >> 7;
  const uint32_t bad_cont1 = eq_bytes(p1, 0xE0E0E0E0u ^ (c5 * 0x0D)) |
                             eq_bytes(p1, 0xF0F0F0F0u ^ (c54 * 0x04));
  // F5-FF: 1111xxxx with a low nibble >= 5
  const uint32_t ge5 = (((p1 & 0x0F0F0F0Fu) + 0x0B0B0B0Bu) << 3) & kHigh;
  return (is_cont ^ must_cont) | (bad_cont1 & is_cont) |
         eq_bytes(p1 & 0xFEFEFEFEu, 0xC0C0C0C0u)  // overlong 2B (C0, C1)
         | (f0_1 & ge5);                    // invalid lead
}

// the 16 bytes from byte0, zero past n
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ data,
                                            long long n, long long byte0) {
  if (byte0 + 16 <= n) {
    return __ldg(reinterpret_cast<const uint4*>(data + byte0));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && byte0 + i < n; ++i) {
    w[i >> 2] |= (uint32_t)data[byte0 + i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 0xffffffff, or the bytes of the word at byte `at` that lie below n
__device__ __forceinline__ uint32_t valid_bytes(long long n, long long at) {
  const long long left = n - at;
  if (left >= 4) return kFull;
  if (left <= 0) return 0u;
  return (1u << (8 * (int)left)) - 1u;
}

// the first byte of word k of the lane's chunks ca (k < 4) and cb
__device__ __forceinline__ long long word_at(long long ca, long long cb,
                                             int k) {
  return 16 * (k < 4 ? ca : cb) + 4 * (k & 3);
}

// a word to check in full: the word, the word before it, its bytes below n
struct Pending {
  uint32_t prev[kWarpWords], cur[kWarpWords], valid[kWarpWords];
};

__global__ void __launch_bounds__(kThreads, 4)
utf8_errs(const uint8_t* __restrict__ data, long long n,
          unsigned long long* __restrict__ count) {
  __shared__ Pending s_pending[kWarps];  // 3 KiB a warp
  __shared__ unsigned long long s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned lanes_below;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lanes_below));
  Pending& pending = s_pending[warp];
  const long long n_chunks = (n + 15) / 16;
  const long long step = (long long)gridDim.x * kThreads * kChunksPerThread;
  // below 2^32: at most one error a byte, and a warp reads n over the grid's
  // warps, tens of MiB of a card's memory
  unsigned errs = 0;
  // the warp's 64 chunks a step: c0 + lane and c0 + 32 + lane, each step's
  // loads issued before the step before it is checked
  long long c0 = ((long long)blockIdx.x * kWarps + warp) * 64;
  uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
  uint32_t before = 0;  // lane 0: the word before chunk c0
  if (c0 < n_chunks) {
    va = load_chunk(data, n, 16 * (c0 + lane));
    vb = load_chunk(data, n, 16 * (c0 + 32 + lane));
    if (lane == 0 && c0 > 0) {
      before = __ldg(reinterpret_cast<const uint32_t*>(data + 16 * c0) - 1);
    }
  }
  for (; c0 < n_chunks; c0 += step) {
    const long long ca = c0 + lane, cb = ca + 32, next = c0 + step;
    uint4 na = make_uint4(0u, 0u, 0u, 0u), nb = na;
    uint32_t next_before = 0;
    if (next < n_chunks) {
      na = load_chunk(data, n, 16 * (next + lane));
      nb = load_chunk(data, n, 16 * (next + 32 + lane));
      if (lane == 0) {
        next_before =
            __ldg(reinterpret_cast<const uint32_t*>(data + 16 * next) - 1);
      }
    }
    uint32_t pa = __shfl_up_sync(kFull, va.w, 1);
    uint32_t pb = __shfl_up_sync(kFull, vb.w, 1);
    const uint32_t a_last = __shfl_sync(kFull, va.w, 31);
    if (lane == 0) {
      pa = before;
      pb = a_last;
    }
    // the lane's eight words and the word before each
    const uint32_t w[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
    const uint32_t p[8] = {pa, va.x, va.y, va.z, pb, vb.x, vb.y, vb.z};
    uint32_t high = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) high |= (p[k] & 0x80808000u) | w[k];
    // a step that is ASCII after ASCII has no error
    if (__any_sync(kFull, high & kHigh)) {
      // the words with a byte >= 0x80 in them or in the three bytes before
      // them; only the step that reaches past n (the same for the whole
      // warp) masks bytes
      const bool ragged = 16 * c0 + 1024 > n;
      uint32_t need = 0;  // bit k: word k needs the full check
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool word_high = ((p[k] & 0x80808000u) | w[k]) & kHigh;
        const bool inside = !ragged || word_at(ca, cb, k) < n;
        need |= (word_high && inside) ? 1u << k : 0u;
      }
      if (__reduce_add_sync(kFull, __popc(need)) > kDenseWords) {
        // dense text: each lane checks its own eight words (an ASCII word
        // after ASCII bytes checks clean)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint32_t e = word_errs(p[k], w[k]);
          if (ragged) e &= valid_bytes(n, word_at(ca, cb, k));
          errs += __popc(e);
        }
      } else {
        // sparse: list the words by ballot, then spread them over the lanes
        int listed = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const unsigned voted = __ballot_sync(kFull, need & (1u << k));
          if (need & (1u << k)) {
            const int slot = listed + __popc(voted & lanes_below);
            pending.prev[slot] = p[k];
            pending.cur[slot] = w[k];
            if (ragged) {
              pending.valid[slot] = valid_bytes(n, word_at(ca, cb, k));
            }
          }
          listed += __popc(voted);
        }
        __syncwarp();
        for (int i = lane; i < listed; i += 32) {
          uint32_t e = word_errs(pending.prev[i], pending.cur[i]);
          if (ragged) e &= pending.valid[i];
          errs += __popc(e);
        }
        __syncwarp();
      }
    }
    va = na;
    vb = nb;
    before = next_before;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // a multi-byte sequence cut off by the end
    errs += (data[n - 1] >= 0xC0) + (n >= 2 && data[n - 2] >= 0xE0) +
            (n >= 3 && data[n - 3] >= 0xF0);
  }
  unsigned long long warp_total = errs;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    warp_total += __shfl_xor_sync(kFull, warp_total, off);
  }
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_warp[i];
    if (total) atomicAdd(count, total);
  }
}

}  // namespace

extern "C" {

// data: n > 0 bytes, 16-byte aligned; count: one int64, set to the error
// count. Returns cudaGetLastError() after the launch.
int csv_utf8_errs(const void* data, long long n, void* count, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(data) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)kThreads * kChunksPerThread;
  const long long n_chunks = (n + 15) / 16;
  long long blocks = (n_chunks + per_block - 1) / per_block;
  if (blocks > 4LL * sms) blocks = 4LL * sms;  // four resident blocks an SM
  utf8_errs<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(data), n,
      static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"
