// Kernel E1: B3's fold-layout words -> the int32 structural index, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package copies B3's words to the host and
// decodes them there (csv_simd_tpu/native `extract_offsets_v3`); its only
// compaction on a device is XLA's `nonzero` over an unpacked byte mask
// (csv_simd_tpu/ops/compact.py), which is too slow on a TPU to serve the
// offsets route. Here the card keeps the index the DeviceTape serves from,
// and the host gets its int64 copy in one transfer (index.py).
//
// What it computes: out[0] = 0, then every structural byte offset below
// n_bytes in ascending order, as native `extract_offsets_v3` decodes the
// fold layout: for fold tile `tile` (gp = tile / 8 word rows a step), bit
// 8b + sigma(j) of word (s * gp + g, lane) covers byte
// (s * tile + j * gp + g) * 512 + lane * 4 + b, sigma = [7,3,5,1,6,2,4,0].
// A set bit at or past n_bytes is dropped: the kernel does not trust its
// words, and no write passes the output's capacity. Offsets are int32, so
// n_bytes < 2^31.
//
// What bounds it on an H100: HBM bandwidth. It reads the words twice (1/8
// of the input bytes each time) and writes 4 bytes an offset. At TPC-H
// LINEITEM SF 1 (0.76 GB, about 96 M offsets) that is about 190 MB read and
// 384 MB written, 0.17 ms at 3.35 TB/s.
//
// What the design does about it: two passes over the words with one host
// read of the total between them, since the output is sized by it.
//   1. `fold_count`, a block a fold step: a warp loads a word row as one
//      16-byte load a lane (bytes 16 lane .. 16 lane + 15 of the row's eight
//      input rows), masks each input row's bits, and a butterfly of
//      __shfl_xor_sync sums them; each input row's count goes to `counts`,
//      the step's total to `step_total`. One block then scans the step
//      totals (scan.cuh, as prefix.cu does) and writes the grand total.
//   2. `fold_emit`, a block a fold step: the block scans its step's row
//      counts in input-row order into each row's first slot, in place; then
//      each warp takes word rows again, and for each of the eight input rows
//      a __shfl_up_sync scan of the lanes' popcounts gives each lane its
//      slot, and the lane writes its bits in ascending order (__ffs). The
//      offsets of one input row land contiguously, a warp's writes together.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// sigma(j) = 7 - bitrev3(j): the bit that input row segment j holds in each
// byte of a fold word
__device__ __forceinline__ int sigma(int j) {
  return 7 - (((j & 1) << 2) | (j & 2) | ((j >> 2) & 1));
}

// The bytes of a word whose first byte lies `rel` bytes into the input row,
// as a mask of whole bytes, given that the row has `lim` bytes below n_bytes.
__device__ __forceinline__ uint32_t bytes_below(long long lim, int rel) {
  const long long nb = lim - rel;
  if (nb >= 4) return kFull;
  if (nb <= 0) return 0u;
  return (1u << (8 * nb)) - 1u;
}

// The structural bits of input row segment j in this lane's four words,
// those at or past n_bytes cleared; lim = n_bytes - the row's first byte.
__device__ __forceinline__ void row_bits(const uint4& q, int j, long long lim,
                                         int lane, uint32_t m[4]) {
  const uint32_t sel = 0x01010101u << sigma(j);
  const int rel = 16 * lane;
  m[0] = q.x & sel & bytes_below(lim, rel);
  m[1] = q.y & sel & bytes_below(lim, rel + 4);
  m[2] = q.z & sel & bytes_below(lim, rel + 8);
  m[3] = q.w & sel & bytes_below(lim, rel + 12);
}

__device__ __forceinline__ int popc4(const uint32_t m[4]) {
  return __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
}

__device__ __forceinline__ int warp_sum(int c) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
  return c;
}

__global__ void __launch_bounds__(kThreads)
fold_count(const uint4* __restrict__ words, int gp, int tile,
           long long n_bytes, int* __restrict__ counts,
           int* __restrict__ step_total) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = blockIdx.x;
  const long long row0 = step * tile;  // the step's first input row
  int mine = 0;
  for (int g = warp; g < gp; g += kWarps) {
    const uint4 q = words[(step * gp + g) * 32 + lane];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long row = row0 + (long long)j * gp + g;
      uint32_t m[4];
      row_bits(q, j, n_bytes - row * 512, lane, m);
      const int c = warp_sum(popc4(m));
      if (lane == 0) counts[row] = c;
      mine += c;
    }
  }
  if (lane == 0) s_warp[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_warp[i];
    step_total[step] = total;
  }
}

__global__ void __launch_bounds__(csv_scan::kThreads)
step_offset_scan(const int* __restrict__ step_total,
                 int* __restrict__ step_offset, int steps,
                 int* __restrict__ total) {
  csv_scan::exclusive_scan_one_block<csv_scan::Plus>(
      step_total, step_offset, steps, 0, total);
}

__global__ void __launch_bounds__(kThreads)
fold_emit(const uint4* __restrict__ words, int gp, int tile,
          long long n_bytes, int* __restrict__ counts,
          const int* __restrict__ step_offset, int* __restrict__ out,
          long long capacity) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = blockIdx.x;
  const long long row0 = step * tile;
  if (step == 0 && threadIdx.x == 0) out[0] = 0;
  // the step's row counts -> each row's first slot, in input-row order
  int run = step_offset[step];
  for (int base = 0; base < tile; base += kThreads) {
    const int r = base + threadIdx.x;
    const int c = r < tile ? counts[row0 + r] : 0;
    const int incl = csv_scan::warp_inclusive_scan<csv_scan::Plus>(c, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int w = s_warp[i];
      before += (i < warp) ? w : 0;
      chunk += w;
    }
    if (r < tile) counts[row0 + r] = run + before + incl - c;
    run += chunk;
    // s_warp is read again next round; the slots are read below
    __syncthreads();
  }
  for (int g = warp; g < gp; g += kWarps) {
    const uint4 q = words[(step * gp + g) * 32 + lane];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long row = row0 + (long long)j * gp + g;
      uint32_t m[4];
      row_bits(q, j, n_bytes - row * 512, lane, m);
      const int c = popc4(m);
      const int incl = csv_scan::warp_inclusive_scan<csv_scan::Plus>(c, lane);
      // out[0] is the sentinel: slot k of the offsets is out[1 + k]
      long long slot = 1 + (long long)counts[row] + incl - c;
      const int byte0 = (int)(row * 512) + 16 * lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t w = m[k];
        while (w) {
          const int bit = __ffs(w) - 1;
          if (slot <= capacity) out[slot] = byte0 + 4 * k + (bit >> 3);
          ++slot;
          w &= w - 1;
        }
      }
    }
  }
}

bool bad_shape(const void* words, long long g_total, long long tile,
               long long n_bytes) {
  return g_total <= 0 || tile <= 0 || tile % 8 || (g_total * 8) % tile ||
         g_total > (1LL << 27) || n_bytes < 0 || n_bytes >= (1LL << 31) ||
         reinterpret_cast<uintptr_t>(words) % 16;
}

}  // namespace

extern "C" {

// Scratch ints for `steps` fold steps: step totals, step offsets, the total.
long long csv_fold_offsets_scratch(long long steps) { return 2 * steps + 1; }

// Pass 1. words: (g_total, 128) int32 fold-layout words at fold tile `tile`
// rows (a multiple of 8 dividing g_total * 8), 16-byte aligned; counts:
// g_total * 8 ints; scratch: csv_fold_offsets_scratch(g_total * 8 / tile)
// ints, whose last gets the number of offsets below n_bytes. Returns
// cudaGetLastError() after the launches.
int csv_fold_offsets_count(const void* words, long long g_total,
                           long long tile, long long n_bytes, void* counts,
                           void* scratch, void* stream) {
  if (bad_shape(words, g_total, tile, n_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long steps = g_total * 8 / tile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* step_total = static_cast<int*>(scratch);
  int* step_offset = step_total + steps;
  cudaError_t err;
  fold_count<<<(unsigned)steps, kThreads, 0, st>>>(
      static_cast<const uint4*>(words), (int)(tile / 8), (int)tile, n_bytes,
      static_cast<int*>(counts), step_total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  step_offset_scan<<<1, csv_scan::kThreads, 0, st>>>(
      step_total, step_offset, (int)steps, step_offset + steps);
  return (int)cudaGetLastError();
}

// Pass 2, after pass 1 on the same words, counts and scratch: out gets
// capacity + 1 ints, the 0 and then the offsets (capacity: pass 1's total).
// Overwrites counts with each input row's first slot.
int csv_fold_offsets_emit(const void* words, long long g_total,
                          long long tile, long long n_bytes, void* counts,
                          const void* scratch, void* out, long long capacity,
                          void* stream) {
  if (bad_shape(words, g_total, tile, n_bytes) || capacity < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long steps = g_total * 8 / tile;
  fold_emit<<<(unsigned)steps, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), (int)(tile / 8), (int)tile, n_bytes,
      static_cast<int*>(counts), static_cast<const int*>(scratch) + steps,
      static_cast<int*>(out), capacity);
  return (int)cudaGetLastError();
}

}  // extern "C"
