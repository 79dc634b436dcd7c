// The classify-and-carry core shared by every stage-1 kernel (B1 in
// stage1_v4.cu; B3, B5 and B6 in stage1_pack.cu) and by the stage-cut probe
// (probe_ablate.cu).
//
// All of them compute one mask over the input's flat byte stream: a byte is
// kept iff it is a delimiter or newline outside quotes, where in-quote is the
// inclusive prefix XOR of the quote bytes XOR the carry-in. They differ only
// in how the kept bits are packed into words.
//
// The TPU kernels carried the quote parity through SMEM because their grid
// runs in order; blocks here run in parallel, so the carry takes two passes:
//   pass A  `chunk_parity`: each block reduces the quote parity (and, for B1,
//           the non-ASCII count) of its chunk of whole 4 KiB steps;
//   scan    `chunk_carry_scan`: one block turns the chunk parities into each
//           chunk's incoming carry (an exclusive XOR scan seeded with the
//           carry-in, read from device memory when the caller passes a
//           pointer) and writes the parity out;
//   pass B  each layout's kernel walks its chunk again in 4 KiB steps, and
//           `step_mask` gives each thread the 16-bit mask of its 16 bytes
//           (`step_carry`, its carry step, also serves the stage-cut probe
//           in probe_ablate.cu).
// A step is 256 threads x 16 bytes: loads are one uint4 a thread, neighbours
// on neighbouring addresses. The classify compares bytes with __vcmpeq4,
// which serves ASCII and non-ASCII dialects alike.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStepBytes = kThreads * 16;  // 4 KiB per block step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStructural = 5;  // the delimiter and up to four newlines

struct ByteClasses {
  uint32_t quote;                  // the quote byte in all four byte lanes
  uint32_t structural[kMaxStructural];
};

// __vcmpeq4 result (0xff per equal byte) -> 4-bit mask, byte k -> bit k.
// The multiplier 0x00204081 (bits 0, 7, 14, 21) moves flag bits 7/15/23/31
// to 28..31; every other product lands on its own bit below 28, so no carry
// reaches them.
__device__ __forceinline__ uint32_t nibble(uint32_t cmp) {
  return ((cmp & 0x80808080u) * 0x00204081u) >> 28;
}

__device__ __forceinline__ uint32_t quote16(const uint4 v, const ByteClasses& c) {
  return nibble(__vcmpeq4(v.x, c.quote)) |
         (nibble(__vcmpeq4(v.y, c.quote)) << 4) |
         (nibble(__vcmpeq4(v.z, c.quote)) << 8) |
         (nibble(__vcmpeq4(v.w, c.quote)) << 12);
}

__device__ __forceinline__ uint32_t structural4(uint32_t w, const ByteClasses& c) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < kMaxStructural; ++i) m |= __vcmpeq4(w, c.structural[i]);
  return nibble(m);
}

__device__ __forceinline__ uint32_t structural16(const uint4 v, const ByteClasses& c) {
  return structural4(v.x, c) | (structural4(v.y, c) << 4) |
         (structural4(v.z, c) << 8) | (structural4(v.w, c) << 12);
}

__device__ __forceinline__ uint32_t high_bytes16(const uint4 v) {
  return __popc(v.x & 0x80808080u) + __popc(v.y & 0x80808080u) +
         __popc(v.z & 0x80808080u) + __popc(v.w & 0x80808080u);
}

// Pass A: quote parity (and optionally the bit-7 byte count) of each chunk of
// `steps` 4 KiB steps.
__global__ void __launch_bounds__(kThreads)
chunk_parity(const uint4* __restrict__ in, long long n_bytes, int steps,
             ByteClasses c, int count_nonascii, int* __restrict__ chunk_par,
             unsigned long long* __restrict__ nonascii) {
  __shared__ int s_par[kWarps];
  __shared__ unsigned s_high[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * steps * kStepBytes;
  uint32_t quotes = 0, high = 0;
  for (int step = 0; step < steps; ++step) {
    const long long off = base + (long long)step * kStepBytes + threadIdx.x * 16;
    if (off < n_bytes) {
      const uint4 v = in[off >> 4];
      quotes += __popc(quote16(v, c));
      if (count_nonascii) high += high_bytes16(v);
    }
  }
  const uint32_t bal = __ballot_sync(kFull, quotes & 1u);
  const unsigned warp_high = __reduce_add_sync(kFull, high);
  if (lane == 0) {
    s_par[warp] = __popc(bal) & 1;
    s_high[warp] = warp_high;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int par = 0;
    unsigned long long h = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      par ^= s_par[i];
      h += s_high[i];
    }
    chunk_par[blockIdx.x] = par;
    if (count_nonascii && h) atomicAdd(nonascii, h);
  }
}

// The carry scan: chunk_carry[i] = carry ^ chunk_par[0..i), where carry is
// *carry_ptr & 1 when carry_ptr is not null and carry_in otherwise;
// scalars[0] is the parity out and scalars[1] the non-ASCII count (-1: not
// counted).
__global__ void __launch_bounds__(csv_scan::kThreads)
chunk_carry_scan(const int* __restrict__ chunk_par, int* __restrict__ chunk_carry,
                 int n_chunks, const int* __restrict__ carry_ptr, int carry_in,
                 int count_nonascii,
                 const unsigned long long* __restrict__ nonascii,
                 int* __restrict__ scalars) {
  const int carry = carry_ptr ? (*carry_ptr & 1) : (carry_in & 1);
  csv_scan::exclusive_scan_one_block<csv_scan::Xor>(
      chunk_par, chunk_carry, n_chunks, carry, &scalars[0]);
  if (threadIdx.x == 0) scalars[1] = count_nonascii ? (int)*nonascii : -1;
}

// The carry step of one 4 KiB step of pass B. `odd` is 1 iff this thread's
// 16 bytes hold an odd number of quotes (the step's threads in order).
// Returns the quote parity before the thread's first byte. `carry` enters as
// the parity before the step and leaves as the parity after it. A thread
// gets its exclusive parity within the warp from __ballot_sync and __popc,
// and the warps' parities combine in shared memory. The call holds one
// __syncthreads, so every thread of the block makes it for every step;
// `s_wpar` is the block's two-buffer warp parity array and `step` picks the
// buffer: a warp that runs ahead writes the other one, and the barrier of
// the step between keeps it from the one being read.
__device__ __forceinline__ uint32_t step_carry(uint32_t odd, uint32_t& carry,
                                               uint32_t (*s_wpar)[kWarps],
                                               int step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t bal = __ballot_sync(kFull, odd);
  const uint32_t lane_excl = __popc(bal & ((1u << lane) - 1u)) & 1u;
  const int buf = step & 1;
  if (lane == 0) s_wpar[buf][warp] = __popc(bal) & 1u;
  __syncthreads();
  uint32_t warp_excl = 0, step_par = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const uint32_t w = s_wpar[buf][i];
    warp_excl ^= (i < warp) ? w : 0u;
    step_par ^= w;
  }
  const uint32_t before = carry ^ warp_excl ^ lane_excl;
  carry ^= step_par;
  return before;
}

// One 4 KiB step of pass B. `off` is this thread's first byte (16 per
// thread, the step's threads in order). Returns the thread's 16-bit mask:
// bit k is 1 iff byte off+k is structural and outside quotes (0 past
// n_bytes). `carry` is as in step_carry. A thread builds 16-bit quote and
// structural masks, takes the in-thread prefix XOR by shifts of 1/2/4/8, and
// XORs in the parity before it from step_carry.
__device__ __forceinline__ uint32_t step_mask(
    const uint4* __restrict__ in, long long off, long long n_bytes,
    const ByteClasses& c, uint32_t& carry, uint32_t (*s_wpar)[kWarps],
    int step) {
  uint32_t q = 0, s = 0;
  if (off < n_bytes) {
    const uint4 v = in[off >> 4];
    q = quote16(v, c);
    s = structural16(v, c);
  }
  // in-thread inclusive prefix XOR: bit j = XOR of quote bits 0..j
  uint32_t p = q;
  p ^= p << 1;
  p ^= p << 2;
  p ^= p << 4;
  p ^= p << 8;
  const uint32_t before = step_carry(__popc(q) & 1u, carry, s_wpar, step);
  const uint32_t in_quote = p ^ (0u - before);
  return s & ~in_quote & 0xffffu;
}

inline ByteClasses make_classes(int quote, const int* structural) {
  ByteClasses c;
  c.quote = (uint32_t)(quote & 0xff) * 0x01010101u;
  for (int i = 0; i < kMaxStructural; ++i)
    c.structural[i] = (uint32_t)(structural[i] & 0xff) * 0x01010101u;
  return c;
}

// Pass A and the carry scan for n_chunks chunks of `steps` steps each.
// chunk_par and chunk_carry hold n_chunks ints each; nonascii may be null
// when count_nonascii is 0.
inline cudaError_t launch_carry(const void* in, long long n_bytes, int steps,
                                long long n_chunks, const ByteClasses& c,
                                int count_nonascii, int* chunk_par,
                                int* chunk_carry, unsigned long long* nonascii,
                                const void* carry_ptr, int carry_in,
                                int* scalars, cudaStream_t st) {
  cudaError_t err;
  if (count_nonascii) {
    err = cudaMemsetAsync(nonascii, 0, sizeof(unsigned long long), st);
    if (err != cudaSuccess) return err;
  }
  chunk_parity<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      static_cast<const uint4*>(in), n_bytes, steps, c, count_nonascii,
      chunk_par, nonascii);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_carry_scan<<<1, csv_scan::kThreads, 0, st>>>(
      chunk_par, chunk_carry, (int)n_chunks,
      static_cast<const int*>(carry_ptr), carry_in, count_nonascii, nonascii,
      scalars);
  return cudaGetLastError();
}

}  // namespace
