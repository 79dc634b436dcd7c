// Kernel B5: the stage-1 build's v2 bit layout, for Hopper (sm_90a). It is
// the two-pass classify-and-carry core (stage1_core.cuh: pass A, the carry
// scan, and the per-step mask of pass B) with its own pack step. The other
// layouts read their input once: B4 (`stage1_fused_seq`) is B1's own
// words, and B3 (fold) and B6 (v1) are B1 followed by a relayout of its
// words (relayout.cu).
//
// B5, v2 layout. Replaces csv_simd_tpu/ops/stage1_v2.py `_stage1_v2_kernel`
//   (line 66), launched by `stage1_pallas_v2` (line 160). Bit 8b+r of word
//   (g, lane) covers byte ((8g+r)*128+lane)*4+b: one 4 KiB step is exactly
//   group g, and warp r holds row r. The step's masks go to shared memory and
//   128 threads each gather one word from 8 of them. It also returns the
//   total structural count: per-thread __popc sums, reduced in the block,
//   one atomicAdd a block.
//
// What bounds it on an H100: HBM bandwidth, as for B1. It reads its input
// twice (pass A and pass B) and writes one bit per byte. The shared-memory
// gathers of the pack are a few operations per 16 input bytes.
//
// The TPU kernel's MXU scans (triangular matmuls), sequential SMEM carry and
// sublane sums were Mosaic constructions and have no counterpart here.
#include "stage1_core.cuh"

namespace {

constexpr int kLanes = 128;               // int32 words per 512-byte row
constexpr int kChunkSteps = 16;           // a chunk: 64 KiB
constexpr long long kChunkBytes = (long long)kChunkSteps * kStepBytes;

// Adds the block's per-thread counts into *count with one atomicAdd.
__device__ void add_block_count(uint32_t mine, int* __restrict__ count) {
  __shared__ unsigned s_cnt[kWarps];
  const unsigned w = __reduce_add_sync(kFull, mine);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_cnt[i];
    if (total) atomicAdd(count, (int)total);
  }
}

// B5's pass B over 64 KiB chunks; n_bytes % 4 KiB == 0.
__global__ void __launch_bounds__(kThreads)
pack_v2(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
        const int* __restrict__ chunk_carry, uint32_t* __restrict__ out,
        int* __restrict__ count) {
  __shared__ uint32_t s_wpar[2][kWarps];
  __shared__ uint32_t s_m[kThreads];
  const long long base = (long long)blockIdx.x * kChunkBytes;
  uint32_t carry = (uint32_t)chunk_carry[blockIdx.x] & 1u;
  uint32_t mine = 0;
  for (int step = 0; step < kChunkSteps; ++step) {
    const long long step0 = base + (long long)step * kStepBytes;
    const uint32_t m = step_mask(in, step0 + threadIdx.x * 16, n_bytes, c,
                                 carry, s_wpar, step);
    mine += __popc(m);
    // one buffer: a thread writes the next step's mask only after the
    // barrier inside that step's step_mask, which every thread reaches
    // after its reads of this step
    s_m[threadIdx.x] = m;
    __syncthreads();
    if (step0 >= n_bytes) continue;  // the same for the whole block
    uint32_t* dst = out + (step0 / kStepBytes) * kLanes;
    // word lane L, bits 8b+r: row r's mask is thread 32r + L/4's, and its
    // nibble L%4 holds bytes b = 0..3 of int32 lane L
    if (threadIdx.x < kLanes) {
      const int L = threadIdx.x;
      uint32_t w = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        w |= spread4((s_m[r * 32 + (L >> 2)] >> (4 * (L & 3))) & 0xFu) << r;
      dst[L] = w;
    }
  }
  add_block_count(mine, count);
}

}  // namespace

extern "C" {

// Number of 64 KiB chunks (pass A/B blocks) for n_bytes of input.
long long csv_stage1_v2_chunks(long long n_bytes) {
  return (n_bytes + kChunkBytes - 1) / kChunkBytes;
}

// in: n_bytes of input (a positive multiple of 4 KiB, 16-byte aligned).
// out: n_bytes / 32 words. chunk_scratch: 2 * csv_stage1_v2_chunks ints.
// scalars: 3 ints (parity out, -1, structural count). carry_ptr: a device
// int whose bit 0 is the carry-in, or null to take carry_in. structural:
// the delimiter and newlines, padded to five with repeats. Returns
// cudaGetLastError() after the launches.
int csv_stage1_v2(const void* in, long long n_bytes, void* out,
                  void* chunk_scratch, void* scalars, const void* carry_ptr,
                  int carry_in, int quote, int s0, int s1, int s2, int s3,
                  int s4, void* stream) {
  if (n_bytes <= 0 || n_bytes % kStepBytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_stage1_v2_chunks(n_bytes);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {s0, s1, s2, s3, s4};
  const ByteClasses c = make_classes(quote, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* chunk_par = static_cast<int*>(chunk_scratch);
  int* chunk_carry = chunk_par + n_chunks;
  int* sc = static_cast<int*>(scalars);
  cudaError_t err = cudaMemsetAsync(sc + 2, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = launch_carry(in, n_bytes, kChunkSteps, n_chunks, c, 0, chunk_par,
                     chunk_carry, nullptr, carry_ptr, carry_in, sc, st);
  if (err != cudaSuccess) return (int)err;
  pack_v2<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      static_cast<const uint4*>(in), n_bytes, c, chunk_carry,
      static_cast<uint32_t*>(out), sc + 2);
  return (int)cudaGetLastError();
}

}  // extern "C"
