// Kernel B5: the stage-1 build's v2 bit layout, for Hopper (sm_90a).
//
// B5, v2 layout. Replaces csv_simd_tpu/ops/stage1_v2.py `_stage1_v2_kernel`
//   (line 66), launched by `stage1_pallas_v2` (line 160). Bit 8b+r of word
//   (g, lane) covers byte ((8g+r)*128+lane)*4+b: byte b of int32 lane `lane`
//   of row 8g+r. That is B3's fold at tile 8 in row order, so word group g
//   is 8 rows of 512 bytes, one 4 KiB step, and every word lies inside one
//   64 KiB chunk of B1's one pass. It also returns the total structural
//   count and the quote parity out.
//
// What bounds it on an H100: HBM bandwidth, as for B1. Per input byte it
// must read one byte and write one bit; the classify is a few SIMD-in-word
// operations per 4 bytes and target.
//
// What the design does about it: `v2_pack` is B1's one pass (stage1_core.cuh
// `one_pass`: the input read once, the carry by decoupled look-back, no
// carry pass) with the staged emit in place of B1's stores. Each thread's 16
// masks of a chunk go to shared memory as B1's words (8 KiB), and after one
// barrier each thread builds the 8 words of one output row's lane group by
// the row-order nibble transpose (`staged_words<kOrderRow>`, q = 1: rows
// 8u .. 8u+7 of the chunk) and stores them with two 16-byte stores. The
// classify is the SWAR form when the dialect's bytes are all < 0x80 and
// __vcmpeq4 otherwise (a template flag chosen on the host, as for B1). The
// count is one register a thread (__popc of its masks over every chunk it
// takes), one warp reduction and one atomicAdd a block after the pass. The
// C entry point zeroes the status words, the ticket and the count
// (cudaMemsetAsync), so a CUDA graph that captures it replays right.
//
// The TPU kernel's MXU scans (triangular matmuls), sequential SMEM carry and
// sublane sums were Mosaic constructions and have no counterpart here.
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;                                  // B1's chunk
constexpr long long kChunkBytes = (long long)kSteps * kStepBytes;  // 64 KiB
constexpr int kChunkOutRows = 16;  // v2 word rows a chunk: 128 rows / 8

// B1's one pass with the staged emit of the v2 words; count gets the
// structural count of the whole input. n_bytes % 4 KiB == 0.
template <bool kAscii>
__global__ void __launch_bounds__(kThreads, 2)
v2_pack(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
        OnePass g, uint32_t* __restrict__ out, int* __restrict__ count) {
  __shared__ OnePassShared sh;
  __shared__ uint32_t stage[kStageWords];
  __shared__ unsigned s_cnt[kWarps];
  const long long out_rows = n_bytes / kStepBytes;
  uint32_t mine = 0;
  one_pass<kSteps, kAscii>(in, n_bytes, c, g, sh, [&](
      int chunk, const ChunkMasks<kSteps>& cm) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const uint32_t m = cm.mask(k);
      mine += __popc(m);
      stage_mask(stage, k, m);
    }
    __syncthreads();
    uint32_t acc[8];
    staged_words<kOrderRow>(stage, 1, acc);
    const long long o = (long long)chunk * kChunkOutRows + (threadIdx.x >> 4);
    if (o < out_rows) store_words8(out, o, threadIdx.x & 15, acc);
  });
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

template <bool kAscii>
cudaError_t launch_v2_pack(cudaStream_t st, const uint4* in, long long n_bytes,
                           const ByteClasses& c, const OnePass& g,
                           uint32_t* out, int* count) {
  unsigned grid = 0;
  cudaError_t err = one_pass_grid(v2_pack<kAscii>, g.n_chunks, grid);
  if (err != cudaSuccess) return err;
  v2_pack<kAscii><<<grid, kThreads, 0, st>>>(in, n_bytes, c, g, out, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in: n_bytes of input (a positive multiple of 4 KiB, 16-byte aligned).
// out: n_bytes / 32 words, as (n_bytes / 4 KiB, 128). chunk_scratch:
// csv_stage1_v4_chunks(n_bytes) + 1 ints (the chunks' status words and the
// ticket, zeroed here). scalars: 3 ints (parity out, -1, structural count;
// the count zeroed here). carry_ptr: a device int whose bit 0 is the
// carry-in, or null to take carry_in. structural: the delimiter and
// newlines, padded to five with repeats. Returns cudaGetLastError() after
// the launch.
int csv_stage1_v2(const void* in, long long n_bytes, void* out,
                  void* chunk_scratch, void* scalars, const void* carry_ptr,
                  int carry_in, int quote, int s0, int s1, int s2, int s3,
                  int s4, void* stream) {
  if (n_bytes <= 0 || n_bytes % kStepBytes != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n_bytes + kChunkBytes - 1) / kChunkBytes;
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {s0, s1, s2, s3, s4};
  const ByteClasses c = make_classes(quote, structural);
  const bool ascii = ascii_classes(quote, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(scalars);
  OnePass g{};
  g.carry_ptr = static_cast<const int*>(carry_ptr);
  g.carry_in = carry_in;
  g.scalars = sc;
  cudaError_t err = reset_one_pass(g, chunk_scratch, n_chunks, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(sc + 2, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const uint4* in4 = static_cast<const uint4*>(in);
  uint32_t* out_w = static_cast<uint32_t*>(out);
  return (int)(ascii ? launch_v2_pack<true>(st, in4, n_bytes, c, g, out_w,
                                            sc + 2)
                     : launch_v2_pack<false>(st, in4, n_bytes, c, g, out_w,
                                             sc + 2));
}

}  // extern "C"
