// Kernels B3, B5 and B6: the stage-1 build's other bit layouts, for Hopper
// (sm_90a). Each is B1's classify-and-carry core (stage1_core.cuh: pass A,
// the carry scan, and the per-step mask of pass B) with its own pack step.
// B4 (`stage1_fused_seq`) emits B1's own words and is served by B1.
//
// B3, fold layout. Replaces csv_simd_tpu/ops/stage1_v3.py `_stage1_v3_kernel`
//   (line 106), launched by `stage1_fused` (line 202). Per tile of T rows of
//   512 bytes, bit 8b+sigma(j) of word (s*T/8+g, lane) covers byte b of input
//   word (s*T + j*T/8 + g, lane), sigma = [7,3,5,1,6,2,4,0]. One output word
//   takes a nibble from 8 rows T/8 rows apart, so a block owns whole tiles
//   (enough of them to make about 64 KiB when T is small): it ORs each
//   thread's nibbles into a shared-memory copy of its tiles' words
//   (T*64 bytes; 32 KiB at T = 512) with shared atomics, since for T < 64 a
//   step's rows share words, and writes the copy out once, coalesced.
// B5, v2 layout. Replaces csv_simd_tpu/ops/stage1_v2.py `_stage1_v2_kernel`
//   (line 66), launched by `stage1_pallas_v2` (line 160). Bit 8b+r of word
//   (g, lane) covers byte ((8g+r)*128+lane)*4+b: one 4 KiB step is exactly
//   group g, and warp r holds row r. The step's masks go to shared memory and
//   128 threads each gather one word from 8 of them.
// B6, v1 layout. Replaces csv_simd_tpu/ops/stage1_pallas.py `_stage1_kernel`
//   (line 73), launched by `stage1_pallas` (line 145), on (rows, 128) uint8.
//   Bit k of word (s, lane) covers byte (32s+k)*128+lane: one 4 KiB step is
//   word row s, a 32 x 128 bit transpose. Through shared memory, lane k of
//   warp w holds row k's 16 bits of columns 16w..16w+15, and 16
//   __ballot_sync calls give the warp its 16 words.
// B5 and B6 also return the total structural count: per-thread __popc sums,
// reduced in the block, one atomicAdd a block.
//
// What bounds them on an H100: HBM bandwidth, as for B1. Each reads its input
// twice (pass A and pass B) and writes one bit per byte. The shared-memory
// traffic of the packs (B3's atomics, B5's gathers, B6's ballots) is a few
// operations per 16 input bytes.
//
// The TPU kernels' MXU scans (triangular matmuls), sequential SMEM carries
// and sublane sums were Mosaic constructions and have no counterpart here;
// their tile sizes matter only where they define the layout (B3).
#include "stage1_core.cuh"

namespace {

constexpr int kLanes = 128;               // int32 words per 512-byte row
constexpr int kStepRows = kStepBytes / 512;  // 8 rows of 512 bytes a step
constexpr int kChunkSteps = 16;           // B5/B6 chunk: 64 KiB
constexpr int kLayoutFold = 0, kLayoutV2 = 1, kLayoutV1 = 2;
constexpr int kMaxSharedBytes = 200 * 1024;

// bit b of a 4-bit nibble -> bit 8b
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

// sigma(j) = [7,3,5,1,6,2,4,0][j], one nibble each
__device__ __forceinline__ int fold_sigma(int j) {
  return (0x04261537 >> (4 * j)) & 0xF;
}

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

// B3's pass B. A block owns rows [blockIdx.x * rows_per_block, +rows_per_block)
// = whole tiles; s_out holds their rows_per_block/8 x 128 words.
__global__ void __launch_bounds__(kThreads)
pack_fold(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
          const int* __restrict__ chunk_carry, int tile, int rows_per_block,
          uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t s_out[];
  __shared__ uint32_t s_wpar[2][kWarps];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int out_words = rows_per_block / 8 * kLanes;
  for (int i = threadIdx.x; i < out_words; i += kThreads) s_out[i] = 0;
  __syncthreads();
  const int steps = rows_per_block / kStepRows;
  const int q = tile / 8;  // rows per j-segment of a tile
  const long long base = (long long)blockIdx.x * rows_per_block * 512;
  uint32_t carry = (uint32_t)chunk_carry[blockIdx.x] & 1u;
  for (int step = 0; step < steps; ++step) {
    const long long off = base + (long long)step * kStepBytes + threadIdx.x * 16;
    const uint32_t m = step_mask(in, off, n_bytes, c, carry, s_wpar, step);
    if (m) {
      // this thread: row `row` of the step, int32 lanes 4*lane..4*lane+3
      const int rr = step * kStepRows + row;  // row within the block
      const int ti = rr / tile, rt = rr - ti * tile;
      const int j = rt / q, g = rt - j * q;
      const int sigma = fold_sigma(j);
      uint32_t* dst = s_out + (ti * q + g) * kLanes + 4 * lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t n = (m >> (4 * k)) & 0xFu;
        if (n) atomicOr(dst + k, spread4(n) << sigma);
      }
    }
  }
  __syncthreads();
  const long long out0 = (long long)blockIdx.x * out_words;
  const long long total = n_bytes / 32;
  uint4* out4 = reinterpret_cast<uint4*>(out + out0);
  const uint4* s4 = reinterpret_cast<const uint4*>(s_out);
  for (int i = threadIdx.x; i < out_words / 4; i += kThreads)
    if (out0 + 4LL * i < total) out4[i] = s4[i];
}

// B5's and B6's pass B over 64 KiB chunks; n_bytes % 4 KiB == 0.
template <int kLayout>
__global__ void __launch_bounds__(kThreads)
pack_rows(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
          const int* __restrict__ chunk_carry, uint32_t* __restrict__ out,
          int* __restrict__ count) {
  __shared__ uint32_t s_wpar[2][kWarps];
  __shared__ uint32_t s_m[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kChunkSteps * kStepBytes;
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
    if (kLayout == kLayoutV2) {
      // word lane L, bits 8b+r: row r's mask is thread 32r + L/4's, and
      // its nibble L%4 holds bytes b = 0..3 of int32 lane L
      if (threadIdx.x < kLanes) {
        const int L = threadIdx.x;
        uint32_t w = 0;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          w |= spread4((s_m[r * 32 + (L >> 2)] >> (4 * (L & 3))) & 0xFu)
               << r;
        dst[L] = w;
      }
    } else {
      // column 16w+i, bit k: thread 8k + w's mask, bit i
      const uint32_t mm = s_m[lane * 8 + warp];
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t bal = __ballot_sync(kFull, (mm >> i) & 1u);
        if (lane == i) word = bal;
      }
      if (lane < 16) dst[warp * 16 + lane] = word;
    }
  }
  add_block_count(mine, count);
}

// Rows a fold block owns: whole tiles, at least 128 rows (64 KiB) when the
// tile is small.
long long fold_rows_per_block(int tile) {
  const int tiles = tile < 128 ? 128 / tile : 1;
  return (long long)tiles * tile;
}

long long chunk_bytes(int layout, int tile) {
  return layout == kLayoutFold ? fold_rows_per_block(tile) * 512
                               : (long long)kChunkSteps * kStepBytes;
}

}  // namespace

extern "C" {

// The largest fold tile (rows) the kernel takes: its block's words must fit
// in shared memory.
int csv_stage1_fold_max_tile() { return kMaxSharedBytes / 64; }

// Number of chunks (pass A/B blocks) for n_bytes of input in `layout`
// (0 fold, 1 v2, 2 v1); `tile` is the fold tile in rows.
long long csv_stage1_pack_chunks(int layout, long long n_bytes, int tile) {
  const long long cb = chunk_bytes(layout, tile);
  return (n_bytes + cb - 1) / cb;
}

// in: n_bytes of input (a positive multiple of 4 KiB, 16-byte aligned).
// out: n_bytes / 32 words. chunk_scratch: 2 * csv_stage1_pack_chunks ints.
// scalars: 3 ints (parity out, -1, structural count; the count is written
// for v2 and v1). carry_ptr: a device int whose bit 0 is the carry-in, or
// null to take carry_in. tile: the fold tile in rows (a multiple of 8 that
// divides n_bytes / 512, at most csv_stage1_fold_max_tile()); ignored for
// v2 and v1. structural: the delimiter and newlines, padded to five with
// repeats. Returns cudaGetLastError() after the launches.
int csv_stage1_pack(int layout, const void* in, long long n_bytes, void* out,
                    void* chunk_scratch, void* scalars, const void* carry_ptr,
                    int carry_in, int quote, int s0, int s1, int s2, int s3,
                    int s4, int tile, void* stream) {
  if (n_bytes <= 0 || n_bytes % kStepBytes != 0)
    return (int)cudaErrorInvalidValue;
  if (layout < kLayoutFold || layout > kLayoutV1)
    return (int)cudaErrorInvalidValue;
  if (layout == kLayoutFold &&
      (tile <= 0 || tile % 8 != 0 || tile > csv_stage1_fold_max_tile() ||
       (n_bytes / 512) % tile != 0))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_stage1_pack_chunks(layout, n_bytes, tile);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int steps = (int)(chunk_bytes(layout, tile) / kStepBytes);
  const int structural[kMaxStructural] = {s0, s1, s2, s3, s4};
  const ByteClasses c = make_classes(quote, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* chunk_par = static_cast<int*>(chunk_scratch);
  int* chunk_carry = chunk_par + n_chunks;
  int* sc = static_cast<int*>(scalars);
  cudaError_t err = cudaMemsetAsync(sc + 2, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = launch_carry(in, n_bytes, steps, n_chunks, c, 0, chunk_par,
                     chunk_carry, nullptr, carry_ptr, carry_in, sc, st);
  if (err != cudaSuccess) return (int)err;
  const uint4* in4 = static_cast<const uint4*>(in);
  uint32_t* out_w = static_cast<uint32_t*>(out);
  if (layout == kLayoutFold) {
    const int rows_per_block = (int)fold_rows_per_block(tile);
    const int smem = rows_per_block * 64;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          pack_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    pack_fold<<<(unsigned)n_chunks, kThreads, smem, st>>>(
        in4, n_bytes, c, chunk_carry, tile, rows_per_block, out_w);
  } else if (layout == kLayoutV2) {
    pack_rows<kLayoutV2><<<(unsigned)n_chunks, kThreads, 0, st>>>(
        in4, n_bytes, c, chunk_carry, out_w, sc + 2);
  } else {
    pack_rows<kLayoutV1><<<(unsigned)n_chunks, kThreads, 0, st>>>(
        in4, n_bytes, c, chunk_carry, out_w, sc + 2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
