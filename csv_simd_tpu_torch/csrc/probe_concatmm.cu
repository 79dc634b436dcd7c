// The int8 products of the wide-store probes for Hopper (sm_90a), on the
// int8 tensor cores: one kernel template for two functions of x (M, 1024)
// int32 and W (1024, 128) int8, with int32 accumulation; the int8 cast
// wraps, as astype(jnp.int8) does.
//
// Replaces three TPU probe kernels:
//   tools/widestore_probe4.py `probe_concat_mm` (pallas_call line 40), T12:
//     out = concat over k < 8 of int8(x[:, 128k:128k+128] + k) @ W, one
//     product summed over all of K = 1024 (`concat_mm<true, false>`,
//     kAddBlock); each output is at most 1024 * 128 * 128 = 2^24 in
//     magnitude;
//   tools/widestore_probe2.py `probe_mmL` (line 87), T10b, and
//   tools/widestore_probe3.py `probe_mmLb` (line 75), T11b: out = OR over
//     k < 8 of int8(x[:, 128k:128k+128]) @ W[128k:128k+128]
//     (`concat_mm<false, true>`, kOrBlocks); each block's sums are at most
//     128 * 128 * 128 = 2^21 in magnitude. mmL's (rows, 128) input is the
//     same bytes as mmLb's (rows/8, 1024) view, so one launch serves both.
// The int32 sums are exact either way.
//
// What bounds it on an H100: HBM bytes. It reads 4 bytes of x for 128 int8
// multiply-adds, 0.0125 bytes an operation against the 0.0017 at which the
// tensor cores' 1,979 T int8 operations/s would meet 3.35 TB/s, so its time
// is x's read (and W's 128 KiB, and the output's M * 512 bytes), not the
// products.
//
// Design: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (PTX ISA, the
// m16n8k32 fragments for .s8: lane = 4 * group + t; A a0 = row group, k 4t..4t+3;
// a1 = row group + 8, the same k; a2, a3 = those rows at k 16 + 4t..; B b0 =
// k 4t..4t+3, b1 = k 16 + 4t.., both of column group; C c0, c1 = row group,
// columns 2t, 2t + 1; c2, c3 = row group + 8). One persistent block an SM
// stages all of W in shared memory once, in the order the B fragments are
// read: s_w[kk][jp][lane] is one 16-byte word holding b0, b1 of n-tile 2jp and
// of n-tile 2jp + 1 for k-step kk, so a warp reads 512 contiguous bytes, no
// bank conflict. Every warp owns 16-row tiles of x (all 128 output columns:
// 16 n-tiles, 64 int32 accumulators a lane) and walks K in stages of one
// 128-column block: 16 loads of 16 bytes a lane, each four int32 of one row
// narrowed to four int8 with __byte_perm (with kAddBlock, k added to each
// byte with __vadd4: the wrap of int8(x + k)). The next stage's loads are
// issued before the current stage's 64 mma.sync (register double
// buffering), across tile ends too, so HBM reads stay in flight while the
// tensor cores work. A stage is one block of the OR, and all four of its
// k-steps' A fragments are in registers before the products: with
// kOrBlocks the loop runs over the n-tile pairs first, each pair's four
// k-steps into a zeroed 2 x 4 partial that is then ORed into the
// accumulators (8 more registers, not a second set of 64); with kAddBlock
// the k-steps run first, straight into the accumulators.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 1024, kN = 128;
constexpr int kKSteps = kK / 32;             // 32 k-steps of the mma
constexpr int kNTiles = kN / 8;              // 16 n-tiles of 8 columns
constexpr int kStages = 8;                   // 128-column blocks of K
constexpr int kStepsPerStage = kKSteps / kStages;  // 4
constexpr int kWideVecs = kK / 4;            // uint4 per x row
constexpr int kSmem = kK * kN;               // 131,072 bytes: all of W
static_assert(kSmem == kKSteps * (kNTiles / 2) * 32 * 16, "W's fragments");

// byte b = the low byte of v's word b
__device__ __forceinline__ uint32_t low_bytes(uint4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this lane's 16 uint4 of stage `stage` of 16-row tile `tile`: for k-step s
// of the stage, [4s] row group at k 4t.., [4s + 1] row group + 8 at k 4t..,
// [4s + 2] and [4s + 3] the same rows at k 16 + 4t..
__device__ __forceinline__ void load_stage(uint4 (&raw)[4 * kStepsPerStage],
                                           const uint4* __restrict__ x,
                                           long long m, long long tile,
                                           int stage, int group, int t) {
  const long long r0 = tile * 16 + group, r1 = r0 + 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int s = 0; s < kStepsPerStage; ++s) {
    const int v = (stage * kStepsPerStage + s) * 8 + t;  // uint4 of k 32kk + 4t
    raw[4 * s] = r0 < m ? x[r0 * kWideVecs + v] : zero;
    raw[4 * s + 1] = r1 < m ? x[r1 * kWideVecs + v] : zero;
    raw[4 * s + 2] = r0 < m ? x[r0 * kWideVecs + v + 4] : zero;
    raw[4 * s + 3] = r1 < m ? x[r1 * kWideVecs + v + 4] : zero;
  }
}

template <bool kAddBlock, bool kOrBlocks>
__global__ void __launch_bounds__(kThreads, 1)
concat_mm(const uint4* __restrict__ x, long long m,
          const uint32_t* __restrict__ w, int2* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t s_w[];
  // stage W: item (q, c) reads W's words (4q + b, c) for b < 4, columns
  // 4c..4c+3 of rows 4q..4q+3, transposes their bytes so that word i holds
  // W[4q..4q+3, 4c + i], and stores each where the B fragments read it
  for (int it = threadIdx.x; it < (kK / 4) * (kN / 4); it += kThreads) {
    const int q = it / (kN / 4), c = it % (kN / 4);
    const uint32_t* src = w + (4 * q) * (kN / 4) + c;
    const uint32_t v0 = src[0], v1 = src[kN / 4], v2 = src[2 * (kN / 4)],
                   v3 = src[3 * (kN / 4)];
    const uint32_t t0 = __byte_perm(v0, v1, 0x5140);  // v0.0 v1.0 v0.1 v1.1
    const uint32_t t1 = __byte_perm(v2, v3, 0x5140);  // v2.0 v3.0 v2.1 v3.1
    const uint32_t t2 = __byte_perm(v0, v1, 0x7362);  // v0.2 v1.2 v0.3 v1.3
    const uint32_t t3 = __byte_perm(v2, v3, 0x7362);  // v2.2 v3.2 v2.3 v3.3
    const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410),
                             __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410),
                             __byte_perm(t2, t3, 0x7632)};
    // k = 4q = 32 kk + 4 tt + 16 r
    const int kk = q >> 3, tt = q & 3, r = (q >> 2) & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * c + i, j = n >> 3, lane = 4 * (n & 7) + tt;
      s_w[((kk * (kNTiles / 2) + (j >> 1)) * 32 + lane) * 4 + 2 * (j & 1) + r] =
          col[i];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, group = lane >> 2, t = lane & 3;
  const long long n_tiles = (m + 15) / 16;
  const long long warps = (long long)gridDim.x * kWarps;
  long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const uint4* s_w4 = reinterpret_cast<const uint4*>(s_w);

  int acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  uint4 raw[4 * kStepsPerStage];
  load_stage(raw, x, m, tile, 0, group, t);
  int stage = 0;
  while (true) {
    // this stage's A fragments: int8(x), or int8(x + k) with k the
    // stage's block index
    uint32_t a[kStepsPerStage][4];
    const uint32_t k_bytes = 0x01010101u * (uint32_t)stage;
#pragma unroll
    for (int s = 0; s < kStepsPerStage; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[s][e] = low_bytes(raw[4 * s + e]);
        if constexpr (kAddBlock) a[s][e] = __vadd4(a[s][e], k_bytes);
      }
    // the next stage's loads, in flight during this stage's products
    long long next_tile = tile;
    int next_stage = stage + 1;
    if (next_stage == kStages) {
      next_stage = 0;
      next_tile += warps;
    }
    const bool more = next_tile < n_tiles;
    if (more) load_stage(raw, x, m, next_tile, next_stage, group, t);
    if constexpr (kOrBlocks) {
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        int p0[4] = {0, 0, 0, 0}, p1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int s = 0; s < kStepsPerStage; ++s) {
          const int kk = stage * kStepsPerStage + s;
          const uint4 b = s_w4[(kk * (kNTiles / 2) + jp) * 32 + lane];
          mma_s8(p0, a[s], b.x, b.y);
          mma_s8(p1, a[s], b.z, b.w);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * jp][e] |= p0[e];
          acc[2 * jp + 1][e] |= p1[e];
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kStepsPerStage; ++s) {
        const int kk = stage * kStepsPerStage + s;
#pragma unroll
        for (int jp = 0; jp < kNTiles / 2; ++jp) {
          const uint4 b = s_w4[(kk * (kNTiles / 2) + jp) * 32 + lane];
          mma_s8(acc[2 * jp], a[s], b.x, b.y);
          mma_s8(acc[2 * jp + 1], a[s], b.z, b.w);
        }
      }
    }
    if (stage == kStages - 1) {
      const long long r0 = tile * 16 + group, r1 = r0 + 8;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        // int2 index of column 8j + 2t in a 128-column row
        if (r0 < m) out[r0 * (kN / 2) + 4 * j + t] = make_int2(acc[j][0],
                                                               acc[j][1]);
        if (r1 < m) out[r1 * (kN / 2) + 4 * j + t] = make_int2(acc[j][2],
                                                               acc[j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      }
    }
    if (!more) break;
    tile = next_tile;
    stage = next_stage;
  }
}

// one persistent block an SM, fewer when M has fewer 16-row tiles than
// the blocks' warps
template <bool kAddBlock, bool kOrBlocks>
int launch(const void* x, long long m, const void* w, void* out, int n_sms,
           void* stream) {
  if (m <= 0 || n_sms <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      concat_mm<kAddBlock, kOrBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (m + 15) / 16;
  const long long blocks = (n_tiles + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(blocks < n_sms ? blocks : n_sms);
  concat_mm<kAddBlock, kOrBlocks>
      <<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint4*>(x), m, static_cast<const uint32_t*>(w),
          static_cast<int2*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both: x (m, 1024) int32, m > 0; w (1024, 128) int8, row-major; both
// 16-byte aligned. out: (m, 128) int32. n_sms: the card's SM count.
// Return cudaGetLastError() after the launch.

// T12: the sum over K of int8(x + k) @ W.
int csv_probe_concat_mm(const void* x, long long m, const void* w, void* out,
                        int n_sms, void* stream) {
  return launch<true, false>(x, m, w, out, n_sms, stream);
}

// T10b/T11b: the OR over the eight blocks of int8(x block) @ W block.
int csv_probe_ws_packmm(const void* x, long long m, const void* w, void* out,
                        int n_sms, void* stream) {
  return launch<false, true>(x, m, w, out, n_sms, stream);
}

}  // extern "C"
