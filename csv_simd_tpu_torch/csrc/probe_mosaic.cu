// The Mosaic regression probes for Hopper (sm_90a): each (8, 128) probe body
// of tools/mosaic_probes.py `_run_both` (pallas_call line 66) as a kernel over
// (rows, 128) arrays; at rows = 8 it is the TPU probe.
//
//   mm32_pack   matmul32_slice (line 100) and matmul32_roll (line 113): (rows,
//               128) int32 v -> (rows, 16) int32, word g = lo | (hi << 16)
//               with lo = sum over l < 4 of v[8g + l] << 4l and hi the same
//               over v[8g + 4 + l], in int32 arithmetic that wraps. The TPU
//               formed lo and hi with a bf16 product by power-of-two weights,
//               which equals this where the bf16 cast is exact (|v| <= 256).
//               Shifts and adds build lo and hi (adds, not ORs: the sum is the
//               function for any v), and one OR combines them.
//   lane_gather int8_lane_gather (line 127): out[r, j] = lut[r, idx[r, j] &
//               127], int8; the mask keeps every index inside its row.
//   cmp8        cmp8 (line 139): uint8 a -> int32 (a == 0x2C).
//   select8     select8 (line 149): uint8 a -> uint8 where(a > 127, a, 7).
//   shift_add   sublane_concat (line 160): out[r] = x[r] + x[r - 1], row -1
//               = 0, int32 adds that wrap.
//   usum        unsigned_reduce (line 172): the uint32 sum of every element,
//               mod 2^32, into one word.
//
// What bounds each on an H100: HBM bytes; each does a few integer operations
// a byte. Each reads its input once with 16-byte loads (lane_gather's lut
// row in 4-byte words, cmp8's bytes in 4-byte words: one input word becomes
// one 16-byte store of four int32) and writes its output once with stores that
// neighbouring lanes make to neighbouring addresses. lane_gather keeps each
// 128-byte lut row in one warp's registers (a word a lane) and reads it with
// warp shuffles, the GPU's form of a lane gather. usum reduces in registers,
// then across the warp by shuffles and the block through shared memory, and
// each block adds its sum to the output with one atomicAdd on unsigned: the
// sum is modular, so the order of the blocks does not change it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVecs = 32;     // uint4 per 128-int32 row
constexpr int kGatherRows = 4;   // lut rows a warp gathers, loads first
constexpr int kCmpWords = 4;     // input words a cmp8 thread converts

__global__ void __launch_bounds__(kThreads)
mm32_pack(const uint4* __restrict__ v, long long n_out,
          uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const uint4 a = v[2 * i], b = v[2 * i + 1];
  const uint32_t lo = a.x + (a.y << 4) + (a.z << 8) + (a.w << 12);
  const uint32_t hi = b.x + (b.y << 4) + (b.z << 8) + (b.w << 12);
  out[i] = lo | (hi << 16);
}

__global__ void __launch_bounds__(kThreads)
lane_gather(const uint32_t* __restrict__ lut, const uint4* __restrict__ idx,
            long long rows, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
      kGatherRows;
  uint32_t l[kGatherRows];
  uint4 ix[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) {
    if (row0 + r < rows) {  // uniform across the warp
      l[r] = lut[(row0 + r) * 32 + lane];
      ix[r] = idx[(row0 + r) * kRowVecs + lane];
    }
  }
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) {
    if (row0 + r >= rows) break;
    const uint32_t j[4] = {ix[r].x & 127u, ix[r].y & 127u, ix[r].z & 127u,
                           ix[r].w & 127u};
    uint32_t o = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t word = __shfl_sync(0xffffffffu, l[r], (int)(j[b] >> 2));
      o |= ((word >> (8 * (j[b] & 3u))) & 0xFFu) << (8 * b);
    }
    out[(row0 + r) * 32 + lane] = o;
  }
}

__global__ void __launch_bounds__(kThreads)
cmp8(const uint32_t* __restrict__ a, long long n_words,
     uint4* __restrict__ out) {
  const long long base =
      (long long)blockIdx.x * kThreads * kCmpWords + threadIdx.x;
  uint32_t w[kCmpWords];
#pragma unroll
  for (int k = 0; k < kCmpWords; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < n_words) w[k] = a[i];
  }
#pragma unroll
  for (int k = 0; k < kCmpWords; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < n_words) {
      const uint32_t eq = __vcmpeq4(w[k], 0x2C2C2C2Cu);  // 0xFF a byte equal
      out[i] = make_uint4(eq & 1u, (eq >> 8) & 1u, (eq >> 16) & 1u, eq >> 31);
    }
  }
}

__device__ __forceinline__ uint32_t select8_word(uint32_t x) {
  const uint32_t m = ((x & 0x80808080u) >> 7) * 0xFFu;  // 0xFF where > 127
  return (x & m) | (0x07070707u & ~m);
}

__global__ void __launch_bounds__(kThreads)
select8(const uint4* __restrict__ a, long long n_vec,
        uint4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const uint4 x = a[i];
  out[i] = make_uint4(select8_word(x.x), select8_word(x.y),
                      select8_word(x.z), select8_word(x.w));
}

__global__ void __launch_bounds__(kThreads)
shift_add(const uint4* __restrict__ x, long long n_vec,
          uint4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const uint4 v = x[i];
  const uint4 p = i >= kRowVecs ? x[i - kRowVecs] : make_uint4(0u, 0u, 0u, 0u);
  out[i] = make_uint4(v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w);
}

__global__ void __launch_bounds__(kThreads)
usum(const uint4* __restrict__ a, long long n_vec,
     unsigned int* __restrict__ out) {
  __shared__ unsigned int warp_sums[kThreads / 32];
  unsigned int s = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + 3 * stride < n_vec; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = a[i + k * stride];
#pragma unroll
    for (int k = 0; k < 4; ++k) s += v[k].x + v[k].y + v[k].z + v[k].w;
  }
  for (; i < n_vec; i += stride) {
    const uint4 v = a[i];
    s += v.x + v.y + v.z + v.w;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
    if (threadIdx.x == 0) atomicAdd(out, s);
  }
}

bool grid_of(long long items, long long per_block, unsigned* grid) {
  const long long g = (items + per_block - 1) / per_block;
  if (g <= 0 || g > (1LL << 31) - 1) return false;
  *grid = (unsigned)g;
  return true;
}

}  // namespace

extern "C" {

// Every entry point: inputs and outputs row-major, 16-byte aligned, rows > 0;
// returns cudaGetLastError() after its launches.

// v: (rows, 128) int32. out: (rows, 16) int32.
int csv_probe_mosaic_mm32(const void* v, long long rows, void* out,
                          void* stream) {
  unsigned grid;
  if (rows <= 0 || !grid_of(rows * 16, kThreads, &grid))
    return (int)cudaErrorInvalidValue;
  mm32_pack<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(v), rows * 16, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// lut: (rows, 128) int8; idx: (rows, 128) int32. out: (rows, 128) int8.
int csv_probe_mosaic_gather(const void* lut, const void* idx, long long rows,
                            void* out, void* stream) {
  unsigned grid;
  if (rows <= 0 ||
      !grid_of(rows, (long long)(kThreads / 32) * kGatherRows, &grid))
    return (int)cudaErrorInvalidValue;
  lane_gather<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lut), static_cast<const uint4*>(idx), rows,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// a: (rows, 128) uint8. out: (rows, 128) int32.
int csv_probe_mosaic_cmp8(const void* a, long long rows, void* out,
                          void* stream) {
  unsigned grid;
  if (rows <= 0 || !grid_of(rows * 32, (long long)kThreads * kCmpWords, &grid))
    return (int)cudaErrorInvalidValue;
  cmp8<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), rows * 32, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// a: (rows, 128) uint8. out: (rows, 128) uint8.
int csv_probe_mosaic_select8(const void* a, long long rows, void* out,
                             void* stream) {
  unsigned grid;
  if (rows <= 0 || !grid_of(rows * 8, kThreads, &grid))
    return (int)cudaErrorInvalidValue;
  select8<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), rows * 8, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// x: (rows, 128) int32. out: (rows, 128) int32.
int csv_probe_mosaic_shift_add(const void* x, long long rows, void* out,
                               void* stream) {
  unsigned grid;
  if (rows <= 0 || !grid_of(rows * kRowVecs, kThreads, &grid))
    return (int)cudaErrorInvalidValue;
  shift_add<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), rows * kRowVecs, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// a: (rows, 128) int32 holding uint32 bit patterns. out: one word, zeroed
// here on the stream, then the sum. n_sms: the card's SM count (the grid is
// at most 8 blocks an SM).
int csv_probe_mosaic_usum(const void* a, long long rows, void* out, int n_sms,
                          void* stream) {
  unsigned grid;
  if (rows <= 0 || n_sms <= 0 || !grid_of(rows * kRowVecs, kThreads, &grid))
    return (int)cudaErrorInvalidValue;
  if (grid > 8u * (unsigned)n_sms) grid = 8u * (unsigned)n_sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  usum<<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(a),
                                 rows * kRowVecs,
                                 static_cast<unsigned int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
