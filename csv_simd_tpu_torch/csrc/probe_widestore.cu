// The wide-store probes for Hopper (sm_90a): the constructions the TPU tried
// for writing dense (rows/8, 128) rows, each a kernel of its own.
//
// Replaces two TPU probe kernels:
//   tools/widestore_probe2.py `probe_s8_st16` (pallas_call line 44): the
//     strided-sublane gather into 16-lane windows, out[r, 16s + j] =
//     x[8r + s, j] for s < 8 and j < 16, (rows, 128) int32 -> (rows/8, 128);
//   tools/widestore_probe3.py `probe_laneload` (line 41): the sum of the 8
//     lane windows, out[r, j] = sum over k of x[r, 128k + j] with int32 adds
//     that wrap, (M, 1024) -> (M, 128).
// The lane-placed int8 pack product of the same two tools (`probe_mmL`,
// `probe_mmLb`) is probe_concatmm.cu's `concat_mm<false, true>`, on the
// tensor cores.
//
// What bounds each on an H100, and what its design does about it:
//   gather: HBM bytes. It needs 64 of each input row's 512 bytes, and reads
//     only those: output row r is one warp's 32 16-byte stores, and lane l
//     loads the 16 bytes (row 8r + l/4, bytes 16(l%4)..) that its store
//     holds, so 4 lanes read each input row's 64 bytes. A thread loads
//     kGatherPer vectors before it stores any, to keep loads in flight.
//   lanesum: HBM bytes (read N, write N/8). Lane l of output row r sums
//     vector l of each of the 8 windows: 8 independent 16-byte loads 512
//     bytes apart, neighbouring lanes on neighbouring addresses, and one
//     16-byte store.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVecs = 32;    // uint4 per 128-int32 row
constexpr int kWideVecs = 256;  // uint4 per 1024-int32 row
constexpr int kGatherPer = 4;   // output vectors a gather thread moves

__global__ void __launch_bounds__(kThreads)
ws_gather(const uint4* __restrict__ in, long long n_out4,
          uint4* __restrict__ out) {
  const long long base =
      (long long)blockIdx.x * kThreads * kGatherPer + threadIdx.x;
  uint4 v[kGatherPer];
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i < n_out4) {
      // output vector i: row i / 32, lanes 4(i % 32).. = window s = (i % 32)
      // / 4, lanes 4((i % 32) % 4).. of input row 8(i / 32) + s
      const long long orow = i >> 5;
      const int l = (int)(i & 31);
      v[j] = in[(orow * 8 + (l >> 2)) * kRowVecs + (l & 3)];
    }
  }
#pragma unroll
  for (int j = 0; j < kGatherPer; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i < n_out4) out[i] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
ws_lanesum(const uint4* __restrict__ in, long long n_out4,
           uint4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out4) return;
  const uint4* src = in + (i >> 5) * kWideVecs + (i & 31);
  uint4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = src[k * kRowVecs];
  uint4 s = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    s.x += v[k].x;
    s.y += v[k].y;
    s.z += v[k].z;
    s.w += v[k].w;
  }
  out[i] = s;
}

}  // namespace

extern "C" {

// in: (rows, 128) int32, rows a positive multiple of 8, 16-byte aligned.
// out: (rows / 8, 128) int32. Returns cudaGetLastError() after the launch.
int csv_probe_ws_gather(const void* in, long long rows, void* out,
                        void* stream) {
  if (rows <= 0 || rows % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long n_out4 = rows / 8 * kRowVecs;
  const long long grid =
      (n_out4 + kThreads * kGatherPer - 1) / (kThreads * kGatherPer);
  if (grid > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  ws_gather<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), n_out4, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

// in: (m, 1024) int32, m > 0, 16-byte aligned. out: (m, 128) int32.
// Returns cudaGetLastError() after the launch.
int csv_probe_ws_lanesum(const void* in, long long m, void* out,
                         void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const long long n_out4 = m * kRowVecs;
  const long long grid = (n_out4 + kThreads - 1) / kThreads;
  if (grid > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  ws_lanesum<<<(unsigned)grid, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), n_out4, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
