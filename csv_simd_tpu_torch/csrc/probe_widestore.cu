// The wide-store probes for Hopper (sm_90a): the constructions the TPU tried
// for writing dense (rows/8, 128) rows, each a kernel of its own.
//
// Replaces four TPU probe kernels:
//   tools/widestore_probe2.py `probe_s8_st16` (pallas_call line 44): the
//     strided-sublane gather into 16-lane windows, out[r, 16s + j] =
//     x[8r + s, j] for s < 8 and j < 16, (rows, 128) int32 -> (rows/8, 128);
//   tools/widestore_probe2.py `probe_mmL` (line 87) and
//   tools/widestore_probe3.py `probe_mmLb` (line 75): the lane-placed int8
//     pack product, out = OR over k < 8 of int8(xw[:, 128k:128k+128]) @
//     W[128k:128k+128], accumulated in int32, for x as (M, 1024) int32 and W
//     (1024, 128) int8. mmL's (rows, 128) input is the same bytes: its rows
//     8r..8r+7 are row r of the (rows/8, 1024) view, and x[s::8] is lane
//     window s of that view, so one kernel serves both;
//   tools/widestore_probe3.py `probe_laneload` (line 41): the sum of the 8
//     lane windows, out[r, j] = sum over k of x[r, 128k + j] with int32 adds
//     that wrap, (M, 1024) -> (M, 128).
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
//   packmm: HBM bytes (read N, write N/8; W is 128 KiB); its 2 * 128 int8
//     operations per int32 of x are far under the tensor cores' rate, but
//     this first kernel computes them with __dp4a (four int8 products and
//     their sum into an int32, on the integer pipe), where they may bound
//     it. The eight block products are ORed, not summed: with the probes'
//     weights they lie in disjoint columns, with other weights they do not.
//     One persistent block an SM stages all of W in shared memory once, in
//     groups of 4 along K (s_w[q][n] holds W[4q..4q+3, n] as one word, the
//     4 x 4 byte transpose made with __byte_perm). Then for each tile of 64
//     rows it loads x as 16-byte vectors (four int32 of one row, one K
//     group), keeps each vector's four low bytes (the int8 cast wraps, as
//     astype(jnp.int8) does) as one word, and stores the words K-major
//     (s_a[q][row]). Each thread computes 4 rows x 8 columns: per block k,
//     32 steps of one 16-byte load of x words, two of W words and 32 __dp4a,
//     then ORs the block's product into its result.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVecs = 32;    // uint4 per 128-int32 row
constexpr int kWideVecs = 256;  // uint4 per 1024-int32 row
constexpr int kGatherPer = 4;   // output vectors a gather thread moves

// packmm's shapes: K = 1024 in kQ groups of 4 bytes, N = 128 columns
constexpr int kK = 1024, kN = 128, kQ = kK / 4, kBlocks = 8;
constexpr int kTileRows = 64;
// words between two K groups of s_a: 4 more than a tile's rows, so that 8
// neighbouring groups' 16-byte stores fall on distinct banks
constexpr int kAStride = kTileRows + 4;
constexpr int kPackSmem = (kQ * kN + kQ * kAStride) * 4;  // 200,704 bytes
static_assert(kThreads == kQ, "a thread packs one K group of the tile");
static_assert(kThreads == (kTileRows / 4) * (kN / 8),
              "a thread computes 4 rows x 8 columns of the tile");

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

// byte b = the low byte of v's word b
__device__ __forceinline__ uint32_t low_bytes(uint4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

__global__ void __launch_bounds__(kThreads, 1)
ws_packmm(const uint4* __restrict__ x, long long m,
          const uint32_t* __restrict__ w, uint4* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;            // [kQ][kN]: bytes W[4q + b, n]
  uint32_t* s_a = smem + kQ * kN;  // [kQ][kAStride]: bytes x[row, 4q + b]
  // stage W: item (q, c) reads W's words (4q + b, c), columns 4c..4c+3 of
  // rows 4q..4q+3, and writes their byte transpose, s_w[q][4c..4c+3]
  for (int it = threadIdx.x; it < kQ * (kN / 4); it += kThreads) {
    const int q = it / (kN / 4), c = it % (kN / 4);
    const uint32_t* src = w + (long long)(4 * q) * (kN / 4) + c;
    const uint32_t v0 = src[0], v1 = src[kN / 4], v2 = src[2 * (kN / 4)],
                   v3 = src[3 * (kN / 4)];
    const uint32_t t0 = __byte_perm(v0, v1, 0x5140);  // v0.0 v1.0 v0.1 v1.1
    const uint32_t t1 = __byte_perm(v2, v3, 0x5140);  // v2.0 v3.0 v2.1 v3.1
    const uint32_t t2 = __byte_perm(v0, v1, 0x7362);  // v0.2 v1.2 v0.3 v1.3
    const uint32_t t3 = __byte_perm(v2, v3, 0x7362);  // v2.2 v3.2 v2.3 v3.3
    reinterpret_cast<uint4*>(s_w)[it] =
        make_uint4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                   __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
  }
  // this thread's rows 4tr..4tr+3 of a tile and columns 4tc..4tc+3 and
  // 64 + 4tc..64 + 4tc+3 (16-byte loads of s_w that no two lanes share)
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    __syncthreads();  // s_w is staged; the last tile is done with s_a
    {
      const int q = threadIdx.x;
#pragma unroll 4
      for (int g = 0; g < kTileRows / 4; ++g) {
        uint4 v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long r = row0 + 4 * g + b;
          v[b] = r < m ? x[r * kWideVecs + q] : make_uint4(0u, 0u, 0u, 0u);
        }
        *reinterpret_cast<uint4*>(s_a + q * kAStride + 4 * g) =
            make_uint4(low_bytes(v[0]), low_bytes(v[1]), low_bytes(v[2]),
                       low_bytes(v[3]));
      }
    }
    __syncthreads();
    uint32_t acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0u;
#pragma unroll 1
    for (int k = 0; k < kBlocks; ++k) {
      int p[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = 0;
#pragma unroll 4
      for (int qq = 0; qq < kQ / kBlocks; ++qq) {
        const int q = k * (kQ / kBlocks) + qq;
        const uint4 a =
            *reinterpret_cast<const uint4*>(s_a + q * kAStride + 4 * tr);
        const uint4 b0 =
            *reinterpret_cast<const uint4*>(s_w + q * kN + 4 * tc);
        const uint4 b1 =
            *reinterpret_cast<const uint4*>(s_w + q * kN + 64 + 4 * tc);
        const int av[4] = {(int)a.x, (int)a.y, (int)a.z, (int)a.w};
        const int bv[8] = {(int)b0.x, (int)b0.y, (int)b0.z, (int)b0.w,
                           (int)b1.x, (int)b1.y, (int)b1.z, (int)b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) p[i][j] = __dp4a(av[i], bv[j], p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] |= (uint32_t)p[i][j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = row0 + 4 * tr + i;
      if (r < m) {
        out[r * kRowVecs + tc] =
            make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        out[r * kRowVecs + 16 + tc] =
            make_uint4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
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

// x: (m, 1024) int32, m > 0; w: (1024, 128) int8, row-major; both 16-byte
// aligned. out: (m, 128) int32. n_sms: the card's SM count (one persistent
// block each, at most one a tile). Returns cudaGetLastError() after the
// launch.
int csv_probe_ws_packmm(const void* x, long long m, const void* w, void* out,
                        int n_sms, void* stream) {
  if (m <= 0 || n_sms <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ws_packmm, cudaFuncAttributeMaxDynamicSharedMemorySize, kPackSmem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (m + kTileRows - 1) / kTileRows;
  const unsigned grid = (unsigned)(n_tiles < n_sms ? n_tiles : n_sms);
  ws_packmm<<<grid, kThreads, kPackSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), m, static_cast<const uint32_t*>(w),
      static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
