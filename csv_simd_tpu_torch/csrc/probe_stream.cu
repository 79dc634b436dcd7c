// The memory-stream probe for Hopper (sm_90a): the read-N / write-N/8
// stream that every stage-1 kernel performs, with no compute in the way.
//
// Replaces three TPU probe kernels:
//   tools/dma_probe.py `mk` (pallas_call line 47): read (512, 128) int32
//     blocks, write the same byte count as (512, 16) narrow or (64, 128) wide
//     blocks, each plus a block carry;
//   tools/dma_probe2.py `mk_write` (line 62): the same, plus "tall2" and
//     "tall8", whose out block was revisited over 2 or 8 grid steps (a Mosaic
//     DMA schedule);
//   tools/dma_probe2.py `mk_read` (line 90): the sum of a buffer read as
//     (64, 128) blocks; the result is the last block's sum plus the carry.
//
// What each computes, for (rows, 128) int32 in, rows % 512 == 0, carry c,
// block i of 512 rows adding a_i = (c + i) & 1:
//   narrow, tall2, tall8: out[512i + r, :16] = in[512i + r, :16] + a_i,
//     giving (rows, 16);
//   wide: out[64i + r, :] = in[512i + r, :] + a_i for r < 64, giving
//     (rows/8, 128);
//   read: out = (the int32-wrapping sum of the last (64, 128) block) + c.
// The carry is taken mod 2, as the TPU probes' chains passed it.
// The outputs depend on 1/8 of the input (the read, on its last block), so
// a kernel that computed only them would read 1/8 of what the TPU probe
// read. Each CUDA block therefore reads its whole input block and writes a
// side word: the XOR of each 512-row block for the write modes, the
// wrapping sum of each 64-row block for read (the output is the last side
// word plus c). The side words are checked against their plain version too.
//
// What bounds it on an H100: HBM bandwidth, by construction; it is the
// ceiling the stage-1 kernels are measured against. Loads are one uint4 a
// thread, a warp reading one 512-byte row, in loops unrolled so that each
// thread keeps several loads in flight; 4 threads of the warp store the
// narrow row's 64 bytes, all 32 the wide row's 512. tall2 and tall8 run the
// same stores from a CUDA block that owns 2 or 8 consecutive 512-row blocks:
// the nearest thing to a taller out block, since a CUDA block owns its
// output and nothing is revisited.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowVecs = 32;                   // uint4 per 512-byte row
constexpr int kBlockRows = 512;                // rows per write block
constexpr int kReadRows = 64;                  // rows per read block
constexpr int kNarrow = 0, kWide = 1;

__device__ __forceinline__ uint4 add4(uint4 v, uint32_t a) {
  return make_uint4(v.x + a, v.y + a, v.z + a, v.w + a);
}

// XOR of v over the block, returned in thread 0.
__device__ uint32_t block_xor(uint32_t v) {
  __shared__ uint32_t s[kWarps];
  v = __reduce_xor_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t t = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) t ^= s[i];
  __syncthreads();
  return t;
}

template <int kMode, int kPer>
__global__ void __launch_bounds__(kThreads)
stream_write(const uint4* __restrict__ in, long long rows,
             const int* __restrict__ carry_ptr, int carry_in,
             uint4* __restrict__ out, uint32_t* __restrict__ side) {
  const uint32_t c = (uint32_t)(carry_ptr ? *carry_ptr : carry_in);
  const long long n_blocks = rows / kBlockRows;
  for (int k = 0; k < kPer; ++k) {
    const long long i = (long long)blockIdx.x * kPer + k;
    if (i >= n_blocks) break;  // the same for the whole block
    const uint32_t a = (c + (uint32_t)i) & 1u;
    const uint4* src = in + i * kBlockRows * kRowVecs;
    uint32_t x = 0;
    // unrolled so that each thread has several loads in flight
#pragma unroll 8
    for (int j = 0; j < kBlockRows * kRowVecs / kThreads; ++j) {
      const int it = j * kThreads + threadIdx.x;
      const uint4 v = src[it];
      x ^= v.x ^ v.y ^ v.z ^ v.w;
      const int r = it / kRowVecs, u = it % kRowVecs;
      if (kMode == kNarrow) {
        if (u < 4) out[(i * kBlockRows + r) * 4 + u] = add4(v, a);
      } else if (r < kBlockRows / 8) {
        out[(i * (kBlockRows / 8) + r) * kRowVecs + u] = add4(v, a);
      }
    }
    x = block_xor(x);
    if (threadIdx.x == 0) side[i] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
stream_read(const uint4* __restrict__ in, long long n_blocks,
            const int* __restrict__ carry_ptr, int carry_in,
            int* __restrict__ out, uint32_t* __restrict__ side) {
  __shared__ uint32_t s[kWarps];
  const uint4* src = in + (long long)blockIdx.x * kReadRows * kRowVecs;
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kReadRows * kRowVecs / kThreads; ++j) {
    const uint4 v = src[j * kThreads + threadIdx.x];
    sum += v.x + v.y + v.z + v.w;
  }
  sum = __reduce_add_sync(kFull, sum);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int i = 0; i < kWarps; ++i) t += s[i];
    side[blockIdx.x] = t;
    if (blockIdx.x == n_blocks - 1) {
      const uint32_t c = (uint32_t)(carry_ptr ? *carry_ptr : carry_in) & 1u;
      out[0] = (int)(t + c);
    }
  }
}

template <int kMode, int kPer>
void launch_write(const void* in, long long rows, const void* carry_ptr,
                  int carry_in, void* out, void* side, cudaStream_t st) {
  const long long n_blocks = rows / kBlockRows;
  stream_write<kMode, kPer><<<(unsigned)((n_blocks + kPer - 1) / kPer),
                              kThreads, 0, st>>>(
      static_cast<const uint4*>(in), rows, static_cast<const int*>(carry_ptr),
      carry_in, static_cast<uint4*>(out), static_cast<uint32_t*>(side));
}

}  // namespace

extern "C" {

// in: (rows, 128) int32, rows a positive multiple of 512, 16-byte aligned.
// mode: 0 narrow, 1 tall2, 2 tall8 (out: rows * 16 ints), 3 wide (out:
// rows * 16 ints as (rows/8, 128)). side: rows / 512 words. carry_ptr: a
// device int read as the carry, or null to take carry_in. Returns
// cudaGetLastError() after the launch.
int csv_probe_stream_write(int mode, const void* in, long long rows,
                           const void* carry_ptr, int carry_in, void* out,
                           void* side, void* stream) {
  if (rows <= 0 || rows % kBlockRows != 0 || rows / kBlockRows > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch_write<kNarrow, 1>(in, rows, carry_ptr, carry_in, out, side, st); break;
    case 1: launch_write<kNarrow, 2>(in, rows, carry_ptr, carry_in, out, side, st); break;
    case 2: launch_write<kNarrow, 8>(in, rows, carry_ptr, carry_in, out, side, st); break;
    case 3: launch_write<kWide, 1>(in, rows, carry_ptr, carry_in, out, side, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// in: (rows, 128) int32, rows a positive multiple of 64. out: one int.
// side: rows / 64 words. Returns cudaGetLastError() after the launch.
int csv_probe_stream_read(const void* in, long long rows,
                          const void* carry_ptr, int carry_in, void* out,
                          void* side, void* stream) {
  if (rows <= 0 || rows % kReadRows != 0 || rows / kReadRows > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = rows / kReadRows;
  stream_read<<<(unsigned)n_blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), n_blocks,
      static_cast<const int*>(carry_ptr), carry_in, static_cast<int*>(out),
      static_cast<uint32_t*>(side));
  return (int)cudaGetLastError();
}

}  // extern "C"
