// The quote parity of a shard's bytes for Hopper (sm_90a): kernel S1.
//
// Replaces csv_simd_tpu/parallel/sharded.py `_local_parity` (line 51), phase
// A of every sharded build. It is XLA code, no pallas_call: XLA fuses its
// byte compare, in-word prefix XOR and sum into one pass over the shard. Its
// plain version, parallel/sharded.py `_local_parity_plain`, is eager torch
// and writes and reads an int32 temporary for each of its steps; the one-op
// form `(bytes == quote).sum() & 1` writes and reads a bool tensor the size of
// the shard.
//
// What it computes: (the number of bytes equal to `quote`) & 1 over n bytes,
// n a multiple of 16, as one int32 on the card.
//
// What bounds it on an H100: HBM bandwidth, one read of n bytes and a 4-byte
// write.
//
// What the design does about it: each thread keeps four 16-byte loads in
// flight a step, neighbouring threads on neighbouring 16 bytes. The parity of
// a count of matches is the parity of the set bits of the XOR of their masks,
// so a thread XORs the __vcmpeq4 masks (0xFF a matching byte) of all its words
// into one register and counts nothing until the end: __popc of that register
// over 8 is the number of its byte lanes that saw an odd count. A warp takes
// the parity of its lanes' with __reduce_xor_sync, and each warp with an odd
// parity does one atomicXor into the word the launcher zeroed on the stream.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // 16-byte loads in flight a thread a step
constexpr unsigned kFull = 0xffffffffu;

// 0xFF in each byte lane of the XOR of v's four words' matches that saw an
// odd number of them
__device__ __forceinline__ uint32_t match_xor(uint4 v, uint32_t q4) {
  return __vcmpeq4(v.x, q4) ^ __vcmpeq4(v.y, q4) ^ __vcmpeq4(v.z, q4) ^
         __vcmpeq4(v.w, q4);
}

__global__ void __launch_bounds__(kThreads)
quote_parity(const uint4* __restrict__ data, long long n16, uint32_t q4,
             unsigned* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint32_t acc = 0;
  for (; i + (kLoads - 1) * stride < n16; i += kLoads * stride) {
    uint4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) v[k] = __ldg(data + i + k * stride);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) acc ^= match_xor(v[k], q4);
  }
  for (; i < n16; i += stride) acc ^= match_xor(__ldg(data + i), q4);
  const unsigned odd = __reduce_xor_sync(kFull, (__popc(acc) >> 3) & 1u);
  if ((threadIdx.x & 31) == 0 && odd) atomicXor(out, 1u);
}

}  // namespace

extern "C" {

// data: n_bytes > 0 bytes, a multiple of 16, 16-byte aligned; out: one int32,
// set to the quote parity. Returns cudaGetLastError() after the launch.
int csv_quote_parity(const void* data, long long n_bytes, int quote, void* out,
                     void* stream) {
  if (n_bytes <= 0 || n_bytes % 16 ||
      reinterpret_cast<uintptr_t>(data) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n16 = n_bytes / 16;
  const long long per_block = (long long)kThreads * kLoads;
  long long blocks = (n16 + per_block - 1) / per_block;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // a full SM: 8 x 256 threads
  const uint32_t q4 = (uint32_t)(quote & 0xFF) * 0x01010101u;
  quote_parity<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const uint4*>(data), n16, q4, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
