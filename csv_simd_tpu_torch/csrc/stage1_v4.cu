// Kernel B1: the stage-1 structural build for Hopper (sm_90a).
//
// Replaces csv_simd_tpu/ops/stage1_v4.py `_stage1_v4_kernel_wide` (line 147),
// launched by `stage1_fused_v4(out_mode="wide_native")`, and the narrow
// `_stage1_v4_kernel` (line 312) through a view of the same words.
//
// What it computes: bit m of output word w is 1 iff byte 32w+m is a
// delimiter or newline outside quotes, where in-quote is the inclusive prefix
// XOR of the quote bytes XOR carry_in. Also the quote parity after the input
// (carry_in XOR the number of quotes, mod 2) and, when asked, the number of
// bytes with bit 7 set.
//
// What bounds it on an H100: HBM bandwidth. Per input byte it must read one
// byte and write one bit; the classify is four SIMD-in-word byte compares per
// 4 bytes and target, far below the card's integer rate.
//
// What the design does about it. Loads are 16 bytes a thread (one uint4),
// neighbouring threads on neighbouring addresses; stores are one 32-bit word
// per thread pair, 64 contiguous bytes a warp. The classify compares bytes
// with __vcmpeq4, which serves ASCII and non-ASCII dialects alike (the TPU
// kernel's two SWAR branches collapse into one). The TPU kernel carried the
// quote parity through SMEM because its grid runs in order; blocks here run
// in parallel, so the carry takes two passes over the input (stage1_core.cuh):
// pass A reduces each 64 KiB chunk's quote parity and non-ASCII count, one
// block scans the chunk parities into carries, and pass B walks each chunk
// again in 4 KiB steps; here thread pairs join their 16-bit masks into one
// word with __shfl_xor_sync.
// Pass A reads the input a second time; a one-pass carry (decoupled
// look-back) is later work. The dual-rail carry, the int8 MXU scans and the
// lane-placed pack matmuls of the TPU kernel were Mosaic workarounds and have
// no counterpart here.
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;
constexpr long long kChunkBytes = (long long)kStepBytes * kSteps;  // 64 KiB

// Pass B: mask and pack each chunk with its incoming carry.
__global__ void __launch_bounds__(kThreads)
mask_pack(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
          const int* __restrict__ chunk_carry, uint32_t* __restrict__ out) {
  __shared__ uint32_t s_wpar[2][kWarps];
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kChunkBytes;
  uint32_t carry = (uint32_t)chunk_carry[blockIdx.x] & 1u;
  for (int step = 0; step < kSteps; ++step) {
    const long long off = base + (long long)step * kStepBytes + threadIdx.x * 16;
    const uint32_t m = step_mask(in, off, n_bytes, c, carry, s_wpar, step);
    const uint32_t upper = __shfl_xor_sync(kFull, m, 1);
    // n_bytes % 32 == 0, so both threads of a pair are live or neither is
    if (off < n_bytes && !(lane & 1)) out[off >> 5] = m | (upper << 16);
  }
}

}  // namespace

extern "C" {

// Number of 64 KiB chunks (pass A/B blocks) for n_bytes of input.
long long csv_stage1_v4_chunks(long long n_bytes) {
  return (n_bytes + kChunkBytes - 1) / kChunkBytes;
}

// in: n_bytes of input (n_bytes > 0, a multiple of 32, 16-byte aligned).
// out: n_bytes / 32 words. chunk_scratch: 2 * csv_stage1_v4_chunks(n_bytes)
// ints. scalars: 2 ints (parity out, non-ASCII count). counter: one 64-bit
// scratch word. carry_ptr: a device int whose bit 0 is the carry-in, or null
// to take carry_in. structural: the delimiter and newlines, padded to five
// with repeats. Returns cudaGetLastError() after the launches.
int csv_stage1_v4(const void* in, long long n_bytes, void* out,
                  void* chunk_scratch, void* scalars, void* counter,
                  const void* carry_ptr, int carry_in, int count_nonascii,
                  int quote, int s0, int s1, int s2, int s3, int s4,
                  void* stream) {
  if (n_bytes <= 0 || n_bytes % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_stage1_v4_chunks(n_bytes);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {s0, s1, s2, s3, s4};
  const ByteClasses c = make_classes(quote, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* chunk_par = static_cast<int*>(chunk_scratch);
  int* chunk_carry = chunk_par + n_chunks;
  cudaError_t err = launch_carry(
      in, n_bytes, kSteps, n_chunks, c, count_nonascii, chunk_par, chunk_carry,
      static_cast<unsigned long long*>(counter), carry_ptr, carry_in,
      static_cast<int*>(scalars), st);
  if (err != cudaSuccess) return (int)err;
  mask_pack<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      static_cast<const uint4*>(in), n_bytes, c, chunk_carry,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
