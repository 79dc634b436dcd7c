// Kernel B1: the stage-1 structural build for Hopper (sm_90a).
//
// Replaces csv_simd_tpu/ops/stage1_v4.py `_stage1_v4_kernel_wide` (line 147),
// launched by `stage1_fused_v4(out_mode="wide_native")`, and the narrow
// `_stage1_v4_kernel` (line 312) through a view of the same words. B1n, the
// same kernels' `emit_counts` (line 519) and `emit_prefix` (lines 266 and
// 529) outputs, are template options of pass B here.
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
// look-back) is later work.
//
// B1n. One 4 KiB step of pass B is 8 rows of 512 bytes and warp w holds row
// w, so a row's structural count is one __reduce_add_sync of the lanes'
// __popc(mask), stored by lane 0 (`emit_counts`). For `emit_prefix` the
// chunk's 128 row counts stay in shared memory; warp 0 scans them at the end
// of the chunk and writes the chunk-local inclusive prefix and the chunk
// total; one block scans the chunk totals (scan.cuh) and a third kernel adds
// each chunk's offset back (4 bytes a row), as B2 does. The emits are
// template parameters: the instantiation without them is the production
// kernel, unchanged. The TPU kernel built the same sums with ones and
// triangular int8 matmuls and a running total in SMEM.
//
// The dual-rail carry, the int8 MXU scans and the lane-placed pack matmuls
// of the TPU kernel were Mosaic workarounds and have no counterpart here.
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;
constexpr long long kChunkBytes = (long long)kStepBytes * kSteps;  // 64 KiB
constexpr int kRowBytes = 512;
constexpr int kChunkRows = (int)(kChunkBytes / kRowBytes);  // 128

// Pass B: mask and pack each chunk with its incoming carry. With kCounts,
// counts[r] = the structural count of row r; with kPrefix, prefix[r] = the
// inclusive prefix of the counts within the chunk and chunk_total[chunk] =
// the chunk's sum (n_bytes % 512 == 0 for either).
template <bool kCounts, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
mask_pack(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
          const int* __restrict__ chunk_carry, uint32_t* __restrict__ out,
          int* __restrict__ counts, int* __restrict__ prefix,
          int* __restrict__ chunk_total) {
  __shared__ uint32_t s_wpar[2][kWarps];
  __shared__ int s_rows[kPrefix ? kChunkRows : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kChunkBytes;
  const long long n_rows = n_bytes / kRowBytes;
  uint32_t carry = (uint32_t)chunk_carry[blockIdx.x] & 1u;
  for (int step = 0; step < kSteps; ++step) {
    const long long off = base + (long long)step * kStepBytes + threadIdx.x * 16;
    const uint32_t m = step_mask(in, off, n_bytes, c, carry, s_wpar, step);
    const uint32_t upper = __shfl_xor_sync(kFull, m, 1);
    // n_bytes % 32 == 0, so both threads of a pair are live or neither is
    if (off < n_bytes && !(lane & 1)) out[off >> 5] = m | (upper << 16);
    if constexpr (kCounts || kPrefix) {
      // warp `warp` holds row step * kWarps + warp of the chunk
      const int cnt = (int)__reduce_add_sync(kFull, __popc(m));
      const int local = step * kWarps + warp;
      const long long row = blockIdx.x * (long long)kChunkRows + local;
      if (lane == 0) {
        if (kCounts && row < n_rows) counts[row] = cnt;
        if (kPrefix) s_rows[local] = cnt;
      }
    }
  }
  if constexpr (kPrefix) {
    __syncthreads();
    if (warp == 0) {
      // lane l scans rows 4l..4l+3 of the chunk
      int v[4], t = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) t += (v[k] = s_rows[4 * lane + k]);
      const int incl = csv_scan::warp_inclusive_scan<csv_scan::Plus>(t, lane);
      int run = incl - t;
      const long long row0 = blockIdx.x * (long long)kChunkRows + 4 * lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += v[k];
        if (row0 + k < n_rows) prefix[row0 + k] = run;
      }
      if (lane == 31) chunk_total[blockIdx.x] = incl;
    }
  }
}

__global__ void __launch_bounds__(csv_scan::kThreads)
chunk_offset_scan(const int* __restrict__ chunk_total,
                  int* __restrict__ chunk_offset, int n_chunks,
                  int* __restrict__ total) {
  csv_scan::exclusive_scan_one_block<csv_scan::Plus>(
      chunk_total, chunk_offset, n_chunks, 0, total);
}

__global__ void add_chunk_offsets(int* __restrict__ prefix, long long n_rows,
                                  const int* __restrict__ chunk_offset) {
  const long long row =
      kChunkRows + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n_rows) prefix[row] += chunk_offset[row / kChunkRows];
}

}  // namespace

extern "C" {

// Number of 64 KiB chunks (pass A/B blocks) for n_bytes of input.
long long csv_stage1_v4_chunks(long long n_bytes) {
  return (n_bytes + kChunkBytes - 1) / kChunkBytes;
}

// Scratch ints for emit_prefix: chunk totals, chunk offsets, the total.
long long csv_stage1_v4_prefix_scratch(long long n_bytes) {
  return 2 * csv_stage1_v4_chunks(n_bytes) + 1;
}

// in: n_bytes of input (n_bytes > 0, a multiple of 32, 16-byte aligned).
// out: n_bytes / 32 words. chunk_scratch: 2 * csv_stage1_v4_chunks(n_bytes)
// ints. scalars: 2 ints (parity out, non-ASCII count). counter: one 64-bit
// scratch word. carry_ptr: a device int whose bit 0 is the carry-in, or null
// to take carry_in. structural: the delimiter and newlines, padded to five
// with repeats. counts (n_bytes / 512 ints) and prefix (as many) are null or
// B1n's outputs; either needs n_bytes % 512 == 0, and prefix needs
// prefix_scratch (csv_stage1_v4_prefix_scratch ints). Returns
// cudaGetLastError() after the launches.
int csv_stage1_v4(const void* in, long long n_bytes, void* out,
                  void* chunk_scratch, void* scalars, void* counter,
                  const void* carry_ptr, int carry_in, int count_nonascii,
                  int quote, int s0, int s1, int s2, int s3, int s4,
                  void* counts, void* prefix, void* prefix_scratch,
                  void* stream) {
  if (n_bytes <= 0 || n_bytes % 32 != 0) return (int)cudaErrorInvalidValue;
  if ((counts || prefix) && n_bytes % kRowBytes != 0)
    return (int)cudaErrorInvalidValue;
  if (prefix && !prefix_scratch) return (int)cudaErrorInvalidValue;
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
  const uint4* in4 = static_cast<const uint4*>(in);
  uint32_t* out_w = static_cast<uint32_t*>(out);
  int* counts_i = static_cast<int*>(counts);
  int* prefix_i = static_cast<int*>(prefix);
  int* chunk_total = static_cast<int*>(prefix_scratch);
  const unsigned grid = (unsigned)n_chunks;
  if (counts && prefix)
    mask_pack<true, true><<<grid, kThreads, 0, st>>>(
        in4, n_bytes, c, chunk_carry, out_w, counts_i, prefix_i, chunk_total);
  else if (counts)
    mask_pack<true, false><<<grid, kThreads, 0, st>>>(
        in4, n_bytes, c, chunk_carry, out_w, counts_i, nullptr, nullptr);
  else if (prefix)
    mask_pack<false, true><<<grid, kThreads, 0, st>>>(
        in4, n_bytes, c, chunk_carry, out_w, nullptr, prefix_i, chunk_total);
  else
    mask_pack<false, false><<<grid, kThreads, 0, st>>>(
        in4, n_bytes, c, chunk_carry, out_w, nullptr, nullptr, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess || !prefix || n_chunks == 1)
    return (int)err;
  int* chunk_offset = chunk_total + n_chunks;
  chunk_offset_scan<<<1, csv_scan::kThreads, 0, st>>>(
      chunk_total, chunk_offset, (int)n_chunks, chunk_offset + n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long tail = n_bytes / kRowBytes - kChunkRows;
  add_chunk_offsets<<<(unsigned)((tail + 255) / 256), 256, 0, st>>>(
      prefix_i, n_bytes / kRowBytes, chunk_offset);
  return (int)cudaGetLastError();
}

}  // extern "C"
