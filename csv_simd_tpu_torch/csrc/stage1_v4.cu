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
// byte and write one bit; the classify is a few SIMD-in-word operations per
// 4 bytes and target, under the card's integer rate.
//
// What the design does about it: it reads the input once (stage1_core.cuh
// `one_pass`). A resident block takes 64 KiB chunks of 16 4 KiB steps from
// an atomic ticket and issues all 16 of a thread's 16-byte loads at once,
// neighbouring threads on neighbouring addresses. The classify is the
// shared-subexpression SWAR form when the dialect's bytes are all < 0x80
// and __vcmpeq4 otherwise (a template flag chosen on the host; the TPU
// kernel had the same two branches). One barrier gives each thread its
// quote parity before each of its steps within the chunk; the carry into
// the chunk comes by decoupled look-back over the chunks' status words, a
// round later, while the next chunk is classified and the one after it
// loads. The C entry point zeroes the status words and the ticket
// (cudaMemsetAsync), so a CUDA graph that captures it replays right. The
// TPU kernel carried the parity through SMEM because its grid runs in
// order. Stores are one
// 32-bit word per thread pair (the pair's 16-bit masks joined with
// __shfl_xor_sync), 64 contiguous bytes a warp.
//
// B1n. One 4 KiB step is 8 rows of 512 bytes and warp w holds row w, so a
// row's structural count is one __reduce_add_sync of the lanes'
// __popc(mask), stored by lane 0 (`emit_counts`). For `emit_prefix` the
// chunk's 128 row counts stay in shared memory; warp 0 scans them at the end
// of the chunk and writes the chunk-local inclusive prefix and the chunk
// total; one block scans the chunk totals (scan.cuh) and a third kernel adds
// each chunk's offset back (4 bytes a row), as B2 does. The emits are
// template parameters: the instantiation without them is the production
// kernel. The TPU kernel built the same sums with ones and triangular int8
// matmuls and a running total in SMEM.
//
// The dual-rail carry, the int8 MXU scans and the lane-placed pack matmuls
// of the TPU kernel were Mosaic workarounds and have no counterpart here.
#include "scan.cuh"
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;
constexpr long long kChunkBytes = (long long)kStepBytes * kSteps;  // 64 KiB
constexpr int kRowBytes = 512;
constexpr int kChunkRows = (int)(kChunkBytes / kRowBytes);  // 128

// Mask and pack every chunk, in one pass, each block over its run of
// chunks (stage1_core.cuh `one_pass`). With kCounts, counts[r] =
// the structural count of row r; with kPrefix, prefix[r] = the inclusive
// prefix of the counts within the chunk and chunk_total[chunk] = the
// chunk's sum (n_bytes % 512 == 0 for either). kAscii: the SWAR classify.
template <bool kCounts, bool kPrefix, bool kAscii>
__global__ void __launch_bounds__(kThreads, 2)
mask_pack(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
          OnePass g, uint32_t* __restrict__ out, int* __restrict__ counts,
          int* __restrict__ prefix, int* __restrict__ chunk_total) {
  __shared__ OnePassShared sh;
  __shared__ int s_rows[kPrefix ? kChunkRows : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_rows = n_bytes / kRowBytes;
  one_pass<kSteps, kAscii>(in, n_bytes, c, g, sh, [&](
      int chunk, const ChunkMasks<kSteps>& cm) {
    const long long base = (long long)chunk * kChunkBytes;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const long long off =
          base + (long long)step * kStepBytes + threadIdx.x * 16;
      const uint32_t m = cm.mask(step);
      const uint32_t upper = __shfl_xor_sync(kFull, m, 1);
      // n_bytes % 32 == 0, so both threads of a pair are live or neither is
      if (off < n_bytes && !(lane & 1)) out[off >> 5] = m | (upper << 16);
      if constexpr (kCounts || kPrefix) {
        // warp `warp` holds row step * kWarps + warp of the chunk
        const int cnt = (int)__reduce_add_sync(kFull, __popc(m));
        const int local = step * kWarps + warp;
        const long long row = chunk * (long long)kChunkRows + local;
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
        const int incl =
            csv_scan::warp_inclusive_scan<csv_scan::Plus>(t, lane);
        int run = incl - t;
        const long long row0 = chunk * (long long)kChunkRows + 4 * lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          run += v[k];
          if (row0 + k < n_rows) prefix[row0 + k] = run;
        }
        if (lane == 31) chunk_total[chunk] = incl;
      }
    }
  });
}

template <bool kCounts, bool kPrefix, bool kAscii>
cudaError_t launch_mask_pack(cudaStream_t st, const uint4* in,
                             long long n_bytes, const ByteClasses& c,
                             const OnePass& g, uint32_t* out, int* counts,
                             int* prefix, int* chunk_total) {
  unsigned grid = 0;
  cudaError_t err =
      one_pass_grid(mask_pack<kCounts, kPrefix, kAscii>, g.n_chunks, grid);
  if (err != cudaSuccess) return err;
  mask_pack<kCounts, kPrefix, kAscii><<<grid, kThreads, 0, st>>>(
      in, n_bytes, c, g, out, counts, prefix, chunk_total);
  return cudaGetLastError();
}

template <bool kCounts, bool kPrefix>
cudaError_t launch_mask_pack(bool ascii, cudaStream_t st, const uint4* in,
                             long long n_bytes, const ByteClasses& c,
                             const OnePass& g, uint32_t* out, int* counts,
                             int* prefix, int* chunk_total) {
  return ascii ? launch_mask_pack<kCounts, kPrefix, true>(
                     st, in, n_bytes, c, g, out, counts, prefix, chunk_total)
               : launch_mask_pack<kCounts, kPrefix, false>(
                     st, in, n_bytes, c, g, out, counts, prefix, chunk_total);
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

// Number of 64 KiB chunks (blocks) for n_bytes of input.
long long csv_stage1_v4_chunks(long long n_bytes) {
  return (n_bytes + kChunkBytes - 1) / kChunkBytes;
}

// Scratch ints for emit_prefix: chunk totals, chunk offsets, the total.
long long csv_stage1_v4_prefix_scratch(long long n_bytes) {
  return 2 * csv_stage1_v4_chunks(n_bytes) + 1;
}

// in: n_bytes of input (n_bytes > 0, a multiple of 32, 16-byte aligned).
// out: n_bytes / 32 words. chunk_scratch: 2 * csv_stage1_v4_chunks(n_bytes)
// ints (the chunks' status words and the ticket, zeroed here). scalars: 2
// ints (parity out, non-ASCII count). counter: one 64-bit scratch word.
// carry_ptr: a device int whose bit 0 is the carry-in, or null to take
// carry_in. structural: the delimiter and newlines, padded to five with
// repeats. counts (n_bytes / 512 ints) and prefix (as many) are null or
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
  const bool ascii = ascii_classes(quote, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  OnePass g{};
  g.carry_ptr = static_cast<const int*>(carry_ptr);
  g.carry_in = carry_in;
  g.count_nonascii = count_nonascii;
  g.nonascii = static_cast<unsigned long long*>(counter);
  g.scalars = static_cast<int*>(scalars);
  cudaError_t err = reset_one_pass(g, chunk_scratch, n_chunks, st);
  if (err != cudaSuccess) return (int)err;
  const uint4* in4 = static_cast<const uint4*>(in);
  uint32_t* out_w = static_cast<uint32_t*>(out);
  int* counts_i = static_cast<int*>(counts);
  int* prefix_i = static_cast<int*>(prefix);
  int* chunk_total = static_cast<int*>(prefix_scratch);
  if (counts && prefix)
    err = launch_mask_pack<true, true>(ascii, st, in4, n_bytes, c, g, out_w,
                                       counts_i, prefix_i, chunk_total);
  else if (counts)
    err = launch_mask_pack<true, false>(ascii, st, in4, n_bytes, c, g, out_w,
                                        counts_i, nullptr, nullptr);
  else if (prefix)
    err = launch_mask_pack<false, true>(ascii, st, in4, n_bytes, c, g, out_w,
                                        nullptr, prefix_i, chunk_total);
  else
    err = launch_mask_pack<false, false>(ascii, st, in4, n_bytes, c, g, out_w,
                                         nullptr, nullptr, nullptr);
  if (err != cudaSuccess || !prefix || n_chunks == 1) return (int)err;
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
