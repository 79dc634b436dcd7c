// Kernel B2: the row popcount prefix for Hopper (sm_90a).
//
// Replaces csv_simd_tpu/offsetfree.py `_prefix_kernel` (line 107), launched by
// `_prefix_for_packed_pallas` through `prefix_for_packed`.
//
// What it computes: for packed structural words in row-major order, 16 words
// (512 input bytes) per row, out[r] = the number of set bits in rows 0..r.
// The narrow (rows, 16) and wide (rows/8, 128) layouts are the same memory,
// so one kernel serves both.
//
// What bounds it on an H100: HBM bandwidth. It reads 64 bytes and writes 4
// per row, 1/8 of the input bytes of the build in all.
//
// What the design does about it. Half a warp popcounts one row with __popc
// and a butterfly of __shfl_xor_sync; one warp iteration loads two rows, 128
// contiguous bytes. Each lane of a warp collects one row's count, a
// __shfl_up_sync scan turns 32 counts into inclusive prefixes, and the 8
// warps of a block combine in shared memory, with a running total over the
// block's 2048 rows. The TPU kernel carried that total in SMEM across an
// in-order grid; here blocks run in parallel, so their totals are scanned by
// one block in a second pass and added back in a third. Rows are addressed
// in 64 bits, so the input may pass 2 GiB; the counts are int32, and the
// tape refuses an input whose structural count reaches 2^31.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kThreads;  // 32 rows per warp per tile
constexpr int kTiles = 8;
constexpr long long kBlockRows = (long long)kTileRows * kTiles;  // 2048
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
row_prefix_local(const uint32_t* __restrict__ words, long long rows,
                 int* __restrict__ out, int* __restrict__ block_total) {
  __shared__ int s_warp[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, word = lane & 15;
  const long long block_row0 = (long long)blockIdx.x * kBlockRows;
  int running = 0;
  for (int tile = 0; tile < kTiles; ++tile) {
    const long long warp_row0 =
        block_row0 + (long long)tile * kTileRows + warp * 32;
    int mine = 0;  // the count of row warp_row0 + lane
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const long long row = warp_row0 + 2 * i + half;
      int c = row < rows ? __popc(words[row * 16 + word]) : 0;
      c += __shfl_xor_sync(kFull, c, 8);
      c += __shfl_xor_sync(kFull, c, 4);
      c += __shfl_xor_sync(kFull, c, 2);
      c += __shfl_xor_sync(kFull, c, 1);
      // row 2i summed in lanes 0..15, row 2i+1 in lanes 16..31
      const int even = __shfl_sync(kFull, c, 0);
      const int odd = __shfl_sync(kFull, c, 16);
      if ((lane >> 1) == i) mine = (lane & 1) ? odd : even;
    }
    const int incl = csv_scan::warp_inclusive_scan<csv_scan::Plus>(mine, lane);
    // two buffers, as in the stage-1 kernel: one barrier per tile
    const int buf = tile & 1;
    if (lane == 31) s_warp[buf][warp] = incl;
    __syncthreads();
    int before = 0, tile_total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int w = s_warp[buf][i];
      before += (i < warp) ? w : 0;
      tile_total += w;
    }
    const long long row = warp_row0 + lane;
    if (row < rows) out[row] = running + before + incl;
    running += tile_total;
  }
  if (threadIdx.x == 0) block_total[blockIdx.x] = running;
}

__global__ void __launch_bounds__(csv_scan::kThreads)
block_offset_scan(const int* __restrict__ block_total,
                  int* __restrict__ block_offset, int n_blocks,
                  int* __restrict__ total) {
  csv_scan::exclusive_scan_one_block<csv_scan::Plus>(
      block_total, block_offset, n_blocks, 0, total);
}

__global__ void add_block_offsets(int* __restrict__ out, long long rows,
                                  const int* __restrict__ block_offset) {
  const long long row = kBlockRows + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row < rows) out[row] += block_offset[row / kBlockRows];
}

}  // namespace

extern "C" {

// Scratch ints needed for `rows` rows: block totals, block offsets, total.
long long csv_row_prefix_scratch(long long rows) {
  return 2 * ((rows + kBlockRows - 1) / kBlockRows) + 1;
}

// words: rows * 16 packed int32 words; out: rows ints; scratch: see
// csv_row_prefix_scratch. Returns cudaGetLastError() after the launches.
int csv_row_prefix(const void* words, long long rows, void* out,
                   void* scratch, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const long long n_blocks = (rows + kBlockRows - 1) / kBlockRows;
  if (n_blocks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* block_total = static_cast<int*>(scratch);
  int* block_offset = block_total + n_blocks;
  int* out_i = static_cast<int*>(out);
  cudaError_t err;
  row_prefix_local<<<(unsigned)n_blocks, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(words), rows, out_i, block_total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_blocks > 1) {
    block_offset_scan<<<1, csv_scan::kThreads, 0, st>>>(
        block_total, block_offset, (int)n_blocks, block_offset + n_blocks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long tail = rows - kBlockRows;
    add_block_offsets<<<(unsigned)((tail + 255) / 256), 256, 0, st>>>(
        out_i, rows, block_offset);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
