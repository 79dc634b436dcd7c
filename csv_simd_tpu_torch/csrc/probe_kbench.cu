// The v1-layout variant probe for Hopper (sm_90a): the v1 layout's build
// with its quote masking cut back, to show what the masking costs in that
// layout.
//
// Replaces tools/kbench.py `make_variant` (pallas_call line 142), whose
// variants ran over (rows, 128) uint8 with the default dialect hard-coded
// (quote 0x22; delimiter 0x2C, newlines 0x0A and 0x0D) and wrote B6's v1
// layout: bit k of word (s, lane) covers byte (32s + k) * 128 + lane.
//   nopar     the structural bytes, no quote masking
//   lanescan  masked by the quote parity within each 128-byte row only
// (here). The third cut, `full` (the TPU's `roll` and `tril_input`, which
// differed in how they scanned the row totals), is masked by the quote
// parity over the input from the carry-in: B6's words, built as B6 builds
// them, by B1's one pass and relayout.cu `v1_words`.
// Each also returns a count that is the TPU grid's last write of its (0, 0)
// block: the structural count of the LAST tile (tile rows of 128 bytes)
// only, plus the carry-in for nopar and lanescan.
//
// What bounds it on an H100: HBM bandwidth (read N, write N/8).
//
// What the design does about it: 64 KiB chunks, 4 KiB steps (32 rows of
// 128 bytes, 8 threads a row, one 16-byte load a thread), the step's 16-bit
// masks in shared memory and a 32 x 128 bit transpose by 16 __ballot_sync a
// warp. lanescan's in-row parity is one __ballot_sync: the exclusive XOR of
// the row's 8 lanes below a thread. Neither cut takes a carry across rows.
// The mask buffer has two halves by step parity, so one barrier a step keeps
// a fast warp's next writes away from a slow warp's reads. The last-tile
// count adds the block's popcounts with one atomicAdd a block.
#include "stage1_core.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kSteps = 16;                                   // B6's chunk
constexpr long long kChunkBytes = (long long)kStepBytes * kSteps;  // 64 KiB

enum Variant { kVarNopar = 0, kVarLanescan, kVariants };

template <int kVar>
__global__ void __launch_bounds__(kThreads)
kbench_pass(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
            const int* __restrict__ carry_ptr, int carry_in,
            long long last_tile0, uint32_t* __restrict__ out,
            int* __restrict__ count) {
  __shared__ uint32_t s_m[2][kThreads];
  __shared__ unsigned s_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kChunkBytes;
  uint32_t mine = 0;
  for (int step = 0; step < kSteps; ++step) {
    const long long step0 = base + (long long)step * kStepBytes;
    const long long off = step0 + threadIdx.x * 16;
    uint32_t m, s = 0, q = 0;
    if (off < n_bytes) {
      const uint4 v = in[off >> 4];
      s = structural16(v, c);
      if (kVar == kVarLanescan) q = quote16(v, c);
    }
    if constexpr (kVar == kVarNopar) {
      m = s;
    } else {
      const uint32_t p = prefix_xor16(q);
      // a 128-byte row is 8 lanes: the parity of the row's lanes below
      const uint32_t bal = __ballot_sync(kFull, __popc(q) & 1u);
      const uint32_t below = bal & ((1u << lane) - 1u) & (0xFFu << (lane & 24));
      m = s & ~(p ^ (0u - (__popc(below) & 1u))) & 0xffffu;
    }
    if (step0 >= last_tile0) mine += __popc(m);
    const int buf = step & 1;
    s_m[buf][threadIdx.x] = m;
    __syncthreads();
    if (step0 >= n_bytes) continue;  // the same for the whole block
    // column 16w+i, bit k: thread 8k + w's mask, bit i
    const uint32_t mm = s_m[buf][lane * 8 + warp];
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t bal = __ballot_sync(kFull, (mm >> i) & 1u);
      if (lane == i) word = bal;
    }
    if (lane < 16) out[(step0 / kStepBytes) * kLanes + warp * 16 + lane] = word;
  }
  const unsigned w = __reduce_add_sync(kFull, mine);
  if (lane == 0) s_cnt[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_cnt[i];
    if (blockIdx.x == 0)
      total += (unsigned)(carry_ptr ? *carry_ptr : carry_in) & 1u;
    if (total) atomicAdd(count, (int)total);
  }
}

}  // namespace

extern "C" {

// in: (rows, 128) uint8, n_bytes = rows * 128, rows a positive multiple of
// tile, tile a positive multiple of 32. variant: 0 nopar, 1 lanescan (full
// is B6's pair of kernels: stage1_v4.cu and relayout.cu). out: n_bytes / 32
// words, as (rows / 32, 128). count: one int, the last tile's count plus the
// carry-in. carry_ptr: a device int whose bit 0 is the carry-in, or null to
// take carry_in. Returns cudaGetLastError() after the launches.
int csv_probe_kbench(int variant, const void* in, long long rows, int tile,
                     const void* carry_ptr, int carry_in, void* out,
                     void* count, void* stream) {
  if (rows <= 0 || tile <= 0 || tile % 32 != 0 || rows % tile != 0 ||
      variant < 0 || variant >= kVariants)
    return (int)cudaErrorInvalidValue;
  const long long n_bytes = rows * kLanes;
  const long long n_chunks = (n_bytes + kChunkBytes - 1) / kChunkBytes;
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {0x2C, 0x0A, 0x0D, 0x2C, 0x2C};
  const ByteClasses c = make_classes(0x22, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(count);
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const uint4* in4 = static_cast<const uint4*>(in);
  const int* cp = static_cast<const int*>(carry_ptr);
  uint32_t* o = static_cast<uint32_t*>(out);
  const long long last_tile0 = n_bytes - (long long)tile * kLanes;
  if (variant == kVarNopar)
    kbench_pass<kVarNopar><<<(unsigned)n_chunks, kThreads, 0, st>>>(
        in4, n_bytes, c, cp, carry_in, last_tile0, o, cnt);
  else
    kbench_pass<kVarLanescan><<<(unsigned)n_chunks, kThreads, 0, st>>>(
        in4, n_bytes, c, cp, carry_in, last_tile0, o, cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
