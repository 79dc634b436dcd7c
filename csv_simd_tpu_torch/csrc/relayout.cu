// The stage-1 relayouts for Hopper (sm_90a): B1's sequential words
// (stage1_v4.cu: bit m of word w covers byte 32w + m) permuted into the
// other bit layouts. B3, B6 and the `full` variant of the kbench probe are
// each B1's one pass (`mask_pack` on stage1_core.cuh `one_pass`, which
// reads the input once and takes the quote carry by look-back) followed by
// one of these kernels, which needs no carry: every layout is a bit
// permutation of B1's words.
//
// fold_words, B3's fold layout. With B1 it replaces
//   csv_simd_tpu/ops/stage1_v3.py `_stage1_v3_kernel` (line 106), launched
//   by `stage1_fused` (line 202). Per tile of T rows of 512 bytes, q = T/8:
//   bit 8b + sigma(j) of word (s*q + g, L) covers byte b of int32 lane L of
//   row s*T + j*q + g, which is bit 4(L mod 8) + b of sequential word
//   (s*T + j*q + g)*16 + L/8. A thread builds the 8 words of one output row
//   at lanes 8c..8c+7: for each j one 4-byte load (16 threads read a row's
//   64 bytes, a warp two neighbouring rows' 128), whose 8 nibbles go to
//   bits sigma(j) of the 8 words (stage1_core.cuh `transpose_nibbles`,
//   which the staged emit of probe_vnext.cu and probe_ablate.cu calls too),
//   then two 16-byte stores. A thread owns its words whole: no atomics, no
//   shared memory, and so any tile that is a multiple of 8 (the two-pass
//   kernel held a block's words in shared memory, which capped the tile at
//   3,200 rows). With B1 it is also the direct fold pack of the vnext probe
//   at tiles that do not divide 128 rows, and in the ablation probe's bit
//   order (bitrev3(j), adding the carry-in for v3_foldonly) its v3 and
//   v3_foldonly folds at such tiles, after that probe's own one pass.
// v1_words, B6's v1 layout. With B1 it replaces
//   csv_simd_tpu/ops/stage1_pallas.py `_stage1_kernel` (line 73), launched
//   by `stage1_pallas` (line 145), and tools/kbench.py's `roll` and
//   `tril_input` (`make_variant`, pallas_call line 142). Bit k of word
//   (s, lane) covers byte (32s + k)*128 + lane, which is bit lane mod 32 of
//   sequential word (32s + k)*4 + lane/32. A warp owns word row s: lane k
//   loads sequential words (32s + k)*4 .. +3 (the warp's 512 bytes in one
//   coalesced 16-byte load a lane), and for each c a 32 x 32 bit transpose
//   across the warp leaves word (s, 32c + i) in lane i; each of the 4
//   stores is 128 contiguous bytes a warp. The transpose is five butterfly
//   rounds of one __shfl_xor_sync each (`transpose32`): 20 shuffles a lane
//   for the warp's 128 words, where 128 __ballot_sync calls (one a word,
//   each kept by one lane) made the kernel 4x slower than its bytes on an
//   H100 and spilled the selected words to local memory. It counts the
//   structural bits of the words at index count_from and after (0: every
//   word, B6's count; the kbench probe's: the last tile's words),
//   per-thread __popc sums added with one atomicAdd a block.
//
// What bounds them on an H100: HBM bandwidth. Each reads N/8 and writes N/8
// bytes for N input bytes, 0.09 ms a GiB at the 3.05 TB/s the stream probe
// measured: far less than the second pass over the input (and its carry
// scan) that the two-pass kernels took.
#include "stage1_core.cuh"

namespace {

constexpr int kLanes = 128;    // int32 words a row of the output
constexpr int kRowWords = 16;  // B1's words a 512-byte row

// One thread a (fold output row o, lane group c); n_threads = out_rows * 16.
// kOrder: B3's order or the ablation probe's (stage1_core.cuh
// `transpose_nibbles`); with kAdd, every word adds the carry-in bit
// (*add_ptr when add_ptr is not null, else add).
template <int kOrder, bool kAdd>
__global__ void __launch_bounds__(kThreads)
fold_words(const uint32_t* __restrict__ seq, long long n_threads, unsigned q,
           const int* __restrict__ add_ptr, int add,
           uint32_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_threads) return;
  const unsigned o = (unsigned)(t >> 4), c = (unsigned)(t & 15);
  const unsigned s = o / q, g = o - s * q;
  // B1's word of row s*T + j*q + g, lanes 8c..8c+7
  const uint32_t* src = seq + ((long long)s * 8 * q + g) * kRowWords + c;
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = src[(long long)j * q * kRowWords];
  uint32_t acc[8];
  transpose_nibbles<kOrder>(w, acc);
  if constexpr (kAdd) {
    const uint32_t a = (uint32_t)(add_ptr ? *add_ptr : add) & 1u;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += a;
  }
  store_words8(out, o, (int)c, acc);
}

template <int kOrder, bool kAdd>
cudaError_t launch_fold_words(const uint32_t* seq, long long n_threads,
                              unsigned q, const int* add_ptr, int add,
                              uint32_t* out, cudaStream_t st) {
  fold_words<kOrder, kAdd>
      <<<(unsigned)((n_threads + kThreads - 1) / kThreads), kThreads, 0,
         st>>>(seq, n_threads, q, add_ptr, add, out);
  return cudaGetLastError();
}

// A 32 x 32 bit transpose across the warp: lane i gets the word whose bit
// k is bit i of lane k's x (lanes are rows, bits columns). Round j (16, 8,
// 4, 2, 1) swaps the two off-diagonal j x j blocks of every 2j x 2j block:
// a lane with lane & j clear keeps its bits b with b & j clear and takes
// those of lane ^ j into the others, shifted up by j; its partner the
// reverse. After the five rounds every block is transposed in place.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    // bits b with b & j clear: 0x0000FFFF, 0x00FF00FF, ... 0x55555555
    const uint32_t m = 0xFFFFFFFFu / ((1u << j) + 1u);
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
  }
  return x;
}

// One warp a word row s of the v1 layout, kWarps rows a block; seq as
// uint4, four of B1's words each.
__global__ void __launch_bounds__(kThreads)
v1_words(const uint4* __restrict__ seq, long long word_rows,
         long long count_from, uint32_t* __restrict__ out,
         int* __restrict__ count) {
  __shared__ unsigned s_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * kWarps + warp;
  unsigned mine = 0;
  if (s < word_rows) {  // the same for the whole warp
    const uint4 v = seq[s * 32 + lane];
    const uint32_t word[4] = {transpose32(v.x, lane), transpose32(v.y, lane),
                              transpose32(v.z, lane), transpose32(v.w, lane)};
    const long long row0 = s * kLanes + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[row0 + 32 * c] = word[c];
      if (row0 + 32 * c >= count_from) mine += __popc(word[c]);
    }
  }
  const unsigned w = __reduce_add_sync(kFull, mine);
  if (lane == 0) s_cnt[warp] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_cnt[i];
    if (total) atomicAdd(count, (int)total);
  }
}

}  // namespace

extern "C" {

// seq: B1's words of rows x 512 bytes (rows * 16 int32, 16-byte aligned).
// out: (rows / 8) x 128 words. tile: the fold tile in rows, a positive
// multiple of 8 that divides rows. order: 0 B3's fold (sigma(j)), 1 the
// ablation probe's (bitrev3(j)). add_ptr / add: the bit that every word
// adds (bit 0 of the device int at add_ptr when not null, else add & 1; B3
// adds none). Returns cudaGetLastError() after the launch.
int csv_fold_words(const void* seq, long long rows, int tile, int order,
                   const void* add_ptr, int add, void* out, void* stream) {
  if (rows <= 0 || tile <= 0 || tile % 8 != 0 || rows % tile != 0 ||
      rows / 8 > (1LL << 31) - 1 || (order != kOrderFold &&
                                     order != kOrderBitrev))
    return (int)cudaErrorInvalidValue;
  const long long n_threads = rows / 8 * 16;
  const uint32_t* s = static_cast<const uint32_t*>(seq);
  const int* ap = static_cast<const int*>(add_ptr);
  uint32_t* o = static_cast<uint32_t*>(out);
  const unsigned q = (unsigned)(tile / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool adds = ap != nullptr || (add & 1);
  if (order == kOrderFold)
    return (int)(adds ? launch_fold_words<kOrderFold, true>(
                            s, n_threads, q, ap, add, o, st)
                      : launch_fold_words<kOrderFold, false>(
                            s, n_threads, q, ap, add, o, st));
  return (int)(adds ? launch_fold_words<kOrderBitrev, true>(
                          s, n_threads, q, ap, add, o, st)
                    : launch_fold_words<kOrderBitrev, false>(
                          s, n_threads, q, ap, add, o, st));
}

// seq: B1's words of rows x 128 bytes (rows * 4 int32, 16-byte aligned),
// rows a positive multiple of 32. out: (rows / 32) x 128 words. count: one
// int, zeroed here (so a CUDA graph that captures the call replays right),
// then the structural count of out's words from flat index count_from on.
// Returns cudaGetLastError() after the launches.
int csv_v1_words(const void* seq, long long rows, long long count_from,
                 void* out, void* count, void* stream) {
  if (rows <= 0 || rows % 32 != 0 || count_from < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const long long word_rows = rows / 32;
  v1_words<<<(unsigned)((word_rows + kWarps - 1) / kWarps), kThreads, 0,
             st>>>(static_cast<const uint4*>(seq), word_rows, count_from,
                   static_cast<uint32_t*>(out), static_cast<int*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"
