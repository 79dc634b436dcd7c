// The stage-ablation probe for Hopper (sm_90a): the stage-1 build cut after
// each of its stages, to show what each stage costs on the card.
//
// Replaces tools/ablate.py `mk` (pallas_call line 149), which cut the v2/v3
// stage-1 kernel over (rows, 128) int32 at a compile-time stage, with the
// default dialect hard-coded (quote 0x22; delimiter 0x2C, newlines 0x0A and
// 0x0D). Per tile of T rows (T % 8 == 0) it writes T/8 rows of 128 words:
//   dma_only       x[first T/8 rows] + c
//   classify_only  (sf | qf)[first T/8 rows] + c
//   inword         (sf & ~p_in)[first T/8 rows] + wp[first T/8 rows] + c
//   noscan         sum over k < 8 of (sf & ~p_in)[8g + k] >> (7 - k), + c
//   full           sum over k < 8 of masked[8g + k] >> (7 - k)
//   v3, v3i8       the fold pack of masked: bit 8b + bitrev3(j) of word
//                  (g, lane) = byte b's flag of row jT/8 + g
//   v3_foldonly    the fold pack of sf & ~p_in, + c
//   v3_mmonly      base[first T/8 rows]
// where sf and qf are the 0x80 flags of the structural and quote bytes,
// p_in the in-word inclusive prefix XOR of qf, wp its bit 31 (the word's
// quote parity), base the quote parity before the word over the whole
// stream from the carry-in (0/1), masked = sf & ~(p_in ^ (base * 0x80808080))
// and `>>` the int32 arithmetic shift (the 8-row sums wrap). full, v3, v3i8
// and v3_mmonly carry the quote parity across tiles; the other modes add the
// carry-in c unchanged. v3 and v3i8 differ on the TPU only in the matmul
// type of the scans, so they are one mode here. Their words are not B3's:
// B3 places row j's flag at bit 8b + 7 - bitrev3(j), the bit reversal of
// each byte of these, so they are not served from B3.
//
// What bounds it on an H100: by design HBM bandwidth for every cut (one
// read of the input, a write of 1/8 of it), plus the carry's pass A for the
// chained cuts. Its pass walks a block's rows in B1's 4 KiB steps (one
// 16-byte load a thread a step), but its blocks are B3's: each owns whole
// tiles (256 KiB at tile 512) with their out words in shared memory. What
// it reaches against the stream probe describes this layout, not B1's.
// The dma_only, classify_only, inword and v3_mmonly outputs depend on 1/8
// of the input, so each cut also writes one side word per tile, the XOR over
// the tile of the value it stores (x, sf | qf, ...): every word is computed,
// as on the TPU, and the side words are checked against the plain version.
//
// What the design does about it. One pass over stage1_core.cuh, templated on
// the cut: 4 KiB steps (warp w holds row w of the step, a thread 4 words),
// the chained cuts' carry from launch_carry and step_carry, and a block that
// owns whole tiles (at least 64 KiB) with its out words in shared memory: the
// first-rows cuts store their words there, the 8-row sums add with shared
// atomics and the fold packs OR with them; the block then writes its words
// once, coalesced.
#include "stage1_core.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kStepRows = kStepBytes / 512;  // 8 rows of 512 bytes a step
constexpr int kMaxSharedBytes = 200 * 1024;
constexpr uint32_t kHi = 0x80808080u;

enum Cut {
  kCutDma = 0, kCutClassify, kCutInword, kCutNoscan, kCutFull, kCutV3,
  kCutV3Fold, kCutV3Mm, kCuts
};

__host__ __device__ constexpr bool chained(int m) {
  return m == kCutFull || m == kCutV3 || m == kCutV3Mm;
}
__host__ __device__ constexpr bool first_rows(int m) {
  return m == kCutDma || m == kCutClassify || m == kCutInword ||
         m == kCutV3Mm;
}
__host__ __device__ constexpr bool row_sums(int m) {
  return m == kCutNoscan || m == kCutFull;
}

__device__ __forceinline__ int bitrev3(int j) {
  return ((j & 1) << 2) | (j & 2) | ((j >> 2) & 1);
}

// Rows a block owns: whole tiles, at least 128 rows (64 KiB) when the tile
// is small.
long long rows_per_block(int tile) {
  const int tiles = tile < 128 ? 128 / tile : 1;
  return (long long)tiles * tile;
}

long long shared_bytes(int tile) {
  const long long rows = rows_per_block(tile);
  return rows / 8 * kLanes * 4 + rows / tile * 4;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
ablate_pass(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
            const int* __restrict__ chunk_carry,
            const int* __restrict__ carry_ptr, int carry_in, int tile,
            int block_rows, uint32_t* __restrict__ out,
            uint32_t* __restrict__ side) {
  extern __shared__ __align__(16) uint32_t s_out[];
  __shared__ uint32_t s_wpar[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int out_words = block_rows / 8 * kLanes;
  const int tiles = block_rows / tile;
  uint32_t* s_side = s_out + out_words;
  for (int i = threadIdx.x; i < out_words + tiles; i += kThreads) s_out[i] = 0;
  __syncthreads();
  const int q = tile / 8;
  const long long base = (long long)blockIdx.x * block_rows * 512;
  uint32_t carry = chained(kMode) ? (uint32_t)chunk_carry[blockIdx.x] & 1u : 0u;
  for (int step = 0; step < block_rows / kStepRows; ++step) {
    const long long off = base + (long long)step * kStepBytes + threadIdx.x * 16;
    const bool live = off < n_bytes;  // whole rows: the same for a warp
    uint4 v = make_uint4(0, 0, 0, 0);
    if (live) v = in[off >> 4];
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    uint32_t sf[4], qf[4], p_in[4], wp[4], val[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t s = 0;
#pragma unroll
      for (int i = 0; i < kMaxStructural; ++i) s |= __vcmpeq4(x[k], c.structural[i]);
      sf[k] = s & kHi;
      qf[k] = __vcmpeq4(x[k], c.quote) & kHi;
      uint32_t p = qf[k] ^ (qf[k] << 8);
      p_in[k] = p ^ (p << 16);
      wp[k] = p_in[k] >> 31;
    }
    if constexpr (chained(kMode)) {
      uint32_t b = step_carry(wp[0] ^ wp[1] ^ wp[2] ^ wp[3], carry, s_wpar,
                              step);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t masked = sf[k] & ~(p_in[k] ^ ((0u - b) & kHi));
        val[k] = kMode == kCutV3Mm ? b : masked;
        b ^= wp[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (kMode == kCutDma) val[k] = x[k];
        else if (kMode == kCutClassify) val[k] = sf[k] | qf[k];
        else if (kMode == kCutInword) val[k] = (sf[k] & ~p_in[k]) + wp[k];
        else val[k] = sf[k] & ~p_in[k];  // noscan, v3_foldonly
      }
    }
    const int rr = step * kStepRows + warp;  // row within the block
    const int ti = rr / tile, rt = rr - ti * tile;
    const uint32_t t = __reduce_xor_sync(kFull, val[0] ^ val[1] ^ val[2] ^ val[3]);
    if (!live) continue;
    if (lane == 0) atomicXor(&s_side[ti], t);
    if constexpr (first_rows(kMode)) {
      if (rt < q) {
        uint32_t* dst = s_out + (ti * q + rt) * kLanes + 4 * lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) dst[k] = val[k];
      }
    } else if constexpr (row_sums(kMode)) {
      uint32_t* dst = s_out + (ti * q + rt / 8) * kLanes + 4 * lane;
      const int sh = 7 - (rt & 7);
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicAdd(dst + k, (uint32_t)((int)val[k] >> sh));
    } else {
      const int j = rt / q, g = rt - j * q, br = bitrev3(j);
      uint32_t* dst = s_out + (ti * q + g) * kLanes + 4 * lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t f = (val[k] >> 7) & 0x01010101u;
        if (f) atomicOr(dst + k, f << br);
      }
    }
  }
  __syncthreads();
  const uint32_t cin =
      chained(kMode) ? 0u : (uint32_t)(carry_ptr ? *carry_ptr : carry_in) & 1u;
  const long long out0 = (long long)blockIdx.x * out_words;
  const long long total = n_bytes / 32;
  for (int i = threadIdx.x; i < out_words; i += kThreads)
    if (out0 + i < total) out[out0 + i] = s_out[i] + cin;
  const long long tile0 = (long long)blockIdx.x * tiles;
  const long long n_tiles = n_bytes / 512 / tile;
  for (int i = threadIdx.x; i < tiles; i += kThreads)
    if (tile0 + i < n_tiles) side[tile0 + i] = s_side[i];
}

template <int kMode>
cudaError_t launch(unsigned grid, int smem, cudaStream_t st, const uint4* in,
                   long long n_bytes, const ByteClasses& c,
                   const int* chunk_carry, const int* carry_ptr, int carry_in,
                   int tile, int block_rows, uint32_t* out, uint32_t* side) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ablate_pass<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ablate_pass<kMode><<<grid, kThreads, smem, st>>>(
      in, n_bytes, c, chunk_carry, carry_ptr, carry_in, tile, block_rows, out,
      side);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest tile (rows) the probe takes: its block's words must fit in
// shared memory.
int csv_probe_ablate_max_tile() {
  int tile = 8;
  while (shared_bytes(tile + 8) <= kMaxSharedBytes) tile += 8;
  return tile;
}

// Number of blocks (and chunk-scratch pairs) for rows rows at tile.
long long csv_probe_ablate_chunks(long long rows, int tile) {
  const long long r = rows_per_block(tile);
  return (rows + r - 1) / r;
}

// in: (rows, 128) int32, rows a positive multiple of tile, tile a multiple
// of 8 up to csv_probe_ablate_max_tile(). mode: 0 dma_only, 1 classify_only,
// 2 inword, 3 noscan, 4 full, 5 v3 (and v3i8), 6 v3_foldonly, 7 v3_mmonly.
// out: rows * 16 ints, as (rows/8, 128). side: rows / tile words.
// chunk_scratch: 2 * csv_probe_ablate_chunks ints; scalars: 2 ints (the
// chained modes' parity out, -1). carry_ptr: a device int whose bit 0 is the
// carry-in, or null to take carry_in. Returns cudaGetLastError() after the
// launches.
int csv_probe_ablate(int mode, const void* in, long long rows, int tile,
                     const void* carry_ptr, int carry_in, void* out,
                     void* side, void* chunk_scratch, void* scalars,
                     void* stream) {
  if (rows <= 0 || tile <= 0 || tile % 8 != 0 || rows % tile != 0 ||
      tile > csv_probe_ablate_max_tile() || mode < 0 || mode >= kCuts)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_probe_ablate_chunks(rows, tile);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {0x2C, 0x0A, 0x0D, 0x2C, 0x2C};
  const ByteClasses c = make_classes(0x22, structural);
  const long long n_bytes = rows * 512;
  const int block_rows = (int)rows_per_block(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* chunk_par = static_cast<int*>(chunk_scratch);
  int* chunk_carry = chunk_par + n_chunks;
  if (chained(mode)) {
    cudaError_t err = launch_carry(in, n_bytes, block_rows / kStepRows,
                                   n_chunks, c, 0, chunk_par, chunk_carry,
                                   nullptr, carry_ptr, carry_in,
                                   static_cast<int*>(scalars), st);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)n_chunks;
  const int smem = (int)shared_bytes(tile);
  const uint4* in4 = static_cast<const uint4*>(in);
  const int* cp = static_cast<const int*>(carry_ptr);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* sd = static_cast<uint32_t*>(side);
#define CSV_ABLATE_CASE(M)                                                   \
  case M:                                                                    \
    return (int)launch<M>(grid, smem, st, in4, n_bytes, c, chunk_carry, cp,  \
                          carry_in, tile, block_rows, o, sd);
  switch (mode) {
    CSV_ABLATE_CASE(kCutDma)
    CSV_ABLATE_CASE(kCutClassify)
    CSV_ABLATE_CASE(kCutInword)
    CSV_ABLATE_CASE(kCutNoscan)
    CSV_ABLATE_CASE(kCutFull)
    CSV_ABLATE_CASE(kCutV3)
    CSV_ABLATE_CASE(kCutV3Fold)
    CSV_ABLATE_CASE(kCutV3Mm)
  }
#undef CSV_ABLATE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
