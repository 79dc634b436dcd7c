// The B1 stage-cut probe for Hopper (sm_90a): the two-pass B1's pass B cut
// after each of its stages, and B1's one pass (v4full). The eight cuts
// before v4full measure the stages of that two-pass-era pass B, one 16-byte
// load a thread a step, not of B1's one pass; they stay on it because each
// runs at 60% of its bound or better (a kernel at half its bound is not
// redesigned). The stages of B1's one pass are measured by probe_ablate.cu.
//
// Replaces tools/ablate2.py `mk_microkernel` (pallas_call line 136), which
// cut the v4 build (B1) at ten stages over (rows, 128) int32 with the default
// dialect hard-coded (quote 0x22; delimiter 0x2C, newlines 0x0A and 0x0D).
// Per row r of 512 bytes it writes 16 int32 words; t = (c + r / tile) & 1 is
// the TPU kernel's SMEM toggle at r's tile, from the carry-in c:
//   cls22   (sf | qf)[r, k] + t for k < 16: B1's classify (__vcmpeq4) as 0x80
//           flags of the structural and quote bytes, first 16 words
//   cls18   (us | uq)[r, k] + t: the TPU v4's shared-subexpression SWAR
//           classify (ops/swar.py swar_classify_u), 0x01 flags
//   prep    (vs + vq)[r, k] + t: the 4-bit nibbles of the structural and
//           quote flags of each word (B1's quote16 / structural16)
//   mm1     the low 16 bits of pack1's word + t: the even thread's mask
//   pack1   sw + t: B1's narrow words of the structural bytes, no quotes
//           (pack1slice is the same cut: they differed in a Mosaic construct)
//   pack2   (sw ^ qw) + t: both packs joined
//   px      (sw & ~px) + t: px the in-word inclusive prefix XOR of qw
//   lane    sw & ~(px ^ -base): base the quote parity before the word within
//           its row, starting from t
//   v4full  B1's narrow words: the quote parity chained across the input
// The bf16 MXU pack of the TPU kernel gave exact integers (nibbles times
// powers of 16); here the thread pair's 16-bit masks join with a shuffle, as
// in B1. cls22, cls18, prep and mm1 store words that depend on part of the
// input, so they also write one side word per 64 KiB chunk, the XOR over the
// chunk of the value they compute (sf | qf, us | uq, vs + vq, and mm1's whole
// word sw), so every input word is classified, as on the TPU.
//
// What bounds it on an H100: HBM bandwidth for every cut (read N, write N/16).
//
// What the design does about it: the cuts before v4full are the two-pass
// B1's pass B, templated on the cut (`ablate2_pass`): 64 KiB chunks a
// block, 4 KiB steps, warp w on row w of the step, one 16-byte load a
// thread, thread pairs join their 16-bit masks into one 32-bit word with
// __shfl_xor_sync, stores 64 contiguous bytes a warp. v4full is B1's one
// pass (`ablate2_v4full` on stage1_core.cuh `one_pass`, the default
// dialect's SWAR classify, the same chunk and stores as B1's `mask_pack`),
// so its words are B1's and its time is B1's. The toggle changes only at
// tile boundaries, which are whole steps (tile % 8 == 0), so each block
// divides once and counts rows after that.
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;                                   // B1's chunk
constexpr long long kChunkBytes = (long long)kStepBytes * kSteps;  // 64 KiB
constexpr int kStepRows = kStepBytes / 512;                  // 8 rows a step
constexpr int kChunkRows = kSteps * kStepRows;               // 128
constexpr uint32_t kHi = 0x80808080u, kLo7 = 0x7F7F7F7Fu, kOnes = 0x01010101u;

enum Cut {
  kCls22 = 0, kCls18, kPrep, kMm1, kPack1, kPack2, kPx, kLane, kV4full, kCuts
};

__host__ __device__ constexpr bool has_side(int m) { return m <= kMm1; }
__host__ __device__ constexpr bool first_words(int m) { return m <= kPrep; }

// ops/swar.py swar_classify_u for the default dialect: (us | uq), 0x01 flags
__device__ __forceinline__ uint32_t classify_u(uint32_t x) {
  const uint32_t xl = x & kLo7, xh = x & kHi;
  const uint32_t ts = ((xl ^ 0x0A0A0A0Au) + kLo7) & ((xl ^ 0x0D0D0D0Du) + kLo7) &
                      ((xl ^ 0x2C2C2C2Cu) + kLo7);
  const uint32_t tq = (xl ^ 0x22222222u) + kLo7;
  return ((~(ts | xh) >> 7) & kOnes) | ((~(tq | xh) >> 7) & kOnes);
}

// B1's classify as 0x80 flags: (sf | qf) of one word
__device__ __forceinline__ uint32_t classify_80(uint32_t x, const ByteClasses& c) {
  uint32_t m = __vcmpeq4(x, c.quote);
#pragma unroll
  for (int i = 0; i < kMaxStructural; ++i) m |= __vcmpeq4(x, c.structural[i]);
  return m & kHi;
}

template <int kCut>
__global__ void __launch_bounds__(kThreads)
ablate2_pass(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
             const int* __restrict__ carry_ptr, int carry_in, int tile,
             uint32_t* __restrict__ out, uint32_t* __restrict__ side) {
  __shared__ uint32_t s_side;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kChunkBytes;
  const int row0 = blockIdx.x * kChunkRows;
  const uint32_t cin = (uint32_t)(carry_ptr ? *carry_ptr : carry_in) & 1u;
  uint32_t t = (cin + (uint32_t)(row0 / tile)) & 1u;
  int left = tile - row0 % tile;  // rows of the current tile from this step on
  if constexpr (has_side(kCut)) {
    if (threadIdx.x == 0) s_side = 0;
    __syncthreads();
  }
  uint32_t xs = 0;  // this thread's XOR of the side value
  for (int step = 0; step < kSteps; ++step) {
    const long long off = base + (long long)step * kStepBytes + threadIdx.x * 16;
    // rows % 8 == 0: a step is live or not for the whole block
    if (off >= n_bytes) break;
    if (left == 0) {
      t ^= 1u;
      left = tile;
    }
    left -= kStepRows;
    const uint4 v = in[off >> 4];
    if constexpr (first_words(kCut)) {
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
      uint32_t val[4];
      if constexpr (kCut == kPrep) {
        const uint32_t s = structural16(v, c), q = quote16(v, c);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          val[k] = ((s >> (4 * k)) & 0xFu) + ((q >> (4 * k)) & 0xFu);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          val[k] = kCut == kCls22 ? classify_80(x[k], c) : classify_u(x[k]);
      }
      xs ^= val[0] ^ val[1] ^ val[2] ^ val[3];
      // words 0..15 of the row are lanes 0..3's
      if (lane < 4)
        reinterpret_cast<uint4*>(out)[(off >> 9) * 4 + lane] =
            make_uint4(val[0] + t, val[1] + t, val[2] + t, val[3] + t);
    } else {
      const uint32_t s = structural16(v, c);
      uint32_t m, add = t;
      if constexpr (kCut == kMm1 || kCut == kPack1) {
        m = s;
      } else if constexpr (kCut == kPack2) {
        m = s ^ quote16(v, c);
      } else {
        const uint32_t q = quote16(v, c);
        const uint32_t p = prefix_xor16(q);
        uint32_t before;
        if constexpr (kCut == kPx) {
          // the odd thread of a pair continues the even one's parity
          const uint32_t partner = __shfl_xor_sync(kFull, __popc(q) & 1u, 1);
          before = (lane & 1) ? partner : 0u;
        } else {  // lane: the parity before this thread within the row
          const uint32_t bal = __ballot_sync(kFull, __popc(q) & 1u);
          before = t ^ (__popc(bal & ((1u << lane) - 1u)) & 1u);
          add = 0;
        }
        m = s & ~(p ^ (0u - before)) & 0xffffu;
      }
      if constexpr (kCut == kMm1) {
        xs ^= (lane & 1) ? m << 16 : m;
        if (!(lane & 1)) out[off >> 5] = m + add;
      } else {
        const uint32_t upper = __shfl_xor_sync(kFull, m, 1);
        if (!(lane & 1)) out[off >> 5] = (m | (upper << 16)) + add;
      }
    }
  }
  if constexpr (has_side(kCut)) {
    const uint32_t w = __reduce_xor_sync(kFull, xs);
    if (lane == 0) atomicXor(&s_side, w);
    __syncthreads();
    if (threadIdx.x == 0) side[blockIdx.x] = s_side;
  }
}

// v4full: B1's narrow words by B1's one pass (stage1_v4.cu `mask_pack`
// without emits)
__global__ void __launch_bounds__(kThreads, 2)
ablate2_v4full(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
               OnePass g, uint32_t* __restrict__ out) {
  __shared__ OnePassShared sh;
  const int lane = threadIdx.x & 31;
  one_pass<kSteps, true>(in, n_bytes, c, g, sh, [&](
      int chunk, const ChunkMasks<kSteps>& cm) {
    const long long base = (long long)chunk * kChunkBytes;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const long long off =
          base + (long long)step * kStepBytes + threadIdx.x * 16;
      const uint32_t m = cm.mask(step);
      const uint32_t upper = __shfl_xor_sync(kFull, m, 1);
      if (off < n_bytes && !(lane & 1)) out[off >> 5] = m | (upper << 16);
    }
  });
}

template <int kCut>
cudaError_t launch(unsigned grid, cudaStream_t st, const uint4* in,
                   long long n_bytes, const ByteClasses& c,
                   const int* carry_ptr, int carry_in, int tile, uint32_t* out,
                   uint32_t* side) {
  ablate2_pass<kCut><<<grid, kThreads, 0, st>>>(
      in, n_bytes, c, carry_ptr, carry_in, tile, out, side);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of 64 KiB chunks (blocks, side words, chunk-scratch pairs) for rows
// rows of 512 bytes.
long long csv_probe_ablate2_chunks(long long rows) {
  return (rows + kChunkRows - 1) / kChunkRows;
}

// in: (rows, 128) int32, rows a positive multiple of tile, tile a positive
// multiple of 8. cut: 0 cls22, 1 cls18, 2 prep, 3 mm1, 4 pack1 (and
// pack1slice), 5 pack2, 6 px, 7 lane, 8 v4full. out: rows * 16 ints, as
// (rows, 16). side: csv_probe_ablate2_chunks(rows) words, written by cuts 0-3.
// chunk_scratch: 2 * csv_probe_ablate2_chunks(rows) ints (v4full's status
// words and ticket); scalars: 2 ints (v4full's parity out, -1). carry_ptr:
// a device int whose bit 0 is the carry-in, or null to take carry_in.
// Returns cudaGetLastError() after the launches.
int csv_probe_ablate2(int cut, const void* in, long long rows, int tile,
                      const void* carry_ptr, int carry_in, void* out,
                      void* side, void* chunk_scratch, void* scalars,
                      void* stream) {
  if (rows <= 0 || tile <= 0 || tile % 8 != 0 || rows % tile != 0 ||
      rows > (1LL << 30) || cut < 0 || cut >= kCuts)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_probe_ablate2_chunks(rows);
  const int structural[kMaxStructural] = {0x2C, 0x0A, 0x0D, 0x2C, 0x2C};
  const ByteClasses c = make_classes(0x22, structural);
  const long long n_bytes = rows * 512;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)n_chunks;
  const uint4* in4 = static_cast<const uint4*>(in);
  const int* cp = static_cast<const int*>(carry_ptr);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* sd = static_cast<uint32_t*>(side);
  if (cut == kV4full) {
    OnePass g{};
    g.carry_ptr = cp;
    g.carry_in = carry_in;
    g.scalars = static_cast<int*>(scalars);
    unsigned v4_grid = 0;
    cudaError_t err = reset_one_pass(g, chunk_scratch, n_chunks, st);
    if (err == cudaSuccess)
      err = one_pass_grid(ablate2_v4full, n_chunks, v4_grid);
    if (err != cudaSuccess) return (int)err;
    ablate2_v4full<<<v4_grid, kThreads, 0, st>>>(in4, n_bytes, c, g, o);
    return (int)cudaGetLastError();
  }
#define CSV_ABLATE2_CASE(M)                                                  \
  case M:                                                                    \
    return (int)launch<M>(grid, st, in4, n_bytes, c, cp, carry_in, tile, o,  \
                          sd);
  switch (cut) {
    CSV_ABLATE2_CASE(kCls22)
    CSV_ABLATE2_CASE(kCls18)
    CSV_ABLATE2_CASE(kPrep)
    CSV_ABLATE2_CASE(kMm1)
    CSV_ABLATE2_CASE(kPack1)
    CSV_ABLATE2_CASE(kPack2)
    CSV_ABLATE2_CASE(kPx)
    CSV_ABLATE2_CASE(kLane)
  }
#undef CSV_ABLATE2_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
