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
// The dma_only, classify_only, inword and v3_mmonly outputs depend on 1/8
// of the input, so each cut also writes one side word per tile, the XOR over
// the tile of the value it stores (x, sf | qf, ...): every word is computed,
// as on the TPU, and the side words are checked against the plain version.
//
// What bounds it on an H100: by design HBM bandwidth for every cut (one
// read of the input, a write of 1/8 of it).
//
// What the design does about it. Every cut reads its input once, in B1's
// chunks: 64 KiB, a thread's 16 loads of a chunk issued together, resident
// blocks taking chunks by ticket, the ASCII dialect's SWAR classify. The
// chained cuts (full, v3, v3_mmonly) run on stage1_core.cuh `one_pass`,
// which takes the carry by decoupled look-back; the others on `chunk_loop`,
// the same loop with no status words. The cuts differ only in the stage they
// cut and in how their words leave:
//   - a row of dma_only, classify_only, inword and v3_mmonly depends only on
//     its own input row: the thread that holds it stores it (kEmitRows);
//   - the 8-row sums of noscan and full read one 4 KiB step: a bit transpose
//     of its 8 rows' flags with the top byte negated (`sum8_word`), built by
//     the staged emit (kEmitSum8): the chunk's masks in shared memory as
//     B1's words, one barrier, each thread's whole words stored once;
//   - the folds of v3 and v3_foldonly by the staged emit when T divides 128
//     (a tile's rows in one chunk, kEmitFold), else as B1's words, which
//     relayout.cu `fold_words` then folds in this probe's bit order
//     (kEmitSeq; n/8 bytes of scratch).
// A side word is a warp reduction a step, then at most one global atomicXor
// a chunk and tile (`flush_side`), into words zeroed in the entry point. No
// shared-memory atomics and no shared copy of a tile, so any tile that is a
// multiple of 8 and divides the rows.
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;                       // 4 KiB steps a chunk
constexpr int kStepRows = kStepBytes / 512;      // 8 rows of 512 bytes
constexpr int kChunkRows = kSteps * kStepRows;   // 128
constexpr int kChunkOutRows = kChunkRows / 8;    // 16

enum Cut {
  kCutDma = 0, kCutClassify, kCutInword, kCutNoscan, kCutFull, kCutV3,
  kCutV3Fold, kCutV3Mm, kCuts
};

// How a cut's words leave the kernel (see the header)
enum Emit { kEmitRows = 0, kEmitSum8, kEmitFold, kEmitSeq };

__host__ __device__ constexpr bool chained(int m) {
  return m == kCutFull || m == kCutV3 || m == kCutV3Mm;
}

int emit_of(int mode, int tile) {
  if (mode == kCutNoscan || mode == kCutFull) return kEmitSum8;
  if (mode == kCutV3 || mode == kCutV3Fold)
    return kChunkRows % tile == 0 ? kEmitFold : kEmitSeq;
  return kEmitRows;
}

template <bool kStaged>
struct AblateShared {
  uint32_t stage[kStaged ? kStageWords : 1];  // the staged emit's words
  uint32_t side[kSteps][kWarps];  // each warp's side XOR of each step
  int next[2];                    // chunk_loop's tickets
};

// XOR of the four 0x80-flag words whose flags are the 16-bit mask m
__device__ __forceinline__ uint32_t flag_xor(uint32_t m) {
  return spread4((m ^ (m >> 4) ^ (m >> 8) ^ (m >> 12)) & 0xFu) << 7;
}

// After a __syncthreads: warp 0 joins each step's warp words, then the
// steps of each tile (tiles are whole steps, so a step lies in one) by a
// segmented XOR scan across lanes, and the chunk's last step of each tile
// XORs its tile's part into side: at most one atomicXor a chunk and tile.
__device__ __forceinline__ void flush_side(
    const uint32_t (&s)[kSteps][kWarps], int chunk, long long rows, int tile,
    uint32_t* __restrict__ side) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const long long row = (long long)chunk * kChunkRows + lane * kStepRows;
  const bool live = lane < kSteps && row < rows;
  uint32_t x = 0;
  int t = -1 - lane;  // distinct, so lanes that are not live join nothing
  if (live) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x ^= s[lane][w];
    t = (int)(row / tile);
  }
#pragma unroll
  for (int d = 1; d < kSteps; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    const int ty = __shfl_up_sync(kFull, t, d);
    if (lane >= d && ty == t) x ^= y;
  }
  const int t_next = __shfl_down_sync(kFull, t, 1);
  if (live && t_next != t) atomicXor(side + t, x);
}

// One launch of cut kMode with emit kEmit; g as one_pass takes it (for the
// unchained cuts only its carry-in and n_chunks), ticket the unchained
// loop's counter.
template <int kMode, int kEmit>
__global__ void __launch_bounds__(kThreads, 2)
ablate_pass(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
            OnePass g, int* __restrict__ ticket, int tile,
            uint32_t* __restrict__ out, uint32_t* __restrict__ side) {
  constexpr bool kStaged = kEmit == kEmitSum8 || kEmit == kEmitFold;
  __shared__ OnePassShared sh;
  __shared__ AblateShared<kStaged> as;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long rows = n_bytes / 512;
  const int q = tile / 8;
  // the unchained cuts add the carry-in bit to every word
  const uint32_t add =
      chained(kMode)
          ? 0u
          : (uint32_t)(g.carry_ptr ? *g.carry_ptr : g.carry_in) & 1u;

  // Chunk `chunk` from step_of(k, m, val, sx), which gives the thread's
  // 16-bit mask m of step k (staged and kEmitSeq) or its four values val
  // (kEmitRows), and sx, the XOR of its four values.
  auto emit_chunk = [&](int chunk, auto&& step_of) {
    const long long row0 = (long long)chunk * kChunkRows;
    unsigned ti = (unsigned)(row0 / tile);  // the step's tile
    unsigned st = (unsigned)(row0 - (long long)ti * tile);  // its row there
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      uint32_t m = 0, sx = 0;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      step_of(k, m, val, sx);
      const long long row = row0 + k * kStepRows + warp;
      const bool live = row < rows;  // the same for the whole step
      sx = __reduce_xor_sync(kFull, sx);
      if (lane == 0) as.side[k][warp] = live ? sx : 0u;
      if constexpr (kStaged) {
        stage_mask(as.stage, k, m);
      } else if constexpr (kEmit == kEmitSeq) {
        const uint32_t upper = __shfl_xor_sync(kFull, m, 1);
        if (live && !(lane & 1))
          out[row * 16 + (lane >> 1)] = m | (upper << 16);
      } else {
        const unsigned r = st + warp;
        if (live && r < (unsigned)q)
          reinterpret_cast<uint4*>(out)[((long long)ti * q + r) * 32 + lane] =
              make_uint4(val.x + add, val.y + add, val.z + add, val.w + add);
      }
      st += kStepRows;
      if (st == (unsigned)tile) {
        st = 0;
        ++ti;
      }
    }
    __syncthreads();
    if constexpr (kStaged) {
      uint32_t acc[8];
      if constexpr (kEmit == kEmitSum8) {
        staged_words<kOrderRow>(as.stage, 1, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = sum8_word(acc[i]) + add;
      } else {
        staged_words<kOrderBitrev>(as.stage, q, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += add;
      }
      const long long o =
          (long long)chunk * kChunkOutRows + (threadIdx.x >> 4);
      if (o < rows / 8) store_words8(out, o, threadIdx.x & 15, acc);
    }
    flush_side(as.side, chunk, rows, tile, side);
  };

  if constexpr (chained(kMode)) {
    one_pass<kSteps, true>(in, n_bytes, c, g, sh, [&](
        int chunk, const ChunkMasks<kSteps>& cm) {
      emit_chunk(chunk, [&](int k, uint32_t& m, uint4& val, uint32_t& sx) {
        if constexpr (kMode == kCutV3Mm) {
          // base of word i: the parity before the step, then the quotes of
          // the thread's bytes before 4i
          const uint32_t b = (cm.before >> k) & 1u, p = cm.ps[k];
          val = make_uint4(b, b ^ ((p >> 3) & 1u), b ^ ((p >> 7) & 1u),
                           b ^ ((p >> 11) & 1u));
          sx = val.x ^ val.y ^ val.z ^ val.w;
        } else {
          m = cm.mask(k);
          sx = flag_xor(m);
        }
      });
    });
  } else {
    chunk_loop<kSteps>(in, n_bytes, g.n_chunks, ticket, as.next, [&](
        int chunk, const uint4 (&v)[kSteps]) {
      emit_chunk(chunk, [&](int k, uint32_t& m, uint4& val, uint32_t& sx) {
        const uint32_t x[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kMode == kCutDma) {
            o[i] = x[i];
          } else {
            uint32_t qf, sf;
            swar_flags4(x[i], c, qf, sf);
            const uint32_t p = qf ^ (qf << 8), p_in = p ^ (p << 16);
            if constexpr (kMode == kCutClassify) o[i] = sf | qf;
            else if constexpr (kMode == kCutInword)
              o[i] = (sf & ~p_in) + (p_in >> 31);
            else o[i] = sf & ~p_in;  // noscan, v3_foldonly
          }
        }
        sx = o[0] ^ o[1] ^ o[2] ^ o[3];
        if constexpr (kEmit == kEmitRows)
          val = make_uint4(o[0], o[1], o[2], o[3]);
        else
          m = nibble(o[0]) | (nibble(o[1]) << 4) | (nibble(o[2]) << 8) |
              (nibble(o[3]) << 12);
      });
    });
  }
}

template <int kMode, int kEmit>
cudaError_t launch(cudaStream_t st, const uint4* in, long long n_bytes,
                   const ByteClasses& c, const OnePass& g, int* ticket,
                   int tile, uint32_t* out, uint32_t* side) {
  unsigned grid = 0;
  cudaError_t err =
      one_pass_grid(ablate_pass<kMode, kEmit>, g.n_chunks, grid);
  if (err != cudaSuccess) return err;
  ablate_pass<kMode, kEmit><<<grid, kThreads, 0, st>>>(in, n_bytes, c, g,
                                                       ticket, tile, out,
                                                       side);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of 64 KiB chunks (status words) for rows rows.
long long csv_probe_ablate_chunks(long long rows) {
  return (rows + kChunkRows - 1) / kChunkRows;
}

// 1 iff mode at tile writes B1's words of its fold's flags, which the
// caller then folds with csv_fold_words in order 1 (v3, and v3_foldonly
// adding the carry-in): the folds at tiles that do not divide 128.
int csv_probe_ablate_relayout(int mode, int tile) {
  return tile > 0 && emit_of(mode, tile) == kEmitSeq;
}

// in: (rows, 128) int32, rows a positive multiple of tile, tile a positive
// multiple of 8. mode: 0 dma_only, 1 classify_only, 2 inword, 3 noscan, 4
// full, 5 v3 (and v3i8), 6 v3_foldonly, 7 v3_mmonly. out: rows * 16 ints,
// as (rows/8, 128), or B1's words (rows, 16) when
// csv_probe_ablate_relayout(mode, tile). side: rows / tile words, zeroed
// here. chunk_scratch: csv_probe_ablate_chunks(rows) + 1 ints (status words
// and ticket, zeroed here); scalars: 2 ints (the chained modes' parity out,
// -1). carry_ptr: a device int whose bit 0 is the carry-in, or null to take
// carry_in. Returns cudaGetLastError() after the launch.
int csv_probe_ablate(int mode, const void* in, long long rows, int tile,
                     const void* carry_ptr, int carry_in, void* out,
                     void* side, void* chunk_scratch, void* scalars,
                     void* stream) {
  if (rows <= 0 || tile <= 0 || tile % 8 != 0 || rows % tile != 0 ||
      mode < 0 || mode >= kCuts)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_probe_ablate_chunks(rows);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {0x2C, 0x0A, 0x0D, 0x2C, 0x2C};
  const ByteClasses c = make_classes(0x22, structural);
  const long long n_bytes = rows * 512;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(side, 0, (size_t)(rows / tile) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  OnePass g{};
  g.carry_ptr = static_cast<const int*>(carry_ptr);
  g.carry_in = carry_in;
  g.scalars = static_cast<int*>(scalars);
  int* ticket = nullptr;
  if (chained(mode)) {
    err = reset_one_pass(g, chunk_scratch, n_chunks, st);
  } else {
    g.n_chunks = (int)n_chunks;
    ticket = static_cast<int*>(chunk_scratch);
    err = cudaMemsetAsync(ticket, 0, sizeof(int), st);
  }
  if (err != cudaSuccess) return (int)err;
  const uint4* in4 = static_cast<const uint4*>(in);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* sd = static_cast<uint32_t*>(side);
  const int emit = emit_of(mode, tile);
#define CSV_ABLATE_CASE(M, E)                                               \
  if (mode == M && emit == E)                                               \
    return (int)launch<M, E>(st, in4, n_bytes, c, g, ticket, tile, o, sd);
  CSV_ABLATE_CASE(kCutDma, kEmitRows)
  CSV_ABLATE_CASE(kCutClassify, kEmitRows)
  CSV_ABLATE_CASE(kCutInword, kEmitRows)
  CSV_ABLATE_CASE(kCutNoscan, kEmitSum8)
  CSV_ABLATE_CASE(kCutFull, kEmitSum8)
  CSV_ABLATE_CASE(kCutV3, kEmitFold)
  CSV_ABLATE_CASE(kCutV3, kEmitSeq)
  CSV_ABLATE_CASE(kCutV3Fold, kEmitFold)
  CSV_ABLATE_CASE(kCutV3Fold, kEmitSeq)
  CSV_ABLATE_CASE(kCutV3Mm, kEmitRows)
#undef CSV_ABLATE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
