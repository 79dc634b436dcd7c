// The direct fold pack for Hopper (sm_90a): kernel B3's fold-layout words,
// each written once by the thread that builds it, in the pass that reads
// the input.
//
// Replaces tools/vnext.py `make` (pallas_call line 85) with `directpack`
// (and `both`, which adds the int8 accumulation that changes nothing here):
// candidates over B3 (stage1_v3.py `_stage1_v3_kernel`) on (rows, 128)
// int32 with the default dialect hard-coded (quote 0x22; delimiter 0x2C,
// newlines 0x0A and 0x0D). `directpack` packed each tile with one shift-OR
// of its 8 row segments in place of the three-step fold; the layout is B3's,
// since sigma(j) = 7 - bitrev3(j): bit 8b + sigma(j) of word (s*T/8 + g,
// lane) covers byte b of input word (s*T + j*T/8 + g, lane), T the tile. It
// also returns the quote parity out. The TPU's `base` and `i8acc` are B3.
//
// What bounds it on an H100: HBM bandwidth (read N, write N/8).
//
// What the design does about it. A fold word takes a nibble from 8 rows
// T/8 apart. When T divides 128, the 8 rows of every word lie in one 64 KiB
// chunk of B1's one pass (stage1_core.cuh `one_pass`: the input read once,
// the carry by decoupled look-back), so `vnext_pack` is that pass with the
// staged emit in place of B1's stores: each thread's masks of the chunk go
// to shared memory as B1's words (8 KiB), and after one barrier each thread
// builds the 8 words of one output row's lane group (`staged_words`, the
// nibble transpose of relayout.cu `fold_words`) and stores them once. No
// atomics, no carry pass. At other tiles a word's rows span chunks taken by
// different blocks, and the wrapper runs B3's pair instead: B1's one pass,
// then `fold_words`, which costs a round trip of N/8 bytes more.
#include "stage1_core.cuh"

namespace {

constexpr int kSteps = 16;         // 4 KiB steps a 64 KiB chunk
constexpr int kChunkRows = 128;    // rows of 512 bytes a chunk
constexpr int kChunkOutRows = 16;  // fold rows a chunk

// B1's one pass with the staged emit of B3's fold at tile 8q, q | 16
__global__ void __launch_bounds__(kThreads, 2)
vnext_pack(const uint4* __restrict__ in, long long n_bytes, ByteClasses c,
           OnePass g, int q, uint32_t* __restrict__ out) {
  __shared__ OnePassShared sh;
  __shared__ uint32_t stage[kStageWords];
  const long long out_rows = n_bytes / 512 / 8;
  one_pass<kSteps, true>(in, n_bytes, c, g, sh, [&](
      int chunk, const ChunkMasks<kSteps>& cm) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) stage_mask(stage, k, cm.mask(k));
    __syncthreads();
    uint32_t acc[8];
    staged_words<kOrderFold>(stage, q, acc);
    const long long o = (long long)chunk * kChunkOutRows + (threadIdx.x >> 4);
    if (o < out_rows) store_words8(out, o, threadIdx.x & 15, acc);
  });
}

}  // namespace

extern "C" {

// 1 iff the direct pack takes tile (rows): a positive multiple of 8 that
// divides 128, so that every fold word's rows lie in one chunk.
int csv_probe_vnext_direct(int tile) {
  return tile > 0 && tile % 8 == 0 && kChunkRows % tile == 0;
}

// Number of 64 KiB chunks (status words) for rows rows.
long long csv_probe_vnext_chunks(long long rows) {
  return (rows + kChunkRows - 1) / kChunkRows;
}

// in: (rows, 128) int32, rows a positive multiple of tile, tile with
// csv_probe_vnext_direct(tile). out: rows * 16 ints, as (rows / 8, 128) in
// B3's fold layout. chunk_scratch: csv_probe_vnext_chunks(rows) + 1 ints
// (status words and ticket, zeroed here); scalars: 2 ints (parity out, -1).
// carry_ptr: a device int whose bit 0 is the carry-in, or null to take
// carry_in. Returns cudaGetLastError() after the launch.
int csv_probe_vnext(const void* in, long long rows, int tile,
                    const void* carry_ptr, int carry_in, void* out,
                    void* chunk_scratch, void* scalars, void* stream) {
  if (rows <= 0 || !csv_probe_vnext_direct(tile) || rows % tile != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_probe_vnext_chunks(rows);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {0x2C, 0x0A, 0x0D, 0x2C, 0x2C};
  const ByteClasses c = make_classes(0x22, structural);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  OnePass g{};
  g.carry_ptr = static_cast<const int*>(carry_ptr);
  g.carry_in = carry_in;
  g.scalars = static_cast<int*>(scalars);
  unsigned grid = 0;
  cudaError_t err = reset_one_pass(g, chunk_scratch, n_chunks, st);
  if (err == cudaSuccess) err = one_pass_grid(vnext_pack, n_chunks, grid);
  if (err != cudaSuccess) return (int)err;
  vnext_pack<<<grid, kThreads, 0, st>>>(static_cast<const uint4*>(in),
                                        rows * 512, c, g, tile / 8,
                                        static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
