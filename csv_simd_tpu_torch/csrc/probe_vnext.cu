// The atomic-free fold pack for Hopper (sm_90a): kernel B3's fold-layout
// words, each written once by the thread that builds it.
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
// What bounds it on an H100: HBM bandwidth (read N twice, write N/8).
//
// What the design does about it. The two-pass B3 that this probe was
// measured against walked its rows in order and ORed each thread's nibbles
// into a shared copy of its tiles' words with shared atomics, since one
// word takes a nibble from 8 rows T/8 apart (B3 is now B1's one pass and
// relayout.cu `fold_words`). Here each word is built whole by one thread,
// so a thread needs the quote parity before each of its 8 scattered rows:
//   pass A  `row_parity`: a warp a row, the quote parity of every row into a
//           byte array (N/512 bytes) and of each block's rows;
//   scan    stage1_core.cuh `chunk_carry_scan`: each block's carry-in and the
//           parity out;
//   pass B  `fold_direct`: a block owns whole tiles (at least 128 rows), scans
//           its row parities in shared memory (one __ballot_sync a warp of
//           rows), then warp w builds output rows w, w + 8, ...: for each of
//           the 8 rows j*T/8 + g of its output row g a lane loads 16 bytes
//           (the 8 loads are independent and issue together), masks them with
//           the row's parity and its in-row prefix from __ballot_sync, and
//           ORs the nibbles at bit sigma(j); the lane stores its 4 words as
//           one 16-byte store. No atomics, no shared copy of the words.
#include "stage1_core.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kMaxBlockRows = 4096;

// rows a block owns: whole tiles, at least 128 rows (64 KiB) when the tile
// is small (B3's blocks)
long long rows_per_block(int tile) {
  const int tiles = tile < 128 ? 128 / tile : 1;
  return (long long)tiles * tile;
}

__global__ void __launch_bounds__(kThreads)
row_parity(const uint4* __restrict__ in, long long rows, int block_rows,
           ByteClasses c, uint8_t* __restrict__ rowpar,
           int* __restrict__ chunk_par) {
  __shared__ uint32_t s_par[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * block_rows;
  const int n = (int)min((long long)block_rows, rows - row0);
  uint32_t acc = 0;
#pragma unroll 4
  for (int r = warp; r < n; r += kWarps) {
    const uint4 v = in[(row0 + r) * 32 + lane];
    const uint32_t bal = __ballot_sync(kFull, __popc(quote16(v, c)) & 1u);
    const uint32_t p = __popc(bal) & 1u;
    if (lane == 0) rowpar[row0 + r] = (uint8_t)p;
    acc ^= p;
  }
  if (lane == 0) s_par[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t par = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) par ^= s_par[i];
    chunk_par[blockIdx.x] = (int)par;
  }
}

__global__ void __launch_bounds__(kThreads)
fold_direct(const uint4* __restrict__ in, long long rows, int tile,
            int block_rows, ByteClasses c, const uint8_t* __restrict__ rowpar,
            const int* __restrict__ chunk_carry, uint32_t* __restrict__ out) {
  __shared__ uint8_t s_before[kMaxBlockRows];  // parity before each row
  __shared__ uint32_t s_wp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * block_rows;
  const int n = (int)min((long long)block_rows, rows - row0);
  uint32_t run = (uint32_t)chunk_carry[blockIdx.x] & 1u;
  for (int r0 = 0; r0 < n; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const uint32_t p = r < n ? rowpar[row0 + r] : 0u;
    const uint32_t bal = __ballot_sync(kFull, p);
    const uint32_t lane_excl = __popc(bal & ((1u << lane) - 1u)) & 1u;
    if (lane == 0) s_wp[warp] = __popc(bal) & 1u;
    __syncthreads();
    uint32_t warp_excl = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const uint32_t w = s_wp[i];
      warp_excl ^= (i < warp) ? w : 0u;
      total ^= w;
    }
    if (r < n) s_before[r] = (uint8_t)(run ^ warp_excl ^ lane_excl);
    run ^= total;
    __syncthreads();  // s_wp is rewritten next round; s_before is complete
  }
  const int q = tile / 8;
  const uint32_t lanes_below = (1u << lane) - 1u;
  for (int orow = warp; orow < n / 8; orow += kWarps) {
    const int ti = orow / q, g = orow - ti * q;
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = in[(row0 + ti * tile + j * q + g) * 32 + lane];
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t qm = quote16(v[j], c), s = structural16(v[j], c);
      uint32_t p = qm;
      p ^= p << 1;
      p ^= p << 2;
      p ^= p << 4;
      p ^= p << 8;
      const uint32_t bal = __ballot_sync(kFull, __popc(qm) & 1u);
      const uint32_t before =
          s_before[ti * tile + j * q + g] ^ (__popc(bal & lanes_below) & 1u);
      const uint32_t m = s & ~(p ^ (0u - before)) & 0xffffu;
      const int sig = fold_sigma(j);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] |= spread4((m >> (4 * k)) & 0xFu) << sig;
    }
    reinterpret_cast<uint4*>(out)[(row0 / 8 + orow) * (kLanes / 4) + lane] =
        make_uint4(acc[0], acc[1], acc[2], acc[3]);
  }
}

}  // namespace

extern "C" {

// The largest tile (rows) the kernel takes: its block's row parities must
// fit in shared memory.
int csv_probe_vnext_max_tile() { return kMaxBlockRows; }

// Number of blocks (and chunk-scratch pairs) for rows rows at tile.
long long csv_probe_vnext_chunks(long long rows, int tile) {
  const long long r = rows_per_block(tile);
  return (rows + r - 1) / r;
}

// in: (rows, 128) int32, rows a positive multiple of tile, tile a multiple
// of 8 up to csv_probe_vnext_max_tile(). out: rows * 16 ints, as (rows / 8,
// 128) in B3's fold layout. rowpar: rows bytes of scratch. chunk_scratch: 2 *
// csv_probe_vnext_chunks ints; scalars: 2 ints (parity out, -1). carry_ptr: a
// device int whose bit 0 is the carry-in, or null to take carry_in. Returns
// cudaGetLastError() after the launches.
int csv_probe_vnext(const void* in, long long rows, int tile,
                    const void* carry_ptr, int carry_in, void* out,
                    void* rowpar, void* chunk_scratch, void* scalars,
                    void* stream) {
  if (rows <= 0 || tile <= 0 || tile % 8 != 0 || rows % tile != 0 ||
      tile > kMaxBlockRows)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = csv_probe_vnext_chunks(rows, tile);
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int structural[kMaxStructural] = {0x2C, 0x0A, 0x0D, 0x2C, 0x2C};
  const ByteClasses c = make_classes(0x22, structural);
  const int block_rows = (int)rows_per_block(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* chunk_par = static_cast<int*>(chunk_scratch);
  int* chunk_carry = chunk_par + n_chunks;
  const uint4* in4 = static_cast<const uint4*>(in);
  uint8_t* rp = static_cast<uint8_t*>(rowpar);
  row_parity<<<(unsigned)n_chunks, kThreads, 0, st>>>(in4, rows, block_rows, c,
                                                       rp, chunk_par);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carry_scan<<<1, csv_scan::kThreads, 0, st>>>(
      chunk_par, chunk_carry, (int)n_chunks,
      static_cast<const int*>(carry_ptr), carry_in, 0, nullptr,
      static_cast<int*>(scalars));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fold_direct<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      in4, rows, tile, block_rows, c, rp, chunk_carry,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
