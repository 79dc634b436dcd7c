// The classify-and-carry core shared by every stage-1 kernel (B1 in
// stage1_v4.cu, and through it B3 and B6 with relayout.cu; B5 in
// stage1_pack.cu) and by the stage-1 probes (probe_ablate.cu,
// probe_ablate2.cu, probe_kbench.cu, probe_vnext.cu).
//
// All of them compute one mask over the input's flat byte stream: a byte is
// kept iff it is a delimiter or newline outside quotes, where in-quote is the
// inclusive prefix XOR of the quote bytes XOR the carry-in. They differ only
// in how the kept bits are packed into words.
//
// The TPU kernels carried the quote parity through SMEM because their grid
// runs in order; blocks here run in parallel, so the carry crosses blocks by
// decoupled look-back. A step is 256 threads x 16 bytes: loads are one uint4
// a thread, neighbours on neighbouring addresses.
//
// One pass (B1; B3 and B6 as B1 followed by a relayout of its words; B5; the
// v4full cut of probe_ablate2.cu, the chained cuts of probe_ablate.cu and
// the direct fold pack of probe_vnext.cu): `one_pass` reads
// each chunk of whole steps once, all of a thread's loads issued together,
// and keeps each step's quote prefix and structural bits in registers. Each
// warp's step parities make one word of shared memory, so one barrier gives
// every thread its parity before each of its steps within the chunk. The
// carry into the chunk comes by decoupled look-back (Merrill and Garland's
// single-pass scan, on one bit): a block takes chunks from an atomic ticket
// and publishes each chunk's parity as a status word (`OnePass`). Blocks
// stay resident and work two chunks deep, so that a chunk's carry is taken
// a round after its own parity, from a window of its predecessors' words
// read while the next chunk is classified. The classify is the
// shared-subexpression SWAR form for an ASCII dialect and __vcmpeq4
// otherwise (`classify16`). `chunk_loop` takes the same chunks with the same
// grid and loads and no carry (the unchained cuts of probe_ablate.cu).
//
// A layout whose words depend only on rows of one 64 KiB chunk is written
// from the emit of either loop by the staged emit (`stage_mask`,
// `staged_words`): the chunk's masks go to shared memory as B1's words,
// and after one barrier each thread builds whole output words and stores
// them once (B5's v2 words, the fold at tile 8 in row order, among them).
// A layout whose words span chunks is B1's words followed by a relayout
// (relayout.cu). Both build their words with `transpose_nibbles`. No kernel
// reads its input twice.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStepBytes = kThreads * 16;  // 4 KiB per block step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxStructural = 5;  // the delimiter and up to four newlines

struct ByteClasses {
  uint32_t quote;                  // the quote byte in all four byte lanes
  uint32_t structural[kMaxStructural];
};

// __vcmpeq4 result (0xff per equal byte) -> 4-bit mask, byte k -> bit k.
// The multiplier 0x00204081 (bits 0, 7, 14, 21) moves flag bits 7/15/23/31
// to 28..31; every other product lands on its own bit below 28, so no carry
// reaches them.
__device__ __forceinline__ uint32_t nibble(uint32_t cmp) {
  return ((cmp & 0x80808080u) * 0x00204081u) >> 28;
}

// bit b of a 4-bit nibble -> bit 8b (the four shifted copies of the
// multiply do not overlap, so no carry crosses a bit)
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// The fold layout's row order: sigma(j) = [7,3,5,1,6,2,4,0][j], one nibble
// each (sigma(j) = 7 - bitrev3(j))
__device__ __forceinline__ int fold_sigma(int j) {
  return (0x04261537 >> (4 * j)) & 0xF;
}

__device__ __forceinline__ uint32_t quote16(const uint4 v, const ByteClasses& c) {
  return nibble(__vcmpeq4(v.x, c.quote)) |
         (nibble(__vcmpeq4(v.y, c.quote)) << 4) |
         (nibble(__vcmpeq4(v.z, c.quote)) << 8) |
         (nibble(__vcmpeq4(v.w, c.quote)) << 12);
}

__device__ __forceinline__ uint32_t structural4(uint32_t w, const ByteClasses& c) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < kMaxStructural; ++i) m |= __vcmpeq4(w, c.structural[i]);
  return nibble(m);
}

__device__ __forceinline__ uint32_t structural16(const uint4 v, const ByteClasses& c) {
  return structural4(v.x, c) | (structural4(v.y, c) << 4) |
         (structural4(v.z, c) << 8) | (structural4(v.w, c) << 12);
}

__device__ __forceinline__ uint32_t high_bytes16(const uint4 v) {
  return __popc(v.x & 0x80808080u) + __popc(v.y & 0x80808080u) +
         __popc(v.z & 0x80808080u) + __popc(v.w & 0x80808080u);
}

inline ByteClasses make_classes(int quote, const int* structural) {
  ByteClasses c;
  c.quote = (uint32_t)(quote & 0xff) * 0x01010101u;
  for (int i = 0; i < kMaxStructural; ++i)
    c.structural[i] = (uint32_t)(structural[i] & 0xff) * 0x01010101u;
  return c;
}

// ---- One pass ----

// bit j = XOR of bits 0..j of q, for j < 16 (bits above 15 are not kept)
__device__ __forceinline__ uint32_t prefix_xor16(uint32_t q) {
  q ^= q << 1;
  q ^= q << 2;
  q ^= q << 4;
  q ^= q << 8;
  return q;
}

// The shared-subexpression SWAR classify of one word for a dialect whose
// bytes are all < 0x80: per byte, (low 7 bits ^ target) + 0x7F has bit 7
// clear iff they are equal (no carry leaves a byte), and a byte with bit 7
// set equals no target. 4-bit quote and structural masks, byte k -> bit k.
__device__ __forceinline__ void swar4(uint32_t x, const ByteClasses& c,
                                      uint32_t& q, uint32_t& s) {
  constexpr uint32_t kLow7 = 0x7f7f7f7fu;
  const uint32_t xl = x & kLow7, xh = x & 0x80808080u;
  uint32_t ts = (xl ^ c.structural[0]) + kLow7;
#pragma unroll
  for (int i = 1; i < kMaxStructural; ++i) ts &= (xl ^ c.structural[i]) + kLow7;
  q = nibble(~(((xl ^ c.quote) + kLow7) | xh));
  s = nibble(~(ts | xh));
}

// The same classify as 0x80 flags: qf and sf have bit 8b + 7 set iff byte b
// of x is the quote or a structural byte. (swar4 does not call it: written
// through it, B1's kernel compiled to other instructions on sm_90a.)
__device__ __forceinline__ void swar_flags4(uint32_t x, const ByteClasses& c,
                                            uint32_t& qf, uint32_t& sf) {
  constexpr uint32_t kLow7 = 0x7f7f7f7fu;
  const uint32_t xl = x & kLow7, xh = x & 0x80808080u;
  uint32_t ts = (xl ^ c.structural[0]) + kLow7;
#pragma unroll
  for (int i = 1; i < kMaxStructural; ++i) ts &= (xl ^ c.structural[i]) + kLow7;
  qf = ~(((xl ^ c.quote) + kLow7) | xh) & 0x80808080u;
  sf = ~(ts | xh) & 0x80808080u;
}

// 16-bit quote and structural masks of 16 bytes: SWAR when kAscii (the
// dialect's bytes all < 0x80), __vcmpeq4 otherwise
template <bool kAscii>
__device__ __forceinline__ void classify16(const uint4 v, const ByteClasses& c,
                                           uint32_t& q, uint32_t& s) {
  if constexpr (kAscii) {
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    q = s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t qk, sk;
      swar4(x[k], c, qk, sk);
      q |= qk << (4 * k);
      s |= sk << (4 * k);
    }
  } else {
    q = quote16(v, c);
    s = structural16(v, c);
  }
}

inline bool ascii_classes(int quote, const int* structural) {
  bool ascii = (quote & 0xff) < 0x80;
  for (int i = 0; i < kMaxStructural; ++i)
    ascii = ascii && (structural[i] & 0xff) < 0x80;
  return ascii;
}

// A chunk's status word: 0 until its block publishes; then kAggregate |
// the chunk's own quote parity, and last kInclusive | the parity after the
// chunk (the carry-in included).
constexpr uint32_t kAggregate = 2u, kInclusive = 4u;

// What a one-pass launch shares across its blocks. status (n_chunks words),
// ticket and, when counting, nonascii are zero before the launch
// (`reset_one_pass`); the last chunk's block writes scalars[0], the parity
// out, and scalars[1], the non-ASCII count or -1.
struct OnePass {
  uint32_t* status;
  int* ticket;
  int n_chunks;
  const int* carry_ptr;  // bit 0 is the carry-in; null: carry_in
  int carry_in;
  int count_nonascii;
  unsigned long long* nonascii;
  int* scalars;
};

// status and ticket in chunk_scratch (n_chunks + 1 ints), both zeroed, and
// the non-ASCII counter zeroed when counting, on stream st
inline cudaError_t reset_one_pass(OnePass& g, void* chunk_scratch,
                                  long long n_chunks, cudaStream_t st) {
  g.status = static_cast<uint32_t*>(chunk_scratch);
  g.ticket = reinterpret_cast<int*>(g.status + n_chunks);
  g.n_chunks = (int)n_chunks;
  cudaError_t err = cudaMemsetAsync(chunk_scratch, 0,
                                    (n_chunks + 1) * sizeof(int), st);
  if (err == cudaSuccess && g.count_nonascii)
    err = cudaMemsetAsync(g.nonascii, 0, sizeof(unsigned long long), st);
  return err;
}

// The grid of a one-pass kernel: as many blocks as the card holds at once,
// at most one a chunk (each block loops over chunks by ticket).
template <class Kernel>
inline cudaError_t one_pass_grid(Kernel kernel, long long n_chunks,
                                 unsigned& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  grid = (unsigned)(n_chunks < resident ? n_chunks : resident);
  return cudaSuccess;
}

// status words a thread reads at once: a look-back window of 256 chunks
// (windows of 512 and 1,024 took longer on an H100)
constexpr int kWindowWords = 1;

// A block's shared state, in two buffers that alternate by chunk, so that a
// warp writing the next chunk's words cannot meet one still reading this
// chunk's (a __syncthreads lies between).
struct OnePassShared {
  uint32_t step_par[2][kWarps];  // each warp's step parities, bit k = step k
  unsigned high[2][kWarps];      // each warp's bytes >= 0x80
  uint32_t window[2][kWindowWords * kWarps][3];  // none, inclusive, odd
  int next[2];                   // the chunk after, from the ticket
  uint32_t carry;                // the fallback look-back's carry
};

// One thread's part of a chunk of kNSteps steps, from `one_pass`.
template <int kNSteps>
struct ChunkMasks {
  uint32_t ps[kNSteps];  // low half: in-thread inclusive quote prefix XOR;
                         // high half: structural bits
  uint32_t before;       // bit k: quote parity before the thread's step k
  // the thread's 16-bit mask at step k: bit b is 1 iff byte b of its 16
  // bytes of step k is structural and outside quotes (0 past n_bytes)
  __device__ __forceinline__ uint32_t mask(int k) const {
    const uint32_t in_quote = ps[k] ^ (0u - ((before >> k) & 1u));
    return (ps[k] >> 16) & ~in_quote & 0xffffu;
  }
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The quote parity before chunk `chunk` > 0, for a whole warp: lane l reads
// the status of chunk top - l, the window re-read while any chunk up to the
// nearest inclusive one has not published, then moved 32 chunks down while
// none of it is inclusive. Chunk 0 always publishes an inclusive word.
__device__ __forceinline__ uint32_t look_back(const uint32_t* status,
                                              int chunk) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = 0;
  for (int top = chunk - 1;;) {
    const int idx = top - lane;
    const uint32_t s = idx >= 0 ? ld_acquire(status + idx) : kInclusive;
    const uint32_t none = __ballot_sync(kFull, s == 0u);
    const uint32_t incl = __ballot_sync(kFull, (s & kInclusive) != 0u);
    // lanes 0 .. the nearest inclusive one (all 32 when there is none)
    const uint32_t upto = incl ? incl ^ (incl - 1u) : kFull;
    if (none & upto) {
      __nanosleep(32);
      continue;
    }
    carry ^= __popc(__ballot_sync(kFull, s & 1u) & upto) & 1u;
    if (incl) break;
    top -= 32;
  }
  // lane 0 reads what the other lanes' acquires made visible
  __syncwarp();
  return carry;
}

// v[k] = this thread's 16 bytes of step k of chunk `chunk` (0 past n_bytes)
template <int kNSteps>
__device__ __forceinline__ void load_chunk(uint4 (&v)[kNSteps],
                                           const uint4* __restrict__ in,
                                           long long n_bytes, int chunk) {
  const long long off0 =
      (long long)chunk * kNSteps * kStepBytes + threadIdx.x * 16;
#pragma unroll
  for (int k = 0; k < kNSteps; ++k) {
    const long long off = off0 + (long long)k * kStepBytes;
    v[k] = off < n_bytes ? in[off >> 4] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The thread's part of chunk `chunk` from its loaded bytes: cm.ps, and
// cm.before = the parity before each of its steps from the lanes before it
// in its warp; each warp's step parities (and bytes >= 0x80 when counting)
// into buffer b of sh, for `finish_chunk` after a __syncthreads.
template <int kNSteps, bool kAscii>
__device__ __forceinline__ void classify_chunk(
    const uint4 (&v)[kNSteps], long long n_bytes, int chunk,
    const ByteClasses& c, int count_nonascii, OnePassShared& sh, int b,
    ChunkMasks<kNSteps>& cm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long off0 =
      (long long)chunk * kNSteps * kStepBytes + threadIdx.x * 16;
  uint32_t odd = 0, high = 0;
#pragma unroll
  for (int k = 0; k < kNSteps; ++k) {
    uint32_t q = 0, s = 0;
    if (off0 + (long long)k * kStepBytes < n_bytes)
      classify16<kAscii>(v[k], c, q, s);
    const uint32_t p = prefix_xor16(q);
    cm.ps[k] = (p & 0xffffu) | (s << 16);
    odd |= ((p >> 15) & 1u) << k;
    if (count_nonascii) high += high_bytes16(v[k]);
  }
  // the in-warp exclusive XOR scan of the step parities, all steps at once
  uint32_t incl = odd;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl ^= y;
  }
  cm.before = incl ^ odd;
  if (lane == 31) sh.step_par[b][warp] = incl;
  if (count_nonascii) {
    const unsigned h = __reduce_add_sync(kFull, high);
    if (lane == 0) sh.high[b][warp] = h;
  }
}

// After classify_chunk and a __syncthreads: cm.before gets the parity of
// the chunk's full steps before each step and of the warps before this
// one; returns the chunk's own quote parity.
template <int kNSteps>
__device__ __forceinline__ uint32_t finish_chunk(const OnePassShared& sh,
                                                 int b,
                                                 ChunkMasks<kNSteps>& cm) {
  const int warp = threadIdx.x >> 5;
  uint32_t total = 0, warp_excl = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const uint32_t w = sh.step_par[b][i];
    total ^= w;
    warp_excl ^= i < warp ? w : 0u;
  }
  cm.before ^= (prefix_xor16(total) << 1) ^ warp_excl;
  return __popc(total) & 1u;
}

// Thread 0 adds the chunk's bytes >= 0x80 to the count, then publishes the
// chunk's status: its aggregate, or for chunk 0 its inclusive parity.
__device__ __forceinline__ void publish_aggregate(const OnePass& g,
                                                  const OnePassShared& sh,
                                                  int b, int chunk,
                                                  uint32_t par,
                                                  uint32_t carry0) {
  if (threadIdx.x != 0) return;
  if (g.count_nonascii) {
    unsigned long long h = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) h += sh.high[b][i];
    if (h) atomicAdd(g.nonascii, h);
  }
  st_release(g.status + chunk,
             chunk == 0 ? kInclusive | (carry0 ^ par) : kAggregate | par);
}

// The status words of chunks chunk - 1 - threadIdx.x - 256 w, w <
// kWindowWords (inclusive with parity 0 below chunk 0), by acquire loads.
__device__ __forceinline__ void read_window(const uint32_t* status, int chunk,
                                            uint32_t (&s)[kWindowWords]) {
#pragma unroll
  for (int w = 0; w < kWindowWords; ++w) {
    const int idx = chunk - 1 - (int)threadIdx.x - kThreads * w;
    s[w] = idx >= 0 ? ld_acquire(status + idx) : kInclusive;
  }
}

// Each warp's window words as three ballots (unpublished, inclusive, odd)
// into buffer b of sh, nearest chunk first.
__device__ __forceinline__ void ballot_window(
    const uint32_t (&s)[kWindowWords], OnePassShared& sh, int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < kWindowWords; ++w) {
    const uint32_t none = __ballot_sync(kFull, s[w] == 0u);
    const uint32_t incl = __ballot_sync(kFull, (s[w] & kInclusive) != 0u);
    const uint32_t odd = __ballot_sync(kFull, s[w] & 1u);
    if (lane == 0) {
      uint32_t* out = sh.window[b][w * kWarps + warp];
      out[0] = none;
      out[1] = incl;
      out[2] = odd;
    }
  }
}

// The carry into the window's chunk from its ballots, nearest chunk first:
// the parities up to and including the nearest inclusive word. False when a
// chunk before that has not published, or no word of the window is
// inclusive; then `look_back` walks the statuses instead.
__device__ __forceinline__ bool window_carry(const OnePassShared& sh, int b,
                                             uint32_t& carry) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kWindowWords * kWarps; ++j) {
    const uint32_t* w = sh.window[b][j];
    const uint32_t upto = w[1] ? w[1] ^ (w[1] - 1u) : kFull;
    if (w[0] & upto) return false;
    acc ^= __popc(w[2] & upto);
    if (w[1]) {
      carry = acc & 1u;
      return true;
    }
  }
  return false;
}

// One pass over the input in chunks of kNSteps 4 KiB steps. The block takes
// chunks from g.ticket until none is left and calls emit(chunk, cm) on
// each, every thread with its ChunkMasks: mask(k) covers bytes chunk *
// kNSteps * 4 KiB + k * 4 KiB + 16 * threadIdx.x .. + 15 (0 past n_bytes).
// Every thread of the block calls it.
//
// A block works two chunks deep. In each round it classifies chunk n + 1
// (loaded the round before), then resolves the carry into chunk n,
// publishes chunk n's inclusive status and chunk n + 1's aggregate, and
// emits chunk n; chunk n + 2's loads go out before the emit. Chunk n's
// predecessors have published a round earlier, so its carry comes from a
// window of 256 status words whose acquire loads were issued before the
// classify: one __syncthreads a round, and no waiting.
// When the window does not resolve, warp 0 walks the statuses
// (`look_back`) behind a second __syncthreads. The non-ASCII count goes
// into g.nonascii before a chunk's first publish, so the last chunk, whose
// carry has seen every chunk before it, reads the whole count. A block
// waits only on chunks before the one it resolves, and every chunk it holds
// is later: the earliest unfinished chunk always runs, so no deadlock.
template <int kNSteps, bool kAscii, class Emit>
__device__ __forceinline__ void one_pass(const uint4* __restrict__ in,
                                         long long n_bytes,
                                         const ByteClasses& c,
                                         const OnePass& g, OnePassShared& sh,
                                         Emit emit) {
  static_assert(kNSteps <= 16, "a warp's step parities are one 16-bit word");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t carry0 =
      (uint32_t)(g.carry_ptr ? *g.carry_ptr : g.carry_in) & 1u;
  if (threadIdx.x == 0) sh.next[0] = atomicAdd(g.ticket, 1);
  __syncthreads();
  int cur = sh.next[0];
  if (cur >= g.n_chunks) return;
  uint4 v[kNSteps];
  load_chunk(v, in, n_bytes, cur);
  int b = 1;
  ChunkMasks<kNSteps> cm;
  int ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(g.ticket, 1);
  classify_chunk<kNSteps, kAscii>(v, n_bytes, cur, c, g.count_nonascii, sh,
                                  b, cm);
  if (threadIdx.x == 0) sh.next[b] = ticket;
  __syncthreads();
  uint32_t par = finish_chunk(sh, b, cm);
  int nxt = sh.next[b];
  publish_aggregate(g, sh, b, cur, par, carry0);
  if (nxt < g.n_chunks) load_chunk(v, in, n_bytes, nxt);
  while (true) {
    b ^= 1;
    const bool has_next = nxt < g.n_chunks;
    uint32_t s[kWindowWords];
    read_window(g.status, cur, s);
    ChunkMasks<kNSteps> cn;
    if (has_next) {
      if (threadIdx.x == 0) ticket = atomicAdd(g.ticket, 1);
      classify_chunk<kNSteps, kAscii>(v, n_bytes, nxt, c, g.count_nonascii,
                                      sh, b, cn);
      if (threadIdx.x == 0) sh.next[b] = ticket;
    }
    ballot_window(s, sh, b);
    __syncthreads();
    uint32_t carry = carry0;
    if (cur > 0 && !window_carry(sh, b, carry)) {
      if (warp == 0) {
        const uint32_t walked = look_back(g.status, cur);
        if (lane == 0) sh.carry = walked;
      }
      __syncthreads();
      carry = sh.carry;
    }
    if (threadIdx.x == 0) {
      st_release(g.status + cur, kInclusive | (carry ^ par));
      if (cur == g.n_chunks - 1) {
        g.scalars[0] = (int)(carry ^ par);
        g.scalars[1] =
            g.count_nonascii ? (int)atomicAdd(g.nonascii, 0ull) : -1;
      }
    }
    int after = g.n_chunks;
    uint32_t par_next = 0;
    if (has_next) {
      par_next = finish_chunk(sh, b, cn);
      after = sh.next[b];
      publish_aggregate(g, sh, b, nxt, par_next, carry0);
      if (after < g.n_chunks) load_chunk(v, in, n_bytes, after);
    }
    cm.before ^= 0u - carry;
    emit(cur, cm);
    if (!has_next) return;
    cm = cn;
    par = par_next;
    cur = nxt;
    nxt = after;
  }
}

// ---- Chunks without a carry ----

// The unchained cuts' loop: one_pass's chunks, grid and loads without its
// status words. The block takes chunks of kNSteps steps from *ticket (zero
// before the launch) until none is left, issues all of a thread's loads of
// a chunk together (v[k] = its 16 bytes of step k, 0 past n_bytes) and calls
// fn(chunk, v), every thread of the block; a __syncthreads lies between two
// calls. s_next is the block's two ticket words in shared memory.
template <int kNSteps, class Fn>
__device__ __forceinline__ void chunk_loop(const uint4* __restrict__ in,
                                           long long n_bytes, int n_chunks,
                                           int* ticket, int (&s_next)[2],
                                           Fn fn) {
  if (threadIdx.x == 0) s_next[0] = atomicAdd(ticket, 1);
  __syncthreads();
  int cur = s_next[0], b = 0;
  uint4 v[kNSteps];
  while (cur < n_chunks) {
    load_chunk(v, in, n_bytes, cur);
    b ^= 1;
    if (threadIdx.x == 0) s_next[b] = atomicAdd(ticket, 1);
    fn(cur, v);
    __syncthreads();
    cur = s_next[b];
  }
}

// ---- Bit permutations of B1's words ----

// The bit orders of the nibble transpose: B3's fold, sigma(j); the
// ablation probe's fold, bitrev3(j) = 7 - sigma(j) (each byte of B3's word
// bit-reversed); and row order, j (the probe's 8-row sums)
enum NibbleOrder { kOrderFold = 0, kOrderBitrev = 1, kOrderRow = 2 };

template <int kOrder>
__device__ __forceinline__ int order_bit(int j) {
  if constexpr (kOrder == kOrderFold) return fold_sigma(j);
  else if constexpr (kOrder == kOrderBitrev) return 7 - fold_sigma(j);
  else return j;
}

// One thread's 8 x 8 nibble transpose: w[j] is B1's word of lanes 8c..8c+7
// of row j of 8 rows (bit 4i + b: byte b of lane 8c + i), acc[i] the output
// word of lane 8c + i, whose bit 8b + order_bit(j) is bit 4i + b of w[j].
template <int kOrder>
__device__ __forceinline__ void transpose_nibbles(const uint32_t (&w)[8],
                                                  uint32_t (&acc)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t a = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      a |= spread4((w[j] >> (4 * i)) & 0xFu) << order_bit<kOrder>(j);
    acc[i] = a;
  }
}

// The ablation probe's 8-row wrapping sum, sum over k < 8 of
// (int32)flags[k] >> (7 - k) for 0x80-flag words, from their row-order
// transpose a (bit 8b + k: byte b's flag of row k). Bytes 0-2 shift onto
// bits of their own with no carry; byte 3's flag, sign-extended, adds
// -2^(24 + k), so the sum is a with its top byte negated.
__device__ __forceinline__ uint32_t sum8_word(uint32_t a) {
  return (a & 0x00FFFFFFu) | ((0u - (a >> 24)) << 24);
}

// ---- The staged emit ----

// words of a 64 KiB chunk's stage: its 16 steps' masks, 8 KiB
constexpr int kStageWords = 16 * kThreads / 2;

// The thread's 16-bit mask of step k into the stage, which so holds the
// chunk as B1's words: row r (of 512 bytes), lanes 8c..8c+7 is word 16r + c.
__device__ __forceinline__ void stage_mask(uint32_t* stage, int k,
                                           uint32_t m) {
  reinterpret_cast<uint16_t*>(stage)[k * kThreads + threadIdx.x] =
      (uint16_t)m;
}

// After stage_mask of all 16 steps and a __syncthreads: the 8 words of
// lanes 8c..8c+7 (c = threadIdx.x % 16) of the chunk's output row u =
// threadIdx.x / 16 (of its 16), in order kOrder. Output row u of a fold
// tile of 8q rows (q divides 16) takes as its row j the chunk's row
// (u / q) * 8q + j * q + u % q; q = 1 gives rows 8u .. 8u + 7.
template <int kOrder>
__device__ __forceinline__ void staged_words(const uint32_t* stage, int q,
                                             uint32_t (&acc)[8]) {
  const int u = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int r0 = (u / q) * 8 * q + u % q;
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = stage[(r0 + j * q) * 16 + c];
  transpose_nibbles<kOrder>(w, acc);
}

// acc from staged_words (or a relayout's thread) as output row o of
// (rows, 128) words: two 16-byte stores at lanes 8c..8c+7
__device__ __forceinline__ void store_words8(uint32_t* out, long long o,
                                             int c, const uint32_t (&acc)[8]) {
  uint4* dst = reinterpret_cast<uint4*>(out + o * 128 + 8 * c);
  dst[0] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_uint4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace
