// The JSON stage-1 for Hopper (sm_90a): kernel J1.
//
// Replaces csv_simd_tpu/experiments/json_device.py `json_depths_device`
// (line 93) and the `json_structural_mask_device` it calls (line 55). They
// are XLA code, no pallas_call: a segmented cummax for the backslash runs and
// two int32 cumsums over the whole byte stream. Their plain version,
// experiments/json_device.py `_depths_plain`, is eager torch and holds about
// fifteen tensors of the input's size at once.
//
// What it computes, for n bytes (0 < n < 2^31): escaped[i] iff byte i-1 is a
// backslash that ends a run of backslashes of odd length (the run may begin
// in any earlier segment); q_eff = (byte == '"') & ~escaped; in_string the
// inclusive parity of q_eff; mask[i] = byte i in {}[]:, and not in_string;
// depth[i] the inclusive int32 sum (wrapping) of +1 at masked openers and -1
// at masked closers, minus one at a masked opener. Both outputs are (n,)
// int32.
//
// What bounds it on an H100: HBM bandwidth, one read of n bytes and 8n bytes
// written; this design reads the bytes twice, 10n in all.
//
// What the design does about it. The state that crosses a byte boundary is
// (r, q, d): the parity of the backslash run that ends there, the in-string
// parity and the depth. A span of bytes maps it so: r_out depends on r only
// when the span is all backslashes; q_out = q ^ x(r); d_out = d + delta(r, q).
// Only one byte of a span sees r: the first byte that is not a backslash,
// whose escape r flips. So a span's table is its result for r = 0 (r_out0,
// x0, and delta0 for q = 0) with three more facts: whether it is all
// backslashes, whether its first other byte is a quote (then r = 1 flips x
// and swaps which bytes are in strings after it), and tot, the sum of the
// signs of all its brackets (delta for q = 1 is tot - delta0). Tables compose
// associatively. Three launches:
//   json_tables: one warp a 16 KiB segment, 16 bytes a lane a step (16-byte
//     loads); each lane classifies its bytes into 16-bit masks and builds its
//     piece's table, the warp composes its 32 pieces in order with shuffles,
//     and the segment's table is written;
//   json_scan: one block composes the tables in order (a run a thread, warp
//     shuffles, the warps' totals in shared memory) and writes each segment's
//     incoming state;
//   json_emit: one warp a segment again, 4 bytes a lane a step (a warp 128
//     bytes). Each lane classifies its word into 4-bit masks; the run parity
//     before a lane is the trailing parity of the nearest lower lane that is
//     not all backslashes (ballots, a lane of four backslashes keeps the
//     parity), the escapes of its 4 bytes are simdjson's odd-run construction
//     on those bits, the quote parity before it the __popc of a ballot below
//     its lane, the depth before it a warp scan of the lanes' bracket sums by
//     __shfl_up_sync. Each lane writes its 4 mask and 4 depth values with one
//     16-byte store each: a warp writes 512 contiguous bytes of each output.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // one segment a warp
constexpr long long kSeg = 16384;      // bytes a segment
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEven = 0x55555555u;
constexpr uint32_t kOdd = 0xAAAAAAAAu;

// bit 7 of each byte of x set where it equals the same byte of k (exact:
// the add of the low seven bits cannot carry into the next byte)
__device__ __forceinline__ uint32_t eq_bytes(uint32_t x, uint32_t k) {
  const uint32_t y = x ^ k;
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & 0x80808080u;
}

// bit k = bit 7 of byte k: the four bits gathered by one multiply, every
// partial product landing on its own bit
__device__ __forceinline__ uint32_t nibble(uint32_t hi) {
  return ((hi >> 7) * 0x01020408u) >> 24;
}

// the classes of a word's four bytes, bit k = byte k
struct Classes {
  uint32_t bs, qt, op, cl, st;
};

template <bool kStructural>
__device__ __forceinline__ Classes classify(uint32_t w) {
  // '{' 0x7B and '[' 0x5B differ in bit 5 only, as do '}' and ']'
  const uint32_t w20 = w | 0x20202020u;
  const uint32_t op = eq_bytes(w20, 0x7B7B7B7Bu);
  const uint32_t cl = eq_bytes(w20, 0x7D7D7D7Du);
  Classes c;
  c.bs = nibble(eq_bytes(w, 0x5C5C5C5Cu));
  c.qt = nibble(eq_bytes(w, 0x22222222u));
  c.op = nibble(op);
  c.cl = nibble(cl);
  c.st = kStructural ? nibble(op | cl | eq_bytes(w, 0x3A3A3A3Au) |
                              eq_bytes(w, 0x2C2C2C2Cu))
                     : 0u;
  return c;
}

// golden json_levels._escaped_positions on `ext`, whose bit 0 stands for
// the parity of the run before the bytes (a run of length 1 when odd) and
// bit k + 1 for byte k: bit k + 1 of the result is set iff byte k is escaped
__device__ __forceinline__ uint32_t escaped_ext(uint32_t ext) {
  const uint32_t starts = ext & ~(ext << 1);
  const uint32_t even_carries = (ext + (starts & kEven)) & ~ext;
  const uint32_t odd_carries = (ext + (starts & kOdd)) & ~ext;
  return (even_carries & kOdd) | (odd_carries & kEven);
}

// a span's table: flags bit 0 all backslashes, bit 1 its first other byte
// is a quote, bit 2 r_out and bit 3 x for r = 0; d0 the depth change for
// r = q = 0; tot the signs of all its brackets. Sums wrap mod 2^32.
struct Table {
  uint32_t flags, d0, tot;
};

__device__ __forceinline__ Table identity() { return {1u, 0u, 0u}; }

// the table of span a followed by span b
__device__ __forceinline__ Table compose(Table a, Table b) {
  const uint32_t a_all = a.flags & 1u, a_q = (a.flags >> 1) & 1u;
  const uint32_t a_r = (a.flags >> 2) & 1u, a_x = (a.flags >> 3) & 1u;
  const uint32_t b_all = b.flags & 1u, b_q = (b.flags >> 1) & 1u;
  const uint32_t b_r = (b.flags >> 2) & 1u, b_x = (b.flags >> 3) & 1u;
  // b is entered with r = a_r and q = a_x; r = 1 flips its first quote
  const uint32_t flip = a_r & b_q;
  Table t;
  t.flags = (a_all & b_all) | ((a_all ? b_q : a_q) << 1) |
            ((b_r ^ (a_r & b_all)) << 2) | ((a_x ^ b_x ^ flip) << 3);
  t.d0 = a.d0 + ((a_x ^ flip) ? b.tot - b.d0 : b.d0);
  t.tot = a.tot + b.tot;
  return t;
}

__device__ __forceinline__ Table shfl_down(Table t, int s) {
  return {__shfl_down_sync(kFull, t.flags, s), __shfl_down_sync(kFull, t.d0, s),
          __shfl_down_sync(kFull, t.tot, s)};
}

__device__ __forceinline__ Table shfl_up(Table t, int s) {
  return {__shfl_up_sync(kFull, t.flags, s), __shfl_up_sync(kFull, t.d0, s),
          __shfl_up_sync(kFull, t.tot, s)};
}

// the table of 16 bytes held as four little-endian words
__device__ __forceinline__ Table piece_table(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bs = 0, qt = 0, op = 0, cl = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Classes c = classify<false>(w[k]);
    bs |= c.bs << (4 * k);
    qt |= c.qt << (4 * k);
    op |= c.op << (4 * k);
    cl |= c.cl << (4 * k);
  }
  const uint32_t all = bs == 0xFFFFu;
  // the first byte that is not a backslash (16 when there is none: then
  // the shift gives 0)
  const uint32_t first_q = (qt >> (__ffs((int)~bs) - 1)) & 1u;
  const uint32_t esc = (escaped_ext(bs << 1) >> 1) & 0xFFFFu;
  const uint32_t r_out = __clz(~(bs << 16)) & 1u;  // its trailing run
  const uint32_t qe = qt & ~esc;
  uint32_t ins = qe ^ (qe << 1);
  ins ^= ins << 2;
  ins ^= ins << 4;
  ins ^= ins << 8;
  const uint32_t out = ~ins & 0xFFFFu;
  Table t;
  t.flags = all | (first_q << 1) | (r_out << 2) | ((__popc(qe) & 1u) << 3);
  t.d0 = (uint32_t)(__popc(op & out) - __popc(cl & out));
  t.tot = (uint32_t)(__popc(op) - __popc(cl));
  return t;
}

__global__ void __launch_bounds__(kThreads)
json_tables(const uint8_t* __restrict__ data, long long n, long long nseg,
            Table* __restrict__ tables) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= nseg) return;
  const long long lo = g * kSeg;
  const long long hi = lo + kSeg < n ? lo + kSeg : n;
  Table acc = identity();
  for (long long base = lo; base < hi; base += 512) {
    const long long p = base + 16LL * lane;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p + 16 <= n) {
      v = __ldg(reinterpret_cast<const uint4*>(data + p));
    } else if (p < n) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (long long i = p; i < n; ++i) {
        w[(i - p) >> 2] |= (uint32_t)data[i] << (8 * ((i - p) & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    Table t = piece_table(v);
    // the 32 pieces in order: lane l takes lane l + s's span after its own
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const Table o = shfl_down(t, s);
      if ((lane & (2 * s - 1)) == 0) t = compose(t, o);
    }
    acc = compose(acc, t);
  }
  if (lane == 0) tables[g] = acc;
}

// each segment's incoming state: (r | q << 1, d) after the segments before
__global__ void __launch_bounds__(kScanThreads)
json_scan(const Table* __restrict__ tables, long long nseg,
          int2* __restrict__ carries) {
  __shared__ Table s_warp[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per = (nseg + kScanThreads - 1) / kScanThreads;
  const long long lo = tid * per < nseg ? tid * per : nseg;
  const long long hi = lo + per < nseg ? lo + per : nseg;
  Table run = identity();
  for (long long i = lo; i < hi; ++i) run = compose(run, tables[i]);
  Table incl = run;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const Table o = shfl_up(incl, s);
    if (lane >= s) incl = compose(o, incl);
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Table w = s_warp[lane];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const Table o = shfl_up(w, s);
      if (lane >= s) w = compose(o, w);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  Table lane_excl = shfl_up(incl, 1);
  if (lane == 0) lane_excl = identity();
  Table state = warp > 0 ? compose(s_warp[warp - 1], lane_excl) : lane_excl;
  for (long long i = lo; i < hi; ++i) {
    // the state after `state`'s span entered with (0, 0, 0)
    carries[i] = make_int2((int)((state.flags >> 2) & 3u), (int)state.d0);
    state = compose(state, tables[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
json_emit(const uint8_t* __restrict__ data, long long n, long long nseg,
          const int2* __restrict__ carries, int* __restrict__ mask,
          int* __restrict__ depth) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= nseg) return;
  const int2 c = carries[g];
  uint32_t r = c.x & 1, q = (c.x >> 1) & 1, d = (uint32_t)c.y;
  const uint32_t below = (1u << lane) - 1u;
  const long long lo = g * kSeg;
  const long long hi = lo + kSeg < n ? lo + kSeg : n;
  for (long long base = lo; base < hi; base += 128) {
    const long long p = base + 4LL * lane;
    uint32_t w = 0;
    if (p + 4 <= n) {
      w = __ldg(reinterpret_cast<const uint32_t*>(data + p));
    } else {
      for (long long i = p; i < n; ++i) w |= (uint32_t)data[i] << (8 * (i - p));
    }
    const Classes cls = classify<true>(w);
    // the run parity before this lane: the trailing run of the nearest lane
    // below that is not all backslashes, else the step's carry
    const unsigned other = __ballot_sync(kFull, cls.bs != 0xFu);
    const unsigned trail =
        __ballot_sync(kFull, __clz(~(cls.bs << 28)) & 1u);
    const unsigned lower = other & below;
    const uint32_t r_in = lower ? (trail >> (31 - __clz(lower))) & 1u : r;
    const uint32_t esc = (escaped_ext((cls.bs << 1) | r_in) >> 1) & 0xFu;
    const uint32_t qe = cls.qt & ~esc;
    const unsigned odd = __ballot_sync(kFull, __popc(qe) & 1u);
    const uint32_t q_in = q ^ (__popc(odd & below) & 1u);
    uint32_t ins = qe ^ (qe << 1);
    ins ^= ins << 2;
    ins = (ins ^ (0u - q_in)) & 0xFu;
    const uint32_t m = cls.st & ~ins;
    const uint32_t opm = cls.op & m, clm = cls.cl & m;
    const uint32_t delta = (uint32_t)(__popc(opm) - __popc(clm));
    uint32_t incl = delta;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += o;
    }
    uint32_t cur = d + incl - delta;
    int dv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t o = (opm >> k) & 1u;
      cur += o - ((clm >> k) & 1u);
      dv[k] = (int)(cur - o);
    }
    if (p + 4 <= n) {
      __stcs(reinterpret_cast<int4*>(mask + p),
             make_int4(m & 1u, (m >> 1) & 1u, (m >> 2) & 1u, (m >> 3) & 1u));
      __stcs(reinterpret_cast<int4*>(depth + p),
             make_int4(dv[0], dv[1], dv[2], dv[3]));
    } else {
      for (long long i = p; i < n; ++i) {
        mask[i] = (int)((m >> (i - p)) & 1u);
        depth[i] = dv[i - p];
      }
    }
    // the carries into the next step; a step of backslashes keeps r
    r = other ? (trail >> (31 - __clz(other))) & 1u : r;
    q ^= __popc(odd) & 1u;
    d += __shfl_sync(kFull, incl, 31);
  }
}

}  // namespace

extern "C" {

// the segments (and so the tables and carries) n bytes take
long long csv_json_stage1_segments(long long n) {
  return (n + kSeg - 1) / kSeg;
}

// data: 0 < n < 2^31 bytes, 16-byte aligned; tables: 3 int32 a segment;
// carries: 2 int32 a segment; mask, depth: n int32 each, 16-byte aligned.
// Returns cudaGetLastError() after the three launches.
int csv_json_stage1(const void* data, long long n, void* tables, void* carries,
                    void* mask, void* depth, void* stream) {
  if (n <= 0 || n >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(data) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16 ||
      reinterpret_cast<uintptr_t>(depth) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nseg = csv_json_stage1_segments(n);
  const unsigned blocks = (unsigned)((nseg + kWarps - 1) / kWarps);
  const uint8_t* bytes = static_cast<const uint8_t*>(data);
  json_tables<<<blocks, kThreads, 0, st>>>(bytes, n, nseg,
                                           static_cast<Table*>(tables));
  json_scan<<<1, kScanThreads, 0, st>>>(static_cast<const Table*>(tables),
                                        nseg, static_cast<int2*>(carries));
  json_emit<<<blocks, kThreads, 0, st>>>(
      bytes, n, nseg, static_cast<const int2*>(carries),
      static_cast<int*>(mask), static_cast<int*>(depth));
  return (int)cudaGetLastError();
}

}  // extern "C"
