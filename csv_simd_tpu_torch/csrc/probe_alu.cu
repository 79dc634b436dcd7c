// The integer-ALU probe for Hopper (sm_90a): the card's int32 op rate, the
// compute ceiling of the stage-1 kernels' classify and scan.
//
// Replaces tools/vpu_roofline.py `_probe_kernel` (line 73), launched by
// `_chain` (pallas_call line 95).
//
// What it computes, per int32 element w of (rows, 128) in and a scalar s:
// x = w + s; four chains start at x, x ^ 17, x + 5 and x ^ -7; chain j runs
// n_ops / 4 steps, step k applying the mix's kind k % (number of kinds) with
// the constant K[(4k + j) % 256] (K drawn by the caller, as the TPU tool drew
// it from np.random.default_rng(11)): add K, xor K, mul (K | 1), or a logical
// shift right by 1. out = (c0 ^ c1) + (c2 ^ c3). Everything wraps at 32 bits.
// Mixes: alu = add, xor; shift = lsr, add, xor; mul = mul, xor.
//
// What bounds it on an H100: at small n_ops the 8 bytes an element moves
// (HBM), at large n_ops the integer pipes. The op count and the mix are
// template parameters, so the chains unroll into straight-line code and the
// constants sit in the kernel's parameter bank as instruction operands (no
// loads). Each thread runs four elements at once (one int4), 16 independent
// chains, to cover the pipes' latency. The rate is read from two op counts
// that are both compute-bound: elements x (ops_hi - ops_lo) / (t_hi - t_lo).
// On an H100 at 64 MiB, 16, 48 and even 128 ops took the same time (the
// memory stream), so the counts built are 16 and 48 (the TPU tool's, held
// bit for bit) and 512 and 1024 (the rate).
// It counts the tool's ops, not machine instructions: the compiler may fuse
// a shift and an add into one.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kConsts = 256;
constexpr int kAdd = 0, kXor = 1, kMul = 2, kLsr = 3;
constexpr int kMixAlu = 0, kMixShift = 1, kMixMul = 2;

struct Consts {
  uint32_t v[kConsts];
};

template <int kMix>
__host__ __device__ constexpr int kind_of(int k) {
  return kMix == kMixAlu ? (k % 2 == 0 ? kAdd : kXor)
         : kMix == kMixShift ? (k % 3 == 0 ? kLsr : k % 3 == 1 ? kAdd : kXor)
                             : (k % 2 == 0 ? kMul : kXor);
}

template <int kKind>
__device__ __forceinline__ uint32_t apply(uint32_t v, uint32_t c) {
  if (kKind == kAdd) return v + c;
  if (kKind == kXor) return v ^ c;
  if (kKind == kMul) return v * (c | 1u);
  return v >> 1;
}

// Applies steps kFirst .. kFirst + kCount - 1 to the four chains of one
// element: a binary split, so that the instantiation depth is log2 of the
// step count, and each leaf has its kind and constants at compile time.
template <int kMix, int kFirst, int kCount>
struct Steps {
  static __device__ __forceinline__ void run(uint32_t (&ch)[4],
                                             const Consts& k) {
    if constexpr (kCount == 1) {
      constexpr int kind = kind_of<kMix>(kFirst);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ch[j] = apply<kind>(ch[j], k.v[(4 * kFirst + j) % kConsts]);
    } else {
      Steps<kMix, kFirst, kCount / 2>::run(ch, k);
      Steps<kMix, kFirst + kCount / 2, kCount - kCount / 2>::run(ch, k);
    }
  }
};

template <int kOps, int kMix>
__device__ __forceinline__ uint32_t element(uint32_t x, const Consts& k) {
  uint32_t ch[4] = {x, x ^ 17u, x + 5u, x ^ (uint32_t)-7};
  Steps<kMix, 0, kOps / 4>::run(ch, k);
  return (ch[0] ^ ch[1]) + (ch[2] ^ ch[3]);
}

template <int kOps, int kMix>
__global__ void __launch_bounds__(kThreads)
alu_chain(const uint4* __restrict__ in, long long n4, const Consts k,
          const int* __restrict__ s_ptr, int s_in, uint4* __restrict__ out) {
  const uint32_t s = (uint32_t)(s_ptr ? *s_ptr : s_in);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const uint4 w = in[i];
    out[i] = make_uint4(element<kOps, kMix>(w.x + s, k),
                        element<kOps, kMix>(w.y + s, k),
                        element<kOps, kMix>(w.z + s, k),
                        element<kOps, kMix>(w.w + s, k));
  }
}

template <int kOps>
cudaError_t launch(int mix, const void* in, long long n4, const Consts& k,
                   const void* s_ptr, int s_in, void* out, unsigned grid,
                   cudaStream_t st) {
  const uint4* i4 = static_cast<const uint4*>(in);
  const int* sp = static_cast<const int*>(s_ptr);
  uint4* o4 = static_cast<uint4*>(out);
  if (mix == kMixAlu)
    alu_chain<kOps, kMixAlu><<<grid, kThreads, 0, st>>>(i4, n4, k, sp, s_in, o4);
  else if (mix == kMixShift)
    alu_chain<kOps, kMixShift><<<grid, kThreads, 0, st>>>(i4, n4, k, sp, s_in, o4);
  else if (mix == kMixMul)
    alu_chain<kOps, kMixMul><<<grid, kThreads, 0, st>>>(i4, n4, k, sp, s_in, o4);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The op counts this build instantiates, in order; csv_probe_alu_op_count(i)
// is the i-th, and -1 past the last.
int csv_probe_alu_op_count(int i) {
  constexpr int kCounts[] = {16, 48, 512, 1024};
  return i >= 0 && i < 4 ? kCounts[i] : -1;
}

// in, out: n int32 elements (n a positive multiple of 4, 16-byte aligned).
// consts: 256 ints on the host. mix: 0 alu, 1 shift, 2 mul. n_ops: one of
// csv_probe_alu_op_count's. s_ptr: a device int read as s, or null to take
// s_in. Returns cudaGetLastError() after the launch.
int csv_probe_alu(const void* in, long long n, const int* consts, int mix,
                  int n_ops, const void* s_ptr, int s_in, void* out,
                  int n_sms, void* stream) {
  if (n <= 0 || n % 4 != 0 || n_sms <= 0) return (int)cudaErrorInvalidValue;
  Consts k;
  for (int i = 0; i < kConsts; ++i) k.v[i] = (uint32_t)consts[i];
  const long long n4 = n / 4;
  // a grid-stride loop over enough blocks to fill every SM several times
  const long long want = (n4 + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < 16LL * n_sms ? want : 16LL * n_sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_ops) {
    case 16: err = launch<16>(mix, in, n4, k, s_ptr, s_in, out, grid, st); break;
    case 48: err = launch<48>(mix, in, n4, k, s_ptr, s_in, out, grid, st); break;
    case 512: err = launch<512>(mix, in, n4, k, s_ptr, s_in, out, grid, st); break;
    case 1024: err = launch<1024>(mix, in, n4, k, s_ptr, s_in, out, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
