// One-block exclusive sum shared by the row prefix (prefix.cu, B2) and B1n's
// emit_prefix (stage1_v4.cu): the second pass of their cross-block sums of
// row popcounts. The inputs are one value per block of the first pass, a
// few thousand at most, so one block of 1024 threads scans them: each
// thread folds a contiguous segment, a warp scan with __shfl_up_sync and a
// scan over the 32 warp totals give each segment its incoming value, and
// each thread writes its segment.
#pragma once

#include <cstdint>

namespace csv_scan {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Plus {
  static constexpr int kIdentity = 0;
  __device__ static int apply(int a, int b) { return a + b; }
};

template <class Op>
__device__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = Op::apply(x, y);
  }
  return x;
}

// out[i] = seed op in[0] op ... op in[i-1] for i < n; *total = seed op all.
// Launch with exactly one block of kThreads threads.
template <class Op>
__device__ void exclusive_scan_one_block(const int* __restrict__ in,
                                         int* __restrict__ out, int n,
                                         int seed, int* __restrict__ total) {
  __shared__ int s_warp[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * seg, n), hi = min(lo + seg, n);
  int local = Op::kIdentity;
  for (int i = lo; i < hi; ++i) local = Op::apply(local, in[i]);
  const int incl = warp_inclusive_scan<Op>(local, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) s_warp[lane] = warp_inclusive_scan<Op>(s_warp[lane], lane);
  __syncthreads();
  int lane_excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) lane_excl = Op::kIdentity;
  int run = Op::apply(seed, warp > 0 ? s_warp[warp - 1] : Op::kIdentity);
  run = Op::apply(run, lane_excl);
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run = Op::apply(run, in[i]);
  }
  // the last thread's segment ends at n (or is empty): run covers all
  if (tid == kThreads - 1) *total = run;
}

}  // namespace csv_scan
