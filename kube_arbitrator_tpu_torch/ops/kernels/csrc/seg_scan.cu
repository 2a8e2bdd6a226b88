// K5 seg_scan: masked segment-local inclusive scan of [mask | mask*vals]
// in a sorted order, written back to the unsorted positions.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:SortLayout.rank_and_cum
// (:129-168) and ops/common.py:seg_cumsum (:74-99) in the reclaim canon
// seed (preempt.py:2222-2243).  Sorted position s reads mask[order[s]]
// and vals[s*C..]; the running count and sums reset where seg_start[s]
// is set (and at s = 0).  Outputs at order[s]: the exclusive masked
// count (i32) and the inclusive masked sums (f32).
//
// One order of float adds, the reference native kat_seg_cumsum_f32's
// (ops/native/segsum.cc): serial within a segment, in sorted order, from
// zero.  Only the masked positions add anything (the others add +0.0,
// which changes no bits), so one warp walks one segment 32 positions at a
// time: the count is a ballot / popc prefix, and the masked values of a
// tile are added one after another through warp shuffles, in lane order.
// A tile with no masked position (victim-panel padding, sparse masks)
// costs no serial step at all.  Warps whose first position is not a
// segment start exit at once.
//
// Bound: bytes — mask, order, seg_start and vals read once, rank and cum
// written once: ~2.6 MB at P = 51,200, C = 4 (~0.8 us at 3.35 TB/s).  The
// floor is the serial chain of the segment with the most masked
// positions (a queue's victims in the by_queue layout).
#include "common.cuh"

#define KAT_SCAN_MAXC 8

namespace {

__global__ void seg_scan_kernel(const uint8_t* __restrict__ mask,
                                const int* __restrict__ order,
                                const uint8_t* __restrict__ seg_start,
                                const float* __restrict__ vals, int P, int C,
                                int* __restrict__ rank_out,
                                float* __restrict__ cum_out) {
  const int lane = threadIdx.x & 31;
  const int s0 = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // one warp per start
  if (s0 >= P) return;
  if (s0 != 0 && !seg_start[s0]) return;  // warp-uniform
  float carry[KAT_SCAN_MAXC];
#pragma unroll
  for (int c = 0; c < KAT_SCAN_MAXC; ++c) carry[c] = 0.f;
  int carry_cnt = 0;
  for (int base = s0; base < P; base += 32) {
    const int s = base + lane;
    const bool inb = s < P;
    const unsigned ends = __ballot_sync(0xffffffffu, inb && s != s0 && seg_start[s]);
    const int n_in = ends ? __ffs(ends) - 1 : 32;  // lanes of this tile in the segment
    const bool in_seg = inb && lane < n_in;
    const int t = in_seg ? (order ? order[s] : s) : 0;
    const bool m = in_seg && mask[t] != 0;
    const unsigned mb = __ballot_sync(0xffffffffu, m);
    if (in_seg) rank_out[t] = carry_cnt + __popc(mb & ((1u << lane) - 1u));
    carry_cnt += __popc(mb);
#pragma unroll
    for (int c = 0; c < KAT_SCAN_MAXC; ++c) {
      if (c >= C) break;
      const float v = m ? vals[(size_t)s * C + c] : 0.f;
      float acc = carry[c], mine = carry[c];
      for (unsigned bits = mb; bits; bits &= bits - 1u) {
        const int i = __ffs(bits) - 1;
        acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, v, i));
        if (lane >= i) mine = acc;
      }
      if (in_seg) cum_out[(size_t)t * C + c] = mine;
      carry[c] = acc;
    }
    if (ends) break;
  }
}

}  // namespace

extern "C" int kat_seg_scan(const uint8_t* mask, const int* order,
                            const uint8_t* seg_start, const float* vals, int P,
                            int C, int* rank_out, float* cum_out, void* stream) {
  if (C > KAT_SCAN_MAXC) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    const size_t threads = (size_t)P * 32;  // one warp per position
    seg_scan_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        mask, order, seg_start, vals, P, C, rank_out, cum_out);
  }
  return (int)cudaGetLastError();
}
