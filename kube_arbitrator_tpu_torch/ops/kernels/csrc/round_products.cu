// K13 round_products: the [Vp]-wide products the opt-in reclaim engines
// read at a round (the batched engine) or a speculation window (the
// optimistic engine) from the current carried state.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_round_products
// (:2582-2606): the union victim eligibility (_canon_elig, the same
// definition K7 and K8 use, csrc/canon.cuh), the per-node [count |
// resreq] sums of the eligible slots (_canon_per_node) and the
// (node, queue) segmented inclusive scan of the same [count | resreq]
// rows over rv_nq_start (seg_cumsum).
//
// One warp per canon node block rv_block_start[n]..[n+1] (warp N takes
// the padding past the last block, which the pack starts as a segment of
// its own): the lanes evaluate the block's eligibility, then lane c adds
// column c serially in slot order — the node's total from zero (the
// reference's scatter order, no float atomics) and the running segment
// sum, reset at each segment start (K5's order).  Segments never cross a
// node block, so a warp needs nothing from another.
//
// dirty: an optional device flag.  When given and clear, the launch
// returns at once and the products keep their values — the batched
// engine refreshes them at the first turn after each claim without a
// host read per turn.
//
// Bound: bytes — the canon arrays the eligibility reads (cand, ranks, F
// cumulatives and deserved, job and queue ordinals), R resreq columns
// and the segment flags, read once; elig, the [N, R+1] sums and the
// [Vp, R+1] scan written once: ~1.9 MB at Vp = 25,600, N = 5,120, R = 4
// (~0.6 us at 3.35 TB/s).
#include "canon.cuh"

namespace {

__global__ void round_products_kernel(
    CanonElig e, const int* __restrict__ bstart, const uint8_t* __restrict__ nq_start,
    const float* __restrict__ cres, int N, int Vp, const uint8_t* __restrict__ dirty,
    uint8_t* __restrict__ elig, float* __restrict__ pn, float* __restrict__ segcum) {
  if (dirty != nullptr && *dirty == 0) return;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp > N) return;
  const int b0 = bstart[warp];
  const int b1 = warp < N ? bstart[warp + 1] : Vp;
  for (int s = b0 + lane; s < b1; s += 32) elig[s] = kat_canon_elig(e, s) ? 1 : 0;
  __syncwarp();
  const int R = e.R, C = R + 1;
  if (lane >= C) return;
  float tot = 0.f, acc = 0.f;
  for (int s = b0; s < b1; ++s) {
    const bool el = elig[s] != 0;
    const float v = lane == 0 ? (el ? 1.f : 0.f) : (el ? cres[(size_t)s * R + lane - 1] : 0.f);
    if (s == b0 || nq_start[s]) acc = 0.f;
    acc = __fadd_rn(acc, v);
    segcum[(size_t)s * C + lane] = acc;
    tot = __fadd_rn(tot, v);
  }
  if (warp < N) pn[(size_t)warp * C + lane] = tot;
}

}  // namespace

extern "C" int kat_round_products(
    const uint8_t* cand, const float* rank_nj, const float* cum_nq, const int* cj,
    const int* cq, const float* deserved_c, const int* job_ready_cnt,
    const int* min_avail, const float* queue_alloc, int R, int F, int use_gang,
    int use_prop, const int* bstart, const uint8_t* nq_start, const float* cres, int N,
    int Vp, const uint8_t* dirty, uint8_t* elig, float* pn, float* segcum, void* stream) {
  if (R + 1 > 32) return (int)cudaErrorInvalidValue;
  CanonElig e{cand, rank_nj, cum_nq, cj, cq, deserved_c, job_ready_cnt, min_avail,
              queue_alloc, R, F, use_gang != 0, use_prop != 0};
  const int threads = 256;
  const long warps = (long)N + 1;
  const int blocks = (int)((warps * 32 + threads - 1) / threads);
  round_products_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      e, bstart, nq_start, cres, N, Vp, dirty, elig, pn, segcum);
  return (int)cudaGetLastError();
}
