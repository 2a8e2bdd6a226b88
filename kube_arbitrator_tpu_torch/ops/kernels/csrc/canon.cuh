// Reclaim canon-walk helpers shared by K7 canon_pick and K8 canon_commit:
// one definition of a canon slot's victim eligibility, so the node the
// pick chooses and the window the commit evicts from read the same mask.
#pragma once
#include "common.cuh"

struct CanonElig {
  const uint8_t* cand;        // bool[Vp] live candidates
  const float* rank_nj;       // f32[Vp] exclusive in-(node, job) candidate rank
  const float* cum_nq;        // f32[Vp, F] inclusive in-(node, queue) fair cumulative
  const int* cj;              // i32[Vp] slot -> job
  const int* cq;              // i32[Vp] slot -> queue
  const float* deserved_c;    // f32[Vp, F] fair(deserved)[cq]
  const int* job_ready_cnt;   // i32[J]
  const int* min_avail;       // i32[J]
  const float* queue_alloc;   // f32[Q, R]
  int R, F;
  bool use_gang, use_prop;
};

// preempt.py:_canon_elig (:2012-2032) and the turn's own-queue exclusion
// (:2334) for canon slot s of claimant queue q.
__device__ __forceinline__ bool kat_canon_victim(const CanonElig& e, int s, int q) {
  bool ok = e.cand[s] != 0;
  if (!(e.use_gang || e.use_prop)) return false;
  if (e.use_gang) {
    const int j = e.cj[s];
    const int cap = max(e.job_ready_cnt[j] - e.min_avail[j], 0);
    ok = ok && e.rank_nj[s] < __int2float_rn(cap);
  }
  if (e.use_prop) {
    const int qq = e.cq[s];
    for (int r = 0; r < e.F; ++r) {
      const float after = __fsub_rn(e.queue_alloc[(size_t)qq * e.R + r], e.cum_nq[(size_t)s * e.F + r]);
      ok = ok && e.deserved_c[(size_t)s * e.F + r] < __fadd_rn(after, KAT_EPS);
    }
  }
  return ok && e.cq[s] != q;
}
