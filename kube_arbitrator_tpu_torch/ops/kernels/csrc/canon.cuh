// Reclaim canon-walk helpers shared by K7 canon_pick, K8 canon_commit,
// K13 round_products and K14 union_fit: one definition of a canon slot's
// victim eligibility and of a claim's node screens, so the node a pick
// chooses and the window the commit evicts from read the same mask.
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

// preempt.py:_canon_elig (:2012-2032): canon slot s's victim eligibility
// from the carried scans, before any turn's own-queue exclusion.
__device__ __forceinline__ bool kat_canon_elig(const CanonElig& e, int s) {
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
  return ok;
}

// The eligibility with the turn's own-queue exclusion (:2334) for
// claimant queue q.
__device__ __forceinline__ bool kat_canon_victim(const CanonElig& e, int s, int q) {
  return kat_canon_elig(e, s) && e.cq[s] != q;
}

// The node screens of preempt.py:_fit_feasible (:2058-2077) for claimant
// group g on node n: predicate class, cordon, pod headroom and host
// ports when the predicates plugin is on, else node validity.  The
// victim screens (count, weak allRes.Less) are the caller's.
struct NodeScreen {
  const uint8_t* class_fit;   // bool[K, CN]
  int CN;
  const int* node_klass;      // i32[N]
  const uint8_t* node_valid;  // bool[N]
  const uint8_t* node_unsched;
  const int* node_max_tasks;  // i32[N]
  const int* node_num_tasks;  // i32[N]
  const int* node_ports;      // i32[N, PW]
  const int* group_klass;     // i32[G]
  const int* group_ports;     // i32[G, PW]
  int PW;
  bool preds_on;
};

__device__ __forceinline__ bool kat_reclaim_node_ok(const NodeScreen& ns, int g, int n) {
  if (!ns.preds_on) return ns.node_valid[n] != 0;
  bool ok = ns.class_fit[(size_t)ns.group_klass[g] * ns.CN + ns.node_klass[n]] != 0 &&
            ns.node_valid[n] != 0 && ns.node_unsched[n] == 0 &&
            ns.node_max_tasks[n] - ns.node_num_tasks[n] > 0;
  for (int w = 0; w < ns.PW; ++w) {
    ok = ok && (ns.group_ports[(size_t)g * ns.PW + w] & ns.node_ports[(size_t)n * ns.PW + w]) == 0;
  }
  return ok;
}
