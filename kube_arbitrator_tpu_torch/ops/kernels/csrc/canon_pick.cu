// K7 canon_pick: one reclaim turn's victim sums per node and its
// first-fit node.
//
// Replaces, per turn of kube_arbitrator_tpu/ops/preempt.py:_reclaim_canon
// (:2331-2335), _canon_elig (:2012), the own-queue exclusion,
// _canon_per_node (:2035) and the first-fit pick of _canon_fit_commit
// (_fit_feasible :2058, :2104-2108).  The canon pack keeps each node's
// candidates in one contiguous block rv_block_start[n]..[n+1], so one
// thread per node adds its block's [count | resreq] of eligible slots in
// slot order (the reference's scatter order; no float atomics), then
// tests the claim's feasibility on that node: the node screens of
// csrc/canon.cuh (predicate class, host ports, pod headroom), at least
// one victim, and the weak validateVictims screen (not every resource
// strictly below the request).  The first
// feasible node is an integer atomicMin, exact in any order; *pick stays
// N (the wrapper's fill) when no node is feasible.
//
// Bound: bytes — the canon arrays read once (cand, ranks, F-wide
// cumulatives and deserved, R-wide resreq, job and queue ordinals) plus
// the node state: ~1.6 MB at Vp = 25,600, N = 5,120 (~0.5 us at
// 3.35 TB/s).  Blocks are at most W = 32 slots, so the serial sums are
// short; the launch is the floor.
#include "canon.cuh"

namespace {

__global__ void canon_pick_kernel(
    CanonElig e, NodeScreen ns, const int* __restrict__ bstart, const float* __restrict__ cres,
    const int* __restrict__ q_p, const int* __restrict__ g_p,
    const uint8_t* __restrict__ has_grp_p, const uint8_t* __restrict__ pop_p,
    const float* __restrict__ req, int N, int* __restrict__ pick) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N || !(*pop_p && *has_grp_p)) return;
  const int q = *q_p, g = *g_p;
  const bool node_ok = kat_reclaim_node_ok(ns, g, n);
  if (!node_ok) return;
  float cnt = 0.f;
  float res[8];
  for (int r = 0; r < e.R; ++r) res[r] = 0.f;
  for (int s = bstart[n]; s < bstart[n + 1]; ++s) {
    if (!kat_canon_victim(e, s, q)) continue;
    cnt = __fadd_rn(cnt, 1.f);
    for (int r = 0; r < e.R; ++r) res[r] = __fadd_rn(res[r], cres[(size_t)s * e.R + r]);
  }
  bool all_below = true;
  for (int r = 0; r < e.R; ++r) all_below &= res[r] < req[r];
  if (cnt > 0.f && !all_below) atomicMin(pick, n);
}

}  // namespace

extern "C" int kat_canon_pick(
    const uint8_t* cand, const float* rank_nj, const float* cum_nq, const int* cj,
    const int* cq, const float* deserved_c, const int* job_ready_cnt,
    const int* min_avail, const float* queue_alloc, int R, int F, int use_gang,
    int use_prop, const int* bstart, const float* cres, const int* q, const int* g,
    const uint8_t* has_grp, const uint8_t* pop, const float* req,
    const uint8_t* class_fit, int CN, const int* node_klass,
    const uint8_t* node_valid, const uint8_t* node_unsched,
    const int* node_max_tasks, const int* node_num_tasks, const int* node_ports,
    const int* group_klass, const int* group_ports, int N, int PW, int preds_on,
    int* pick, void* stream) {
  if (R > 8) return (int)cudaErrorInvalidValue;
  CanonElig e{cand, rank_nj, cum_nq, cj, cq, deserved_c, job_ready_cnt, min_avail,
              queue_alloc, R, F, use_gang != 0, use_prop != 0};
  NodeScreen ns{class_fit, CN, node_klass, node_valid, node_unsched, node_max_tasks,
                node_num_tasks, node_ports, group_klass, group_ports, PW, preds_on != 0};
  if (N > 0) {
    canon_pick_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        e, ns, bstart, cres, q, g, has_grp, pop, req, N, pick);
  }
  return (int)cudaGetLastError();
}
