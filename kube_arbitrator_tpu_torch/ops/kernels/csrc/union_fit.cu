// K14 union_fit: the first feasible node of each row of a panel of
// reclaim claims, from the round products (K13) with each row's own
// queue subtracted.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_union_minus_own
// (:2609-2620) followed by _fit_feasible (:2058) and the first-fit pick,
// as the batched engine's thin turn runs them for one queue
// (:2519-2523, _canon_fit_commit :2104-2108) and the optimistic window
// vmaps them over its RP panel rows (:2723-2735).
//
// Grid (node tiles, rows); one thread per (row r, node n).  The thread
// finds its own-queue segment's LAST slot by binary search in the
// ascending (node, queue) key skey (searchsorted side="right" minus one,
// a hit only where the slot's key is the row's key: a node with no
// victims, or no segment of this queue on it, subtracts nothing), takes
// that slot's segmented total off the union sums, and applies the node
// screens of csrc/canon.cuh, vic_cnt > 0 and the weak validateVictims
// screen.  The first feasible node per row is an integer atomicMin,
// exact in any order; pick[r] stays N (the wrapper's fill) when none is.
//
// Bound: bytes — the [N, R+1] union sums, the node state and the rows
// read once, pick written once; the binary searches read log2(Vp) keys
// per cell, mostly from L2: ~0.3 MB at N = 5,120 plus 20 reads per cell.
// The RP x N searches (2.6 M at RP = 512) are the operations.
#include "canon.cuh"

namespace {

__global__ void union_fit_kernel(
    NodeScreen ns, const int* __restrict__ skey, const float* __restrict__ segcum,
    const float* __restrict__ pn, int R, int Q, int Vp, const int* __restrict__ q_r,
    const int* __restrict__ g_r, const uint8_t* __restrict__ has_grp_r,
    const uint8_t* __restrict__ pop_r, const float* __restrict__ req_r, int N,
    int* __restrict__ pick) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (n >= N || !(pop_r[r] && has_grp_r[r])) return;
  const int g = g_r[r];
  if (!kat_reclaim_node_ok(ns, g, n)) return;
  const int key = n * (Q + 1) + q_r[r];
  int lo = 0, hi = Vp;  // first slot whose key is above the row's
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (skey[mid] <= key) lo = mid + 1; else hi = mid;
  }
  const int pos = lo - 1;
  const bool hit = pos >= 0 && skey[pos] == key;
  const int C = R + 1;
  const float* own = segcum + (size_t)(pos < 0 ? 0 : pos) * C;
  const float* un = pn + (size_t)n * C;
  const float cnt = __fsub_rn(un[0], hit ? own[0] : 0.f);
  bool all_below = true;
  for (int c = 1; c < C; ++c) {
    all_below &= __fsub_rn(un[c], hit ? own[c] : 0.f) < req_r[(size_t)r * R + c - 1];
  }
  if (cnt > 0.f && !all_below) atomicMin(pick + r, n);
}

}  // namespace

extern "C" int kat_union_fit(
    const int* skey, const float* segcum, const float* pn, int R, int Q, int Vp,
    const int* q, const int* g, const uint8_t* has_grp, const uint8_t* pop,
    const float* req, int rows, const uint8_t* class_fit, int CN, const int* node_klass,
    const uint8_t* node_valid, const uint8_t* node_unsched, const int* node_max_tasks,
    const int* node_num_tasks, const int* node_ports, const int* group_klass,
    const int* group_ports, int N, int PW, int preds_on, int* pick, void* stream) {
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  NodeScreen ns{class_fit, CN, node_klass, node_valid, node_unsched, node_max_tasks,
                node_num_tasks, node_ports, group_klass, group_ports, PW, preds_on != 0};
  if (N > 0 && rows > 0) {
    const dim3 grid((N + 127) / 128, rows);
    union_fit_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        ns, skey, segcum, pn, R, Q, Vp, q, g, has_grp, pop, req, N, pick);
  }
  return (int)cudaGetLastError();
}
