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
// A CTA a row, on the grid's x axis:
// * the row screen once: a row that does not pop, has no group, or (with
//   the window's ctl) lies at or past the round's trip writes N and
//   returns before it reads anything else; otherwise the CTA stages the
//   row's request and its group's host-port words in shared memory and
//   keeps the group's predicate class in a register;
// * the nodes in ascending tiles of TILE: thread t screens nodes
//   base + k * THREADS + t, k < NPT, their loads issued together — the
//   node screens of _fit_feasible, then the own-queue segment total: the
//   last slot whose key is at most the row's key node * (Q + 1) + q,
//   searched only inside the node's canon block [bstart[n], bstart[n+1])
//   (skey ascends, a node's keys lie only in its block and the padding
//   keys lie past every real key, so this is the slot, and the hit, of
//   the reference's search over the whole skey); a thread's loads are
//   issued level by level with no branch around them (indices clamped in
//   range), so the NPT nodes' loads overlap and its NPT searches run in
//   lock step; a hit subtracts that slot's segmented total from the
//   union sums (__fsub_rn, as the plain version), then vic_cnt > 0 and
//   the weak validateVictims screen;
// * each step takes the lowest feasible node of the tile (a thread's
//   first, a warp min, a block min over the warps' words) and the CTA
//   stops after the first step that has one: pick[r] is the first-fit
//   node, N where no tile had one.  No atomics, no fill: the kernel
//   writes every pick[r].
//
// The plan (union_fit.py's UnionFitPlan) binds the node screens, skey,
// the block starts, K13's pn / segcum, the node ports / pod counts K8
// changes in place and the plan-owned pick once per engine call: a launch
// passes only a Call — the rows' q and g (i32 or i64, read as either),
// has_grp, pop, req and, for the optimistic window, ctl.
//
// Bound (chip_smoke.py's k14_bound): what first fit needs on the launch's
// inputs — each live row screens the nodes up to its pick and searches
// the blocks of those that pass its node screens; the node rows and
// canon slots below the highest such node are read once.  Latency is
// the floor: a step is a chain of dependent loads (block start, the
// search, the segment total).
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NPT = 4;                // nodes a thread screens a step
constexpr int TILE = THREADS * NPT;   // nodes a step
constexpr int MAX_R = 8;
constexpr int MAX_PW = 32;

// the plan's fixed arguments (union_fit.py's _Static mirrors this layout)
struct Static {
  const uint8_t* class_fit;   // bool[K, CN]
  const int* node_klass;      // i32[N]
  const uint8_t* node_valid;  // bool[N]
  const uint8_t* node_unsched;
  const int* node_max_tasks;  // i32[N]
  const int* node_num_tasks;  // i32[N], changed in place by K8
  const int* node_ports;      // i32[N, PW], changed in place by K8
  const int* group_klass;     // i32[G]
  const int* group_ports;     // i32[G, PW]
  const int* skey;            // i32[Vp] ascending (node, queue) key
  const int* bstart;          // i32[N + 1] canon node blocks
  const float* pn;            // f32[N, R + 1] union per-node [count | resreq] (K13)
  const float* segcum;        // f32[Vp, R + 1] (node, queue) segmented cumulative (K13)
  int* pick;                  // i32[rows] out: first feasible node, N where none
  int CN, PW, preds_on, R, Q, N, rows;
};

// a launch's own arguments (union_fit.py's _Call mirrors this layout)
struct Call {
  const void* q;              // i32 or i64 [rows]
  const void* g;              // i32 or i64 [rows]
  const uint8_t* has_grp;     // bool[rows]
  const uint8_t* pop;         // bool[rows]
  const float* req;           // f32[rows, R]
  const int* ctl;             // the optimistic window's ctl, or null
  int q_wide, g_wide;
};

template <int C>
__global__ void __launch_bounds__(THREADS) union_fit_kernel(const Static s, const Call c) {
  __shared__ float req_s[MAX_R];
  __shared__ int ports_s[MAX_PW];
  __shared__ int wmin[2][WARPS];  // a step's warp minima, alternating
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the row's scalars, read together
  const bool popped = (c.pop[r] != 0) & (c.has_grp[r] != 0);
  const int g = kat_read_index(c.g, c.g_wide, r);
  const int qk = kat_read_index(c.q, c.q_wide, r);
  int start = 0, trip = INT_MAX;
  if (c.ctl != nullptr) {
    start = c.ctl[KAT_CTL_START];
    trip = c.ctl[KAT_CTL_TRIP];
  }
  if (!popped || start + r >= trip) {
    if (tid == 0) s.pick[r] = s.N;
    return;
  }
  if (tid < C - 1) req_s[tid] = c.req[(size_t)r * (C - 1) + tid];
  if (s.preds_on && tid < s.PW) ports_s[tid] = s.group_ports[(size_t)g * s.PW + tid];
  const int gk = s.preds_on ? s.group_klass[g] : 0;
  __syncthreads();
  const int Q1 = s.Q + 1;
  for (int base = 0, step = 0; base < s.N; base += TILE, ++step) {
    int node[NPT], lo[NPT], len[NPT], nk[NPT];
    bool ok[NPT], hit[NPT];
    float un[NPT][C], own[NPT][C];
    // the nodes' rows, every load issued before any is used (a node past
    // N reads node N - 1's rows and is screened out); no load below is
    // under a branch, so the NPT nodes' loads overlap at each level
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int n = base + k * THREADS + tid, nc = min(n, s.N - 1);
      node[k] = n;
      lo[k] = s.bstart[nc];
      len[k] = s.bstart[nc + 1];
      nk[k] = s.node_klass[nc];
      ok[k] = (n < s.N) & (s.node_valid[nc] != 0);
      if (s.preds_on)
        ok[k] &= (s.node_unsched[nc] == 0) & (s.node_max_tasks[nc] - s.node_num_tasks[nc] > 0);
#pragma unroll
      for (int cc = 0; cc < C; ++cc) un[k][cc] = s.pn[(size_t)nc * C + cc];
    }
    if (s.preds_on) {
      for (int w = 0; w < s.PW; ++w) {
        const int gw = ports_s[w];
#pragma unroll
        for (int k = 0; k < NPT; ++k)
          ok[k] &= (gw & s.node_ports[(size_t)min(node[k], s.N - 1) * s.PW + w]) == 0;
      }
#pragma unroll
      for (int k = 0; k < NPT; ++k) ok[k] &= s.class_fit[(size_t)gk * s.CN + nk[k]] != 0;
    }
    // the own-queue segment's last slot inside each node's block, the NPT
    // searches in lock step: lo ends one past the last slot whose key is
    // at most the row's; hit: that slot's key equals the row's.  A probe
    // lies in [bstart[n], bstart[n+1]] (the padding keeps it below Vp).
    bool more = false;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      len[k] = ok[k] ? len[k] - lo[k] : 0;
      hit[k] = false;
      more |= len[k] > 0;
    }
    while (more) {
      int m[NPT], v[NPT];
      more = false;
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        m[k] = lo[k] + (len[k] >> 1);
        v[k] = s.skey[m[k]];
      }
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        if (len[k] > 0) {
          const int half = len[k] >> 1;
          if (v[k] <= node[k] * Q1 + qk) {
            lo[k] = m[k] + 1;
            len[k] -= half + 1;
            hit[k] = v[k] == node[k] * Q1 + qk;
          } else {
            len[k] = half;
          }
        }
        more |= len[k] > 0;
      }
    }
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const float* row = s.segcum + (size_t)(hit[k] ? lo[k] - 1 : 0) * C;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) own[k][cc] = row[cc];
    }
    int best = INT_MAX;
#pragma unroll
    for (int k = NPT - 1; k >= 0; --k) {  // the thread's lowest feasible node
      const float cnt = __fsub_rn(un[k][0], hit[k] ? own[k][0] : 0.f);
      bool all_below = true;
#pragma unroll
      for (int cc = 1; cc < C; ++cc)
        all_below &= __fsub_rn(un[k][cc], hit[k] ? own[k][cc] : 0.f) < req_s[cc - 1];
      if (ok[k] && cnt > 0.f && !all_below) best = node[k];
    }
    const int wbest = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) wmin[step & 1][warp] = wbest;
    __syncthreads();
    int found = INT_MAX;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) found = min(found, wmin[step & 1][w]);
    if (found != INT_MAX) {
      if (tid == 0) s.pick[r] = found;
      return;
    }
  }
  if (tid == 0) s.pick[r] = s.N;
}

}  // namespace

extern "C" int kat_union_fit(const void* static_args, const void* call_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Call& c = *static_cast<const Call*>(call_args);
  if (s.R < 1 || s.R > MAX_R || s.PW > MAX_PW || s.PW < 0) return (int)cudaErrorInvalidValue;
  if (s.rows <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (s.R + 1) {
    case 2: union_fit_kernel<2><<<s.rows, THREADS, 0, st>>>(s, c); break;
    case 3: union_fit_kernel<3><<<s.rows, THREADS, 0, st>>>(s, c); break;
    case 4: union_fit_kernel<4><<<s.rows, THREADS, 0, st>>>(s, c); break;
    case 5: union_fit_kernel<5><<<s.rows, THREADS, 0, st>>>(s, c); break;
    case 6: union_fit_kernel<6><<<s.rows, THREADS, 0, st>>>(s, c); break;
    case 7: union_fit_kernel<7><<<s.rows, THREADS, 0, st>>>(s, c); break;
    case 8: union_fit_kernel<8><<<s.rows, THREADS, 0, st>>>(s, c); break;
    default: union_fit_kernel<9><<<s.rows, THREADS, 0, st>>>(s, c); break;
  }
  return (int)cudaGetLastError();
}
