// K7 canon_pick: one reclaim turn's victim sums per node and its
// first-fit node.
//
// Replaces, per turn of kube_arbitrator_tpu/ops/preempt.py:_reclaim_canon
// (:2331-2335), _canon_elig (:2012), the own-queue exclusion,
// _canon_per_node (:2035) and the first-fit pick of _canon_fit_commit
// (_fit_feasible :2058, :2104-2108).  The canon pack keeps each node's
// candidates in one contiguous block rv_block_start[n]..[n+1].
//
// A warp a node, at most two CTAs of 8 warps an SM, each warp striding
// over the nodes in ascending order:
// * the node screens of _fit_feasible (predicate class, cordon, pod
//   headroom), their loads issued together, the host-port words spread
//   over the lanes and joined by a warp vote; a node that fails them
//   reads nothing more;
// * the block in tiles of 32 slots: lane i evaluates slot i's eligibility
//   and the own-queue exclusion, a ballot counts the tile's victims, and
//   the tile's resreq rows are staged in shared memory by a coalesced
//   load (the tile's R * 32 floats are contiguous in cres; a tile with no
//   victim loads nothing); lane r < R then adds column r of the eligible
//   rows in slot order, over the set bits of the ballot — the reference's
//   scatter order, no tree and no float atomics, so the fit screen
//   all(res < req) compares the same bits as the plain version's (the
//   zeros the plain version adds for ineligible slots leave a
//   non-negative sum unchanged).  A block longer than 32 slots carries
//   the sums from tile to tile;
// * the weak validateVictims screen (not every resource strictly below
//   the request) and at least one victim;
// * the first feasible node: a warp that finds one publishes it with an
//   integer atomicMin into this launch's pick word and stops (its later
//   nodes are larger); every warp reads the running minimum before each
//   node and stops once it is past it.  The minimum is the pick, N when
//   no node is feasible.  The plan owns two pick words and alternates
//   them: the word a launch minimises into was armed to N by the launch
//   before it, and the launch re-arms the other word (the previous pick,
//   which its caller's K8 consumed before, in stream order), so there is
//   no fill, no ticket and no last CTA.
//
// The plan (canon_pick.py's CanonPickPlan) binds the canon context, the
// carried scans, the job and queue state, the node screens and the
// pick words once per _reclaim_canon call: a launch passes only a Turn —
// the word parity and the turn's q and g (i32 or i64, read as either),
// has_grp, pop and req — set in place in a struct the plan owns.
//
// Bound: bytes — the canon arrays read once (cand, ranks, F-wide
// cumulatives and deserved, R-wide resreq, job and queue ordinals) plus
// the node screens: ~1.6 MB at Vp = 25,600, N = 5,120 (~0.5 us at
// 3.35 TB/s).
#include "canon.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CTAS_PER_SM = 2;  // at most this many CTAs an SM; warps stride over the nodes

// the plan's fixed arguments (canon_pick.py's _Static mirrors this layout)
struct Static {
  const uint8_t* cand;
  const float* rank_nj;
  const float* cum_nq;
  const int* cj;
  const int* cq;
  const float* deserved_c;
  const int* job_ready_cnt;
  const int* min_avail;
  const float* queue_alloc;
  const int* bstart;
  const float* cres;
  const uint8_t* class_fit;
  const int* node_klass;
  const uint8_t* node_valid;
  const uint8_t* node_unsched;
  const int* node_max_tasks;
  const int* node_num_tasks;
  const int* node_ports;
  const int* group_klass;
  const int* group_ports;
  int* picks;  // [2] out, alternating: launch k's running minimum (then its pick) in
               // picks[k % 2], armed to N; launch k re-arms picks[(k + 1) % 2]
  int R, F, use_gang, use_prop, CN, N, PW, preds_on;
};

// a launch's own arguments (canon_pick.py's _Turn mirrors this layout)
struct Turn {
  const void* q;         // i32 or i64 [1] the turn's queue
  const void* g;         // i32 or i64 [1] the turn's group
  const uint8_t* has_grp;
  const uint8_t* pop;
  const float* req;      // f32[R]
  int q_wide, g_wide, parity;
};

// the claim's feasibility on node n (warp-uniform), or false at once
// when a feasible node at or below n is known already (*stop set).  The
// node's own reads (block bounds, screens) are issued before the
// running minimum is tested and before anything that depends on the
// turn's group, so they overlap.
__device__ bool feasible(const Static& s, const CanonElig& e, int q, int g, int gk, int n,
                         int lane, const float* __restrict__ req, float* rows, int* best,
                         bool* stop) {
  const int b0 = s.bstart[n], b1 = s.bstart[n + 1];
  const int nk = s.node_klass[n];
  const bool valid = s.node_valid[n] != 0;
  const bool base = valid & (s.node_unsched[n] == 0) &
                    (s.node_max_tasks[n] - s.node_num_tasks[n] > 0);
  const int found = __shfl_sync(0xffffffffu, __ldcv(best), 0);
  if (found <= n) {
    *stop = true;
    return false;
  }
  if (s.preds_on) {
    bool clash = false;
    for (int w = lane; w < s.PW; w += 32)
      clash |= (s.group_ports[(size_t)g * s.PW + w] & s.node_ports[(size_t)n * s.PW + w]) != 0;
    clash = __any_sync(0xffffffffu, clash);
    if (!base || clash || s.class_fit[(size_t)gk * s.CN + nk] == 0) return false;
  } else if (!valid) {
    return false;
  }
  const int R = s.R;
  float acc = 0.f;  // lane r < R: column r's sum
  int cnt = 0;
  for (int t0 = b0; t0 < b1; t0 += 32) {
    const int m = min(32, b1 - t0);
    // the tile's rows are staged while the eligibility is read, not after
    const float* src = s.cres + (size_t)t0 * R;
    for (int k = lane; k < m * R; k += 32) rows[k] = src[k];
    const bool el = lane < m && kat_canon_victim(e, t0 + lane, q);
    const unsigned bits = __ballot_sync(0xffffffffu, el);
    if (bits == 0u) continue;
    cnt += __popc(bits);
    __syncwarp();
    if (lane < R) {
      for (unsigned b = bits; b != 0u; b &= b - 1u)
        acc = __fadd_rn(acc, rows[(__ffs((int)b) - 1) * R + lane]);
    }
    __syncwarp();
  }
  const bool below = lane < R ? acc < req[lane] : true;
  return cnt > 0 && !__all_sync(0xffffffffu, below);
}

__global__ void __launch_bounds__(THREADS) canon_pick_kernel(Static s, Turn t) {
  extern __shared__ float stage[];  // per warp: a tile's [32][R] resreq rows
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const float* __restrict__ req = t.req;
  int* best = s.picks + t.parity;
  // the previous launch's pick (consumed by then, in stream order) is
  // re-armed for the next launch
  if (blockIdx.x == 0 && threadIdx.x == 0) s.picks[t.parity ^ 1] = s.N;
  // the turn's scalars, read together
  const bool go = (*t.pop != 0) & (*t.has_grp != 0);
  const int q = kat_read_index(t.q, t.q_wide), g = kat_read_index(t.g, t.g_wide);
  const int gk = s.group_klass[g];
  const CanonElig e{s.cand, s.rank_nj, s.cum_nq, s.cj, s.cq, s.deserved_c, s.job_ready_cnt,
                    s.min_avail, s.queue_alloc, s.R, s.F, s.use_gang != 0, s.use_prop != 0};
  float* rows = stage + (size_t)wib * 32 * s.R;
  // a warp's nodes in ascending order: past its first feasible node, or
  // past a smaller feasible node another warp found, none can win
  bool stop = !go;
  for (int n = blockIdx.x * WARPS + wib; n < s.N && !stop; n += gridDim.x * WARPS) {
    if (feasible(s, e, q, g, gk, n, lane, req, rows, best, &stop)) {
      if (lane == 0) atomicMin(best, n);
      break;
    }
  }
}

}  // namespace

extern "C" int kat_canon_pick(const void* static_args, const void* turn_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  Turn t = *static_cast<const Turn*>(turn_args);
  t.parity &= 1;
  if (s.R > 32 || s.R < 1) return (int)cudaErrorInvalidValue;
  static int sms = 0;  // read once a process
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = (size_t)WARPS * 32 * s.R * sizeof(float);
  const int blocks = max(min((s.N + WARPS - 1) / WARPS, CTAS_PER_SM * sms), 1);
  canon_pick_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(s, t);
  return (int)cudaGetLastError();
}
