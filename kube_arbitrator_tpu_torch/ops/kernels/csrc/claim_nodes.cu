// K6 claim_nodes: the node half of one preempt turn's claim.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_apply_claim (:439-803),
// the part between the turn's victim mask and the state scatters: the
// per-node victim aggregates (:468-497: the victim count and resreq sums,
// the max / min victim), the claim capacity over them (node_uniform,
// chunk_m, full, partial, cap; :557-603), the int32 prefix cum / fill p
// (:616-618), the preempt budget gate keep (:631-634), the
// covering-prefix evict rule (:640-658) and the freed resources per node
// (:666).
//
// A CTA takes a contiguous run of nodes, 60 at a time (a round; one
// round a CTA at N = 5,120 on 86 CTAs).  First a half-warp a node walks
// the node's panel slots in slot order (the view's node order:
// perm[seg_start[n] .. seg_start[n + 1])), 16 at a time: the slots,
// their victim flags and resreq rows load coalesced (the rows read for
// every slot, so that a node costs three dependent reads: its run, its
// slots, their rows), the ballot of the victims gives the count, and the
// victims' resreq are added one after another in slot order from zero
// (shuffled from their lanes), so the sums equal K4's slot-order sums bit
// for bit (a non-victim would add +0.0, which changes no sum that starts
// at +0.0); max and min take any order.  Then a lane a node turns the
// round's aggregates (in shared memory) into its claim capacity, the
// node's own arrays loaded coalesced across the lanes while the other 30
// warps walk: two warps do the capacity arithmetic (IEEE divides) that
// every half-warp would otherwise repeat, which made the node pass
// issue-bound.
//
// The claim capacity scan is an exact int32 scan: the CTA's sum, and one
// 64-bit word a CTA stamped with the launch's number (seq << 32 | the
// CTA's sum), so no word is reset between launches; every CTA reads every
// word (the grid fits on the card at once: a cooperative launch) for its
// base and the total, which give placed_pre and keep on the device.
// Then, a round at a time, warp 0 fills p in node order (two nodes a
// lane, a warp scan) and a half-warp a node walks its victims again for
// the evict rule and the slot-order freed sums (its first chunk's slots,
// flags and rows still in registers from the walk in a CTA's first
// round, so only the ranks and cumulatives are read then).  No host read; no
// allocation (the plan owns every output and scratch).
//
// Pod affinity (preempt.py:513-516, :604-606): K11's ok mask joins the
// node predicate, and K12 shapes the claim capacity between the capacity
// and the scan.  A turn is then two launches: phase 1 writes the caps
// into p (and the evict rule's per-node values into scratch) and stops;
// K12 shapes p in place; phase 2 scans the shaped caps and runs the fill,
// the evict rule and freed.  Phase 0 is the one launch without pod
// affinity.
//
// The plan (claim_nodes.py's ClaimNodesPlan, bound once per preempt
// round loop) binds the pack's and the view's tensors, K11's plan-owned
// mask and its own outputs once; a launch passes the turn's own pointers
// (g read as i32 or i64).
//
// Bound: bytes — what the function needs: the node arrays read once
// (counts, flags, ports), the panel's victim flags, each victim's node,
// resreq, rank and cumulative, and p, cum, placed, evict and freed written
// once: ~0.41 MB at N = 5,120, P = 51,200 and 1,684 victims (~0.12 us at
// 3.35 TB/s).  The panel's slot order is not counted: within a node the
// view's order is ascending slot order.  This design reads more (every
// slot's order entry, flag and row, and the segment starts).  The floor
// is a half-warp's chain of dependent reads (segment start -> slot ->
// flag and row) twice, and the grid-wide wait for the scan.
//
// Arithmetic mirrors the plain version: IEEE divides, separate roundings
// of products and differences (built with -fmad=false), saturating
// float -> int conversion.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 8;  // claim_nodes.py's MAX_R; R <= 4 runs a narrower build
constexpr int AHEAD = 8;  // CTA words a lane reads at once
constexpr int HALF = 16;  // lanes a node walk
constexpr int CAP_WARPS = 2;  // warps that turn a round's aggregates into capacities
constexpr int WALK_WARPS = WARPS - CAP_WARPS;  // warps that walk the round's nodes
constexpr int ROUND = 2 * WALK_WARPS;  // nodes a CTA takes at once: two a walking warp
constexpr unsigned FULL = 0xffffffffu;
// A spin that outlasts this many polls means a CTA never published:
// trap (a launch error) rather than hang the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

// the plan's fixed arguments (claim_nodes.py's _Static mirrors this layout)
struct Static {
  const uint8_t* class_fit;   // bool[K, CN]
  const int* node_klass;      // i32[N]
  const uint8_t* node_valid;  // bool[N]
  const uint8_t* node_unsched;
  const int* node_max_tasks;  // i32[N]
  const int* group_klass;     // i32[G]
  const int* group_ports;     // i32[G, W]
  const int* perm;            // i32[P] the view's node order: panel slots by node
  const int* seg_start;       // i32[N + 1] a node's run in perm
  const float* vres;          // f32[P, R] the panel's resreq
  const uint8_t* pa_ok;       // bool[N] K11's plan-owned fit, or null
  int* p;                     // i32[N] out: the fill (the claim capacity after phase 1)
  int* cum;                   // i32[N] out: the inclusive claim capacity scan
  int* placed;                // i32[2] out: placed_total, placed_pre
  uint8_t* evict;             // bool[P] out (slots outside every node stay zero)
  float* freed;               // f32[N, R] out: the evicted resreq per node, slot order
  float* full_s;              // f32[N] scratch: full claims
  float* chunk_s;             // f32[N] scratch: victims a claim chunk
  uint8_t* unif_s;            // bool[N] scratch: uniform victims
  int* agg_nv;                // i32[N] out or null: the victims per node
  float* agg_tot;             // f32[N, R] out or null: their resreq sums, slot order
  float* agg_max;             // f32[N, R] out or null: their max (-BIG where none)
  float* agg_min;             // f32[N, R] out or null: their min (BIG where none)
  unsigned long long* words;  // [grid] a CTA's claim capacity: seq << 32 | sum
  int CN, N, R, W, T, s_max, preempt_mode, preds_on, grid;
};

// a launch's own arguments (claim_nodes.py's _Call mirrors this layout)
struct Call {
  const void* g;              // i32 or i64 [1] the claimant group
  const float* req;           // f32[R]
  const int* budget;          // i32[1]
  const uint8_t* has_grp;     // bool[1]
  const uint8_t* was_ready;   // bool[1]
  const int* need;            // i32[1]
  const uint8_t* victims;     // bool[P] this turn's victims
  const int* node_rank;       // i32[P] in-(node, queue) exclusive victim rank
  const float* node_cum;      // f32[P, R] in-(node, queue) inclusive victim cum
  const int* node_ports;      // i32[N, W]
  const int* node_num_tasks;  // i32[N]
  int g_wide, phase;
  unsigned seq;
};

// The turn's values every warp reads (MR: the resources a build holds).
template <int MR>
struct Turn {
  float req[MR];
  int klass;
  const int* gports;
};

// One chunk of a node's run: lane's slot (-1 past the run), its victim
// flag and resreq row (read for every slot, so that the row's load does
// not wait for the flag's).
template <int MR>
struct Lane {
  int slot;
  bool victim;
  float x[MR];
};

template <int MR>
__device__ __forceinline__ Lane<MR> load_lane(const Static& s, const Call& c, int i, int end) {
  Lane<MR> l;
  l.slot = i < end ? s.perm[i] : -1;
  l.victim = l.slot >= 0 && c.victims[l.slot] != 0;
#pragma unroll
  for (int r = 0; r < MR; ++r) l.x[r] = l.slot >= 0 && r < s.R ? s.vres[(size_t)l.slot * s.R + r] : 0.f;
  return l;
}

// A round's nodes' victim aggregates, between the half-warps that walk
// the nodes and the lanes that turn them into claim capacities.
template <int MR>
struct Aggs {
  int nv[ROUND];
  float tf[MR][ROUND], vx[MR][ROUND], vn[MR][ROUND];
};

// Node n's victims in slot order, by one half-warp (lanes hbase ..
// hbase + 15 of mask hmask, sub the lane's place in it): the count, the
// resreq sums, max and min, into the round's aggregates at li; returns
// the lane's first chunk, which the evict rule reads again.
template <int MR>
__device__ __forceinline__ Lane<MR> walk_node(const Static& s, const Call& c, int n, int li,
                                              int sub, unsigned hmask, int hbase, Aggs<MR>& a) {
  const int R = s.R;
  const int b0 = s.seg_start[n], b1 = s.seg_start[n + 1];
  float tf[MR], vx[MR], vn[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    tf[r] = 0.f;
    vx[r] = -KAT_BIG;
    vn[r] = KAT_BIG;
  }
  int nv = 0;
  Lane<MR> first;
  first.slot = -1;
  for (int base = b0; base < b1; base += HALF) {
    const Lane<MR> l = load_lane<MR>(s, c, base + sub, b1);
    if (base == b0) first = l;
    const unsigned m = __ballot_sync(hmask, l.victim) >> hbase;
    nv += __popc(m);
    // the victims one after another in slot order (lane order is slot order)
    for (unsigned mm = m; mm != 0; mm &= mm - 1) {
      const int b = __ffs(mm) - 1;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= R) break;
        const float v = __shfl_sync(hmask, l.x[r], hbase + b);
        tf[r] = __fadd_rn(tf[r], v);
        vx[r] = fmaxf(vx[r], v);
        vn[r] = fminf(vn[r], v);
      }
    }
  }
  if (sub == 0) {
    a.nv[li] = nv;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      a.tf[r][li] = tf[r];
      a.vx[r][li] = vx[r];
      a.vn[r][li] = vn[r];
    }
  }
  return first;
}

// A node's own values for its claim capacity, loaded by the lane that
// computes it before the round's walk, so their reads overlap it.
struct NodeVals {
  bool ok;         // valid, schedulable, of a class the claimant fits, ports free, K11's fit
  bool has_ports;  // the claimant holds a host port (one claim a node)
  int pods_head;   // pods the node can still take
};

__device__ __forceinline__ NodeVals load_node(const Static& s, const Call& c, int klass,
                                              const int* gports, int n) {
  // every read issued before any is tested
  const bool valid = s.node_valid[n] != 0;
  const bool fit = s.pa_ok == nullptr || s.pa_ok[n] != 0;
  NodeVals v;
  v.pods_head = s.s_max;
  v.ok = valid && fit;
  v.has_ports = false;
  if (s.preds_on) {
    for (int w = 0; w < s.W; ++w) v.has_ports |= gports[w] != 0;
    const int max_tasks = s.node_max_tasks[n], num_tasks = c.node_num_tasks[n];
    const bool sched = s.node_unsched[n] == 0;
    const bool klass_ok = s.class_fit[(size_t)klass * s.CN + s.node_klass[n]] != 0;
    bool ports_ok = true;
    for (int w = 0; w < s.W; ++w) ports_ok &= (gports[w] & c.node_ports[(size_t)n * s.W + w]) == 0;
    v.pods_head = max_tasks - num_tasks;
    v.ok = v.ok && klass_ok && sched && ports_ok && v.pods_head > 0;
  }
  return v;
}

// Node n's claim capacity (preempt.py:468-603) from its values and the
// round's aggregates at li, by one lane (the node's own arrays load
// coalesced across the lanes); writes the evict rule's per-node values to
// scratch, and the aggregates when the plan keeps them.
template <int MR>
__device__ __forceinline__ int node_cap(const Static& s, const Turn<MR>& u, const NodeVals& nd,
                                        int n, int li, const Aggs<MR>& a) {
  const int R = s.R;
  const int nv = a.nv[li];
  float tf[MR], vx[MR], vn[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    tf[r] = a.tf[r][li];
    vx[r] = a.vx[r][li];
    vn[r] = a.vn[r][li];
  }
  const bool ok = nd.ok && nv > 0;
  const int pods_head = nd.pods_head;
  const float nvf = __int2float_rn(nv);
  bool all_below = true, uniform = nv > 0;
  float per_min = KAT_BIG, chunk = -KAT_BIG;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= R) break;
    const float q = u.req[r];
    all_below &= tf[r] < q;
    uniform &= __fsub_rn(vx[r], vn[r]) <= KAT_EPS;
    per_min = fminf(per_min, q > 0.f ? __fdiv_rn(__fadd_rn(tf[r], KAT_EPS), fmaxf(q, 1e-30f)) : KAT_BIG);
    float mch = q > 0.f ? ceilf(__fdiv_rn(__fsub_rn(q, KAT_EPS), fmaxf(vx[r], 1e-30f))) : 1.f;
    if (q > 0.f && vx[r] <= KAT_EPS) mch = KAT_BIG;
    chunk = fmaxf(chunk, mch);
  }
  const bool weak_ok = !all_below;
  chunk = fmaxf(chunk, 1.f);
  const float full_mixed = fmaxf(floorf(per_min), 0.f);
  const float full_uniform = floorf(__fdiv_rn(nvf, chunk));
  const float full = fminf(uniform ? full_uniform : full_mixed, __int2float_rn(s.s_max));
  const float used = __fmul_rn(full, chunk);
  bool rem_below = true, partial_mixed = false;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= R) break;
    const float q = u.req[r];
    const float rem_mixed = fmaxf(__fsub_rn(tf[r], __fmul_rn(full, q)), 0.f);
    const float rem_uniform = __fmul_rn(fmaxf(__fsub_rn(nvf, used), 0.f), vx[r]);
    rem_below &= (uniform ? rem_uniform : rem_mixed) < q;
    partial_mixed |= q > 0.f && rem_mixed > KAT_EPS;
  }
  const bool partial_uniform = nvf > used;
  const bool partial = ((uniform ? partial_uniform : partial_mixed) && !rem_below) || full < 1.f;
  float cap = fminf(__fadd_rn(full, partial ? 1.f : 0.f), nvf);
  cap = fminf(cap, __int2float_rn(pods_head));
  if (nd.has_ports) cap = fminf(cap, 1.f);
  if (!(ok && weak_ok)) cap = 0.f;
  cap = fmaxf(cap, 0.f);
  s.full_s[n] = full;
  s.chunk_s[n] = chunk;
  s.unif_s[n] = uniform ? 1 : 0;
  if (s.agg_nv != nullptr) {
    s.agg_nv[n] = nv;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= R) break;
      s.agg_tot[(size_t)n * R + r] = tf[r];
      s.agg_max[(size_t)n * R + r] = vx[r];
      s.agg_min[(size_t)n * R + r] = vn[r];
    }
  }
  return __float2int_rz(cap);
}

// The evict rule over node n's victims (preempt.py:640-658) at fill p,
// and the node's freed resreq in slot order, by one half-warp (as
// walk_node; kept: its first chunk is the walk's, still in first).
template <int MR>
__device__ __forceinline__ void node_evict(const Static& s, const Call& c, const Turn<MR>& u, int n,
                                           int p, int sub, unsigned hmask, int hbase,
                                           bool kept, const Lane<MR>& first) {
  const int R = s.R;
  const int b0 = s.seg_start[n], b1 = s.seg_start[n + 1];
  const float full = s.full_s[n], chunk = s.chunk_s[n];
  const bool uniform = s.unif_s[n] != 0;
  const bool use_partial = p > __float2int_rz(full);
  const float pf = __int2float_rn(p);
  const float rank_needed = use_partial ? __int2float_rn(s.T) : __fmul_rn(pf, chunk);
  float fr[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) fr[r] = 0.f;
  for (int base = b0; base < b1; base += HALF) {
    const Lane<MR> l = kept && base == b0 ? first : load_lane<MR>(s, c, base + sub, b1);
    // the rank and cumulative read for every slot, beside the flag
    const int rank = l.slot >= 0 ? c.node_rank[l.slot] : 0;
    float cum[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r)
      cum[r] = l.slot >= 0 && r < R ? c.node_cum[(size_t)l.slot * R + r] : 0.f;
    bool ev = false;
    if (l.victim && p > 0) {
      if (uniform) {
        ev = __int2float_rn(rank) < rank_needed;
      } else {
        ev = rank < p;
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r >= R) break;
          const float needed = use_partial ? KAT_BIG : __fsub_rn(__fmul_rn(pf, u.req[r]), KAT_EPS);
          ev |= __fsub_rn(cum[r], l.x[r]) < needed;
        }
      }
    }
    if (l.slot >= 0) s.evict[l.slot] = ev ? 1 : 0;
    for (unsigned mm = __ballot_sync(hmask, ev) >> hbase; mm != 0; mm &= mm - 1) {
      const int b = __ffs(mm) - 1;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= R) break;
        fr[r] = __fadd_rn(fr[r], __shfl_sync(hmask, l.x[r], hbase + b));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r < R && sub == r) s.freed[(size_t)n * R + r] = fr[r];
  }
}

__device__ __forceinline__ int await_sum(const unsigned long long* w, unsigned seq) {
  unsigned long long x = __ldcv(w);
  for (unsigned spin = 0; (unsigned)(x >> 32) != seq; ++spin) {
    if (spin > SPIN_LIMIT) __trap();
    __nanosleep(32);
    x = __ldcv(w);
  }
  return (int)(unsigned)x;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The block's sum of v, in every thread (one barrier; red is not read
// again after it).
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) all += red[w];
  return all;
}

template <int MR>
__global__ void __launch_bounds__(THREADS) claim_nodes_kernel(const Static s, const Call c) {
  __shared__ Aggs<MR> aggs;
  __shared__ int red[WARPS];
  __shared__ int fill[ROUND];
  __shared__ int cta_base, cta_total, round_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = kat_read_index(c.g, c.g_wide);
  Turn<MR> u;
#pragma unroll
  for (int r = 0; r < MR; ++r) u.req[r] = r < s.R ? c.req[r] : 0.f;
  u.klass = s.preds_on ? s.group_klass[g] : 0;
  u.gports = s.group_ports + (size_t)g * s.W;
  // this CTA's run of nodes (balanced splits), taken ROUND nodes a round:
  // a half-warp of the walking warps walks each node's slots while the
  // capacity warps load the nodes' own values, then a lane of those each
  // node's capacity
  const int lo = (int)(blockIdx.x * (unsigned)s.N / (unsigned)s.grid);
  const int hi = (int)((blockIdx.x + 1) * (unsigned)s.N / (unsigned)s.grid);
  const int half = lane / HALF, sub = lane % HALF, hbase = half * HALF;
  const unsigned hmask = 0xffffu << hbase;
  const int li = warp < WALK_WARPS ? 2 * warp + half : ROUND;  // the node a half-warp walks
  const int ci = tid - WALK_WARPS * 32;  // the node a capacity lane computes (if >= 0)
  Lane<MR> first;  // the walk's first chunk of node lo + li (the first round)

  int mine = 0;
  if (c.phase != 2) {
    for (int r0 = lo; r0 < hi; r0 += ROUND) {
      const int rcnt = min(ROUND, hi - r0);
      NodeVals nd;
      if (ci >= 0 && ci < rcnt) nd = load_node(s, c, u.klass, u.gports, r0 + ci);
      if (li < rcnt) {
        const Lane<MR> l = walk_node<MR>(s, c, r0 + li, li, sub, hmask, hbase, aggs);
        if (r0 == lo) first = l;
      }
      __syncthreads();
      if (ci >= 0 && ci < rcnt) {
        const int cap = node_cap<MR>(s, u, nd, r0 + ci, ci, aggs);
        s.p[r0 + ci] = cap;  // the claim capacity until the fill
        mine += cap;
      }
      if (r0 + ROUND < hi) __syncthreads();  // the aggregates are free for the next round
    }
    if (c.phase == 1) return;  // the caps go to K12
  } else {
    for (int n = lo + tid; n < hi; n += THREADS) mine += s.p[n];  // K12's shaped caps
  }
  mine = block_sum(mine, red);

  // ---- the scan across the grid: a word a CTA, every CTA reads them all
  if (warp == 0) {
    if (lane == 0) {
      atomicExch(s.words + blockIdx.x, ((unsigned long long)c.seq << 32) | (unsigned)mine);
    }
    // AHEAD loads a lane in flight at once
    int before = 0, all = 0;
    for (int b0 = lane; b0 < s.grid; b0 += 32 * AHEAD) {
      unsigned long long x[AHEAD];
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        const int b = b0 + 32 * a;
        x[a] = b < s.grid && b != (int)blockIdx.x ? __ldcv(s.words + b) : 0ull;
      }
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) {
        const int b = b0 + 32 * a;
        if (b >= s.grid) break;
        const int w = b == (int)blockIdx.x ? mine
                      : (unsigned)(x[a] >> 32) == c.seq ? (int)(unsigned)x[a]
                                                        : await_sum(s.words + b, c.seq);
        all += w;
        if (b < (int)blockIdx.x) before += w;
      }
    }
    before = warp_sum(before);
    all = warp_sum(all);
    if (lane == 0) {
      cta_base = before;
      cta_total = all;
    }
  }
  __syncthreads();
  const int budget = *c.budget;
  const int placed_pre = min(budget, cta_total);
  bool keep = true;
  if (s.preempt_mode) {
    keep = !(*c.has_grp && !*c.was_ready && placed_pre < budget && placed_pre < *c.need);
  }
  if (blockIdx.x == 0 && tid == 0) {
    s.placed[0] = keep ? placed_pre : 0;
    s.placed[1] = placed_pre;
  }

  // ---- the fill in node order (warp 0, two nodes a lane), then the
  // evict rule and freed (a half-warp a node), a round at a time
  int run = cta_base;
  for (int r0 = lo; r0 < hi; r0 += ROUND) {
    const int rcnt = min(ROUND, hi - r0);
    if (warp == 0) {
      const int l0 = 2 * lane, l1 = l0 + 1;
      const int c0 = l0 < rcnt ? s.p[r0 + l0] : 0, c1 = l1 < rcnt ? s.p[r0 + l1] : 0;
      int incl = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int before0 = run + incl - c0 - c1, before1 = before0 + c0;
      if (l0 < rcnt) {
        const int p = keep ? min(max(placed_pre - before0, 0), c0) : 0;
        s.cum[r0 + l0] = before0 + c0;
        s.p[r0 + l0] = p;
        fill[l0] = p;
      }
      if (l1 < rcnt) {
        const int p = keep ? min(max(placed_pre - before1, 0), c1) : 0;
        s.cum[r0 + l1] = before1 + c1;
        s.p[r0 + l1] = p;
        fill[l1] = p;
      }
      if (lane == 31) round_total = incl;
    }
    __syncthreads();
    run += round_total;
    if (li < rcnt) {
      node_evict<MR>(s, c, u, r0 + li, fill[li], sub, hmask, hbase, c.phase == 0 && r0 == lo,
                     first);
    }
    if (r0 + ROUND < hi) __syncthreads();  // fill and round_total are free for the next round
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  }
  return sms;
}

}  // namespace

// The grid of a plan's launches over N nodes of R resources (0 on error):
// two nodes a warp where the card holds that many CTAs at once, fewer
// (more nodes a warp) past it.
extern "C" int kat_claim_nodes_grid(int N, int R) {
  static int per_sm[2] = {0, 0};
  const int wide = R > 4;
  if (per_sm[wide] == 0) {
    const cudaError_t e = wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &per_sm[1], claim_nodes_kernel<MAX_R>, THREADS, 0)
                               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &per_sm[0], claim_nodes_kernel<4>, THREADS, 0);
    if (e != cudaSuccess) return 0;
  }
  const int cap = per_sm[wide] * sm_count();
  if (cap <= 0 || N <= 0 || R < 1 || R > MAX_R) return 0;
  const int want = (N + ROUND - 1) / ROUND;  // one round a CTA
  return want < cap ? want : cap;
}

extern "C" int kat_claim_nodes(const void* static_args, const void* call_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Call& c = *static_cast<const Call*>(call_args);
  if (s.N <= 0 || s.R < 1 || s.R > MAX_R || s.grid < 1 || s.grid > s.N ||
      (long long)s.grid * s.N >= (1LL << 32) || c.phase < 0 || c.phase > 2 || c.seq == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void* fn = s.R > 4 ? (const void*)claim_nodes_kernel<MAX_R> : (const void*)claim_nodes_kernel<4>;
  void* args[] = {const_cast<Static*>(&s), const_cast<Call*>(&c)};
  // phase 1 waits on no other CTA, but launches the same way
  const cudaError_t e =
      cudaLaunchCooperativeKernel(fn, dim3(s.grid), dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
