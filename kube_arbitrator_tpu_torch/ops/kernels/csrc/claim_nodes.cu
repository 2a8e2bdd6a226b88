// K6 claim_nodes: the node half of one preempt turn's claim.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_apply_claim (:439-803),
// the part between the per-node victim aggregates and the state
// scatters: per-node claim capacity over the victim set (node_uniform,
// chunk_m, full, partial, cap; :557-603), the int32 prefix cum / fill p
// (:616-618), the preempt budget gate keep (:631-634) and, in a second
// pass over the victim panel, the covering-prefix evict rule (:640-658).
// The aggregates come in from the wrapper: node_victims and totfree
// summed by K4 in slot order, vmax / vmin by an order-free max / min.
//
// One block.  Pass 1: each thread owns a contiguous run of nodes (as K1
// does), computes cap per node, and a block int32 scan of the thread sums
// gives cum in node order, exactly.  The per-node full / chunk_m /
// uniform values go to scratch for pass 2.  placed_total and keep are
// read on the device: the turn needs no host sync.  Pass 2: one thread
// per victim slot, strided.
//
// Bound: bytes — the node arrays read once (R f32 of totfree, vmax and
// vmin, W i32 of ports, three i32 counts per node) and cum / p written,
// plus the panel's victims, nodes, ranks and R-wide cumulatives read and
// evict written: ~0.9 MB at N = 5,120, P = 6,400 (~0.3 us at 3.35 TB/s).
// One block is the floor here: three block-wide passes and barriers.
//
// Arithmetic mirrors the plain version: IEEE divides, separate roundings
// of products and differences (built with -fmad=false), saturating
// float -> int conversion.
//
// Pod affinity (preempt.py:513-516, :604-606): the fit's ok mask joins
// the node predicate, and K12 shapes the claim capacity between the
// capacity and the scan.  The kernel then runs twice: phase 1 writes the
// caps (and the pass-2 scratch) and stops; K12 shapes them; phase 2 takes
// the shaped caps in and runs the scan, the fill and the evict rule.
// Phase 0 is the fused launch without pod affinity.
#include "common.cuh"

namespace {

struct Claim {
  const float* req;
  int R, W, N, s_max;
  bool preds_on;
  bool has_ports;
  const uint8_t* pa_ok;  // K11's mask, or nullptr
  int klass;
  const int* gports;
};

// Per-node claim capacity (preempt.py:498-603); writes the values pass 2
// reads to scratch.
__device__ int node_cap(const Claim& c, int n, const int* node_victims,
                        const float* totfree, const float* vmax, const float* vmin,
                        const uint8_t* class_fit, int CN, const int* node_klass,
                        const uint8_t* node_valid, const uint8_t* node_unsched,
                        const int* node_max_tasks, const int* node_ports,
                        const int* node_num_tasks, float* full_s, float* chunk_s,
                        uint8_t* unif_s) {
  const int R = c.R;
  const int nv = node_victims[n];
  const float nvf = __int2float_rn(nv);
  const float* tf = totfree + (size_t)n * R;
  const float* vx = vmax + (size_t)n * R;
  const float* vn = vmin + (size_t)n * R;
  int pods_head;
  bool ok;
  if (c.preds_on) {
    bool ports_ok = true;
    for (int w = 0; w < c.W; ++w) ports_ok &= (c.gports[w] & node_ports[(size_t)n * c.W + w]) == 0;
    pods_head = node_max_tasks[n] - node_num_tasks[n];
    ok = class_fit[(size_t)c.klass * CN + node_klass[n]] != 0 && node_valid[n] != 0 &&
         node_unsched[n] == 0 && ports_ok && pods_head > 0;
  } else {
    pods_head = c.s_max;
    ok = node_valid[n] != 0;
  }
  if (c.pa_ok) ok = ok && c.pa_ok[n] != 0;
  ok = ok && nv > 0;
  bool all_below = true, uniform = nv > 0;
  float per_min = KAT_BIG, chunk = -KAT_BIG;
  for (int r = 0; r < R; ++r) {
    const float q = c.req[r];
    all_below &= tf[r] < q;
    uniform &= __fsub_rn(vx[r], vn[r]) <= KAT_EPS;
    per_min = fminf(per_min, q > 0.f ? __fdiv_rn(__fadd_rn(tf[r], KAT_EPS), fmaxf(q, 1e-30f)) : KAT_BIG);
    float m = q > 0.f ? ceilf(__fdiv_rn(__fsub_rn(q, KAT_EPS), fmaxf(vx[r], 1e-30f))) : 1.f;
    if (q > 0.f && vx[r] <= KAT_EPS) m = KAT_BIG;
    chunk = fmaxf(chunk, m);
  }
  const bool weak_ok = !all_below;
  chunk = fmaxf(chunk, 1.f);
  const float full_mixed = fmaxf(floorf(per_min), 0.f);
  const float full_uniform = floorf(__fdiv_rn(nvf, chunk));
  const float full = fminf(uniform ? full_uniform : full_mixed, __int2float_rn(c.s_max));
  const float used = __fmul_rn(full, chunk);
  bool rem_below = true, partial_mixed = false;
  for (int r = 0; r < R; ++r) {
    const float q = c.req[r];
    const float rem_mixed = fmaxf(__fsub_rn(tf[r], __fmul_rn(full, q)), 0.f);
    const float rem_uniform = __fmul_rn(fmaxf(__fsub_rn(nvf, used), 0.f), vx[r]);
    rem_below &= (uniform ? rem_uniform : rem_mixed) < q;
    partial_mixed |= q > 0.f && rem_mixed > KAT_EPS;
  }
  const bool partial_uniform = nvf > used;
  const bool partial = ((uniform ? partial_uniform : partial_mixed) && !rem_below) || full < 1.f;
  float cap = fminf(__fadd_rn(full, partial ? 1.f : 0.f), nvf);
  cap = fminf(cap, __int2float_rn(pods_head));
  if (c.has_ports) cap = fminf(cap, 1.f);
  if (!(ok && weak_ok)) cap = 0.f;
  cap = fmaxf(cap, 0.f);
  full_s[n] = full;
  chunk_s[n] = chunk;
  unif_s[n] = uniform ? 1 : 0;
  return __float2int_rz(cap);
}

__global__ void __launch_bounds__(1024) claim_nodes_kernel(
    const int* __restrict__ g_p, const float* __restrict__ req,
    const int* __restrict__ budget_p, const uint8_t* __restrict__ has_grp_p,
    const uint8_t* __restrict__ was_ready_p, const int* __restrict__ need_p,
    const int* __restrict__ node_victims, const float* __restrict__ totfree,
    const float* __restrict__ vmax, const float* __restrict__ vmin,
    const uint8_t* __restrict__ class_fit, int CN, const int* __restrict__ node_klass,
    const uint8_t* __restrict__ node_valid, const uint8_t* __restrict__ node_unsched,
    const int* __restrict__ node_max_tasks, const int* __restrict__ node_ports,
    const int* __restrict__ node_num_tasks, const int* __restrict__ group_klass,
    const int* __restrict__ group_ports, const uint8_t* __restrict__ victims,
    const int* __restrict__ vnode, const float* __restrict__ vres,
    const int* __restrict__ node_rank, const float* __restrict__ node_cum, int P,
    int N, int R, int W, int s_max, int T, int preempt_mode, int preds_on,
    const uint8_t* __restrict__ pa_ok, const int* __restrict__ cap_in, int phase,
    float* __restrict__ full_s, float* __restrict__ chunk_s, uint8_t* __restrict__ unif_s,
    int* __restrict__ p_out, int* __restrict__ cum_out, int* __restrict__ placed_out,
    uint8_t* __restrict__ evict_out) {
  Claim c;
  const int g = *g_p;
  c.req = req;
  c.R = R;
  c.W = W;
  c.N = N;
  c.s_max = s_max;
  c.preds_on = preds_on != 0;
  c.pa_ok = pa_ok;
  c.klass = group_klass[g];
  c.gports = group_ports + (size_t)g * W;
  c.has_ports = false;
  if (c.preds_on) {
    for (int w = 0; w < W; ++w) c.has_ports |= c.gports[w] != 0;
  }
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, N);
  const int hi = min(lo + per, N);
  int tsum = 0;
  for (int n = lo; n < hi; ++n) {
    const int cap = phase == 2 ? cap_in[n]
                               : node_cap(c, n, node_victims, totfree, vmax, vmin, class_fit, CN,
                                          node_klass, node_valid, node_unsched, node_max_tasks,
                                          node_ports, node_num_tasks, full_s, chunk_s, unif_s);
    p_out[n] = cap;  // cap until pass 1 ends
    tsum += cap;
  }
  if (phase == 1) return;  // the caps go to K12
  int total;
  int run = kat_block_excl_scan(tsum, &total);
  const int budget = *budget_p;
  const int placed_pre = min(budget, total);
  bool keep = true;
  if (preempt_mode) {
    keep = !(*has_grp_p && !*was_ready_p && placed_pre < budget && placed_pre < *need_p);
  }
  for (int n = lo; n < hi; ++n) {
    const int cap = p_out[n];
    const int cum = run + cap;
    cum_out[n] = cum;
    p_out[n] = keep ? min(max(placed_pre - run, 0), cap) : 0;
    run = cum;
  }
  if (threadIdx.x == 0) {
    placed_out[0] = keep ? placed_pre : 0;
    placed_out[1] = placed_pre;
  }
  __syncthreads();  // p, full, chunk and uniform of every node are visible

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    bool ev = false;
    if (victims[i]) {
      const int n = vnode[i];
      const int p = p_out[n];
      if (p > 0) {
        const bool use_partial = p > __float2int_rz(full_s[n]);
        const float pf = __int2float_rn(p);
        if (unif_s[n]) {
          const float rank_needed = use_partial ? __int2float_rn(T) : __fmul_rn(pf, chunk_s[n]);
          ev = __int2float_rn(node_rank[i]) < rank_needed;
        } else {
          ev = node_rank[i] < p;
          for (int r = 0; r < R; ++r) {
            const float needed = use_partial ? KAT_BIG : __fsub_rn(__fmul_rn(pf, req[r]), KAT_EPS);
            ev |= __fsub_rn(node_cum[(size_t)i * R + r], vres[(size_t)i * R + r]) < needed;
          }
        }
      }
    }
    evict_out[i] = ev ? 1 : 0;
  }
}

}  // namespace

extern "C" int kat_claim_nodes(
    const int* g, const float* req, const int* budget, const uint8_t* has_grp,
    const uint8_t* was_ready, const int* need, const int* node_victims,
    const float* totfree, const float* vmax, const float* vmin,
    const uint8_t* class_fit, int CN, const int* node_klass,
    const uint8_t* node_valid, const uint8_t* node_unsched,
    const int* node_max_tasks, const int* node_ports, const int* node_num_tasks,
    const int* group_klass, const int* group_ports, const uint8_t* victims,
    const int* vnode, const float* vres, const int* node_rank,
    const float* node_cum, int P, int N, int R, int W, int s_max, int T,
    int preempt_mode, int preds_on, const uint8_t* pa_ok, const int* cap_in,
    int phase, float* full_s, float* chunk_s,
    uint8_t* unif_s, int* p_out, int* cum_out, int* placed_out,
    uint8_t* evict_out, void* stream) {
  claim_nodes_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      g, req, budget, has_grp, was_ready, need, node_victims, totfree, vmax,
      vmin, class_fit, CN, node_klass, node_valid, node_unsched,
      node_max_tasks, node_ports, node_num_tasks, group_klass, group_ports,
      victims, vnode, vres, node_rank, node_cum, P, N, R, W, s_max, T,
      preempt_mode, preds_on, pa_ok, cap_in, phase, full_s, chunk_s, unif_s, p_out,
      cum_out, placed_out, evict_out);
  return (int)cudaGetLastError();
}
