// K1 admit_chunk: the node-admission chain of one chunk of <= TURN_CHUNK
// selected queue turns.
//
// Replaces kube_arbitrator_tpu/ops/allocate.py:_round_batched.slot_body
// (:793-951) with _node_capacity / _copies_fit (:335-353) — the chain the
// deleted Pallas kernel ops/pallas_admit.py (pallas_call at :221, git
// a7a7408^) fused.  For each slot, in order: per-node copy capacity from
// idle (static feasibility, host ports, pod headroom), the releasing
// fallback when nothing idle-fits, placed_total = min(budget, sum k), the
// prefix fill p_n = clip(placed_total - excl_prefix_n, 0, k_n) as an
// int32 block scan, and the in-place writeback of node_idle /
// node_releasing / node_num_tasks / node_ports and row g of gn_a / gn_p.
//
// Bound: bytes.  A slot reads the node state it scans (R f32 of idle,
// W i32 of ports, two i32 counts per node) and writes only the nodes it
// places on, so at N = 10k one slot moves ~300 KB: ~0.1 us at 3.35 TB/s.
// The real floor is latency: one block runs the chunk's slots back to
// back so node state carries in order between slots, and each slot takes
// three block-wide passes with a barrier-bound scan between them.  That
// serial shape is the reference's semantics; speed (several blocks per
// slot, a persistent round loop) is later work.
//
// Arithmetic mirrors the plain version exactly: IEEE divide and separate
// product/difference roundings (built with -fmad=false, and the
// intrinsics below say so explicitly); float->int conversion truncates
// and saturates like XLA's.
#include "common.cuh"

namespace {

struct Slot {
  int g;
  const float* req;
  int budget;
  const int* ports;
  bool has_ports;
  const int* row;  // pruned panel row of the slot's class, or nullptr
  int klass;
};

struct Nodes {
  const uint8_t* class_fit;
  int CN;
  const int* node_klass;
  const uint8_t* node_valid;
  const uint8_t* node_unsched;
  const int* node_max_tasks;
  float* idle;
  float* rel;
  int* ports;
  int* num_tasks;
  int N, R, W, s_max;
  bool best_effort, preds_on;
};

__device__ __forceinline__ int copies(const float* avail, const float* req, int R,
                                      float pods_head, bool single, bool ok) {
  float m = KAT_BIG;
  for (int r = 0; r < R; ++r) {
    const float q = req[r];
    const float v = q > 0.f ? __fdiv_rn(__fadd_rn(avail[r], KAT_EPS), fmaxf(q, 1e-30f)) : KAT_BIG;
    m = fminf(m, v);
  }
  float k = fmaxf(floorf(m), 0.f);
  k = fminf(k, pods_head);
  if (single) k = fminf(k, 1.f);
  if (!ok) k = 0.f;
  k = fmaxf(k, 0.f);
  return __float2int_rz(k);  // saturating truncation, as XLA's convert
}

// Copy capacity of panel position m for the slot; *n_out = node ordinal
// (N for panel padding).
__device__ __forceinline__ int capacity(const Nodes& nd, const Slot& s, int m,
                                        bool use_rel, int* n_out) {
  const int N = nd.N;
  const int n = s.row ? s.row[m] : m;
  *n_out = n;
  const bool valid_k = n < N;
  const int nc = min(n, N - 1);
  int pods_head;
  bool ok;
  bool has_ports = false;
  if (nd.preds_on) {
    has_ports = s.has_ports;
    bool ports_ok = true;
    for (int w = 0; w < nd.W; ++w) ports_ok &= (s.ports[w] & nd.ports[(size_t)nc * nd.W + w]) == 0;
    pods_head = nd.node_max_tasks[nc] - nd.num_tasks[nc];
    ok = valid_k && ports_ok && pods_head > 0;
    if (!s.row) {
      // static feasibility of the full-width path (the panel encodes it
      // as membership)
      ok = ok && nd.class_fit[(size_t)s.klass * nd.CN + nd.node_klass[n]] != 0 &&
           nd.node_valid[n] != 0 && nd.node_unsched[n] == 0;
    }
  } else {
    pods_head = nd.s_max;
    ok = s.row ? valid_k : (nd.node_valid[n] != 0);
  }
  if (nd.best_effort) {
    return ok ? min(pods_head, has_ports ? 1 : nd.s_max) : 0;
  }
  const float* avail = (use_rel ? nd.rel : nd.idle) + (size_t)nc * nd.R;
  return copies(avail, s.req, nd.R, __int2float_rn(pods_head), has_ports, ok);
}

__global__ void __launch_bounds__(1024) admit_chunk_kernel(
    const int* __restrict__ n_slots, const int* __restrict__ g_sel,
    const float* __restrict__ req_s, const int* __restrict__ budget_s,
    const int* __restrict__ ports_s, const uint8_t* __restrict__ has_ports_s,
    const int* __restrict__ group_klass, const int* __restrict__ panel, int NC,
    Nodes nd, int* __restrict__ gn_a, int* __restrict__ gn_p,
    int* __restrict__ placed_v, uint8_t* __restrict__ use_rel_v) {
  const int ns = *n_slots;
  const int M = panel ? NC : nd.N;
  const int per = (M + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, M);
  const int hi = min(lo + per, M);
  for (int i = 0; i < ns; ++i) {
    Slot s;
    s.g = g_sel[i];
    s.req = req_s + (size_t)i * nd.R;
    s.budget = budget_s[i];
    s.ports = ports_s + (size_t)i * nd.W;
    s.has_ports = has_ports_s[i] != 0;
    s.klass = group_klass[s.g];
    s.row = panel ? panel + (size_t)s.klass * NC : nullptr;

    int n;
    int tsum = 0;
    for (int m = lo; m < hi; ++m) {
      tsum += capacity(nd, s, m, false, &n);
    }
    int tot_idle;
    kat_block_excl_scan(tsum, &tot_idle);
    const bool use_rel = !nd.best_effort && tot_idle == 0 && s.budget > 0;
    if (use_rel) {
      tsum = 0;
      for (int m = lo; m < hi; ++m) {
        tsum += capacity(nd, s, m, true, &n);
      }
    }
    int total;
    int run = kat_block_excl_scan(tsum, &total);
    const int placed_total = min(s.budget, total);
    for (int m = lo; m < hi; ++m) {
      const int k = capacity(nd, s, m, use_rel, &n);
      const int p = min(max(placed_total - run, 0), k);
      run += k;
      if (p <= 0) continue;
      const float pf = __int2float_rn(p);
      float* avail = (use_rel ? nd.rel : nd.idle) + (size_t)n * nd.R;
      for (int r = 0; r < nd.R; ++r) avail[r] = __fsub_rn(avail[r], __fmul_rn(pf, s.req[r]));
      nd.num_tasks[n] += p;
      if (nd.preds_on && s.has_ports) {
        for (int w = 0; w < nd.W; ++w) nd.ports[(size_t)n * nd.W + w] |= s.ports[w];
      }
      int* gn = use_rel ? gn_p : gn_a;
      gn[(size_t)s.g * nd.N + n] += p;
    }
    if (threadIdx.x == 0) {
      placed_v[i] = placed_total;
      use_rel_v[i] = use_rel ? 1 : 0;
    }
    __syncthreads();  // node state of this slot is visible to the next
  }
}

}  // namespace

extern "C" int kat_admit_chunk(
    const int* n_slots, const int* g_sel, const float* req_s,
    const int* budget_s, const int* ports_s, const uint8_t* has_ports_s,
    const int* group_klass, const int* panel, int NC,
    const uint8_t* class_fit, int CN, const int* node_klass,
    const uint8_t* node_valid, const uint8_t* node_unsched,
    const int* node_max_tasks, float* node_idle, float* node_releasing,
    int* node_ports, int* node_num_tasks, int* gn_a, int* gn_p,
    int* placed_v, uint8_t* use_rel_v, int N, int R, int W, int s_max,
    int best_effort, int preds_on, void* stream) {
  Nodes nd;
  nd.class_fit = class_fit;
  nd.CN = CN;
  nd.node_klass = node_klass;
  nd.node_valid = node_valid;
  nd.node_unsched = node_unsched;
  nd.node_max_tasks = node_max_tasks;
  nd.idle = node_idle;
  nd.rel = node_releasing;
  nd.ports = node_ports;
  nd.num_tasks = node_num_tasks;
  nd.N = N;
  nd.R = R;
  nd.W = W;
  nd.s_max = s_max;
  nd.best_effort = best_effort != 0;
  nd.preds_on = preds_on != 0;
  admit_chunk_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s, group_klass,
      panel, NC, nd, gn_a, gn_p, placed_v, use_rel_v);
  return (int)cudaGetLastError();
}
