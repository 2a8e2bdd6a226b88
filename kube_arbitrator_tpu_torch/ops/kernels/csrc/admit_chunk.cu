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
// int32 scan, and the in-place writeback of node_idle / node_releasing /
// node_num_tasks / node_ports and row g of gn_a / gn_p.
//
// Bound: bytes, ~300 KB a slot at N = 10k (~0.1 us at 3.35 TB/s).  What
// holds it back is latency: the slots run in order (node state carries
// from one to the next: the reference's semantics), and each slot is a
// reduction, a decision (the fallback) and a scan over the node axis.  The
// first design ran one block in which each thread owned a contiguous run
// of ceil(M / 1024) positions, so a warp's loads of one field landed
// 10 x R x 4 bytes apart and never coalesced, and every pass re-read node
// state.  This design:
// * puts lanes on neighbouring positions (position = warp segment base +
//   32 j + lane), so a warp's loads of one field are one coalesced run;
// * keeps what a slot computes per position (node, pod headroom or "not
//   ok", copy capacity) in shared memory for the slot's three passes: the
//   fallback pass reads only the releasing rows, the fill reads nothing
//   but the capacities (dynamic shared memory beyond 48 KB);
// * sums and scans with warp shuffles plus one combine of warp totals —
//   one block barrier a pass instead of a block scan;
// * splits a long node axis across a thread-block cluster of up to 8
//   CTAs (admit_chunk.py's launch_shape picks the size): each CTA owns a
//   contiguous range of positions and the CTAs exchange their totals
//   through distributed shared memory with one cluster barrier a pass.
//   At full width each node is one CTA's own, so node state needs only
//   the CTA's barrier between slots; on the panel two slots' rows may map
//   one CTA's positions to another's nodes, so slots end with a cluster
//   barrier there.
//
// The kernel reads n_slots from the device and writes placed_v /
// use_rel_v for every slot of the chunk (0 past n_slots), so the caller
// may reuse its buffers.  The fixed arguments of an action come in one
// host struct (Static), built once per action by admit_chunk.AdmitPlan.
//
// Arithmetic mirrors the plain version exactly: IEEE divide and separate
// product/difference roundings (built with -fmad=false, and the
// intrinsics below say so explicitly); float->int conversion truncates
// and saturates like XLA's.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr int HEAD_NONE = -2147483647 - 1;  // position fails the static / port / pod tests

// Mirrors admit_chunk.py's _Static (ctypes.Structure): field order and types.
struct Static {
  const int* group_klass;
  const int* panel;  // [K, NC] pruned panel, or nullptr: the full node axis
  const uint8_t* class_fit;
  const int* node_klass;
  const uint8_t* node_valid;
  const uint8_t* node_unsched;
  const int* node_max_tasks;
  float* idle;
  float* rel;
  int* ports;
  int* num_tasks;
  int* gn_a;
  int* gn_p;
  int* placed_v;
  uint8_t* use_rel_v;
  int NC, CN, N, R, W, s_max, S;
  int best_effort, preds_on;
  int cluster, threads, cache_positions;
};

struct Slots {
  const int* n_slots;
  const int* g_sel;
  const float* req_s;
  const int* budget_s;
  const int* ports_s;
  const uint8_t* has_ports_s;
};

struct Slot {
  int g;
  const float* req;
  int budget;
  const int* ports;
  bool has_ports;  // the slot's group has host ports and predicates are on
  const int* row;  // pruned panel row of the slot's class, or nullptr
  int klass;
};

__device__ __forceinline__ int copies(const float* avail, const float* req, int R,
                                      float pods_head, bool single) {
  float m = KAT_BIG;
  for (int r = 0; r < R; ++r) {
    const float q = req[r];
    const float v = q > 0.f ? __fdiv_rn(__fadd_rn(avail[r], KAT_EPS), fmaxf(q, 1e-30f)) : KAT_BIG;
    m = fminf(m, v);
  }
  float k = fmaxf(floorf(m), 0.f);
  k = fminf(k, pods_head);
  if (single) k = fminf(k, 1.f);
  k = fmaxf(k, 0.f);
  return __float2int_rz(k);  // saturating truncation, as XLA's convert
}

// Node ordinal of panel position m (N for panel padding) and its pod
// headroom, or HEAD_NONE when the position fails its tests.
__device__ __forceinline__ int locate(const Static& sc, const Slot& s, int m, int* head) {
  const int N = sc.N;
  const int n = s.row ? s.row[m] : m;
  const bool valid_k = n < N;
  const int nc = min(n, N - 1);
  int pods_head;
  bool ok;
  if (sc.preds_on) {
    bool ports_ok = true;
    for (int w = 0; w < sc.W; ++w) ports_ok &= (s.ports[w] & sc.ports[(size_t)nc * sc.W + w]) == 0;
    pods_head = sc.node_max_tasks[nc] - sc.num_tasks[nc];
    ok = valid_k && ports_ok && pods_head > 0;
    if (!s.row) {
      // static feasibility of the full-width path (the panel encodes it
      // as membership)
      ok = ok && sc.class_fit[(size_t)s.klass * sc.CN + sc.node_klass[n]] != 0 &&
           sc.node_valid[n] != 0 && sc.node_unsched[n] == 0;
    }
  } else {
    pods_head = sc.s_max;
    ok = s.row ? valid_k : (sc.node_valid[n] != 0);
  }
  *head = ok ? pods_head : HEAD_NONE;
  return n;
}

// Copies of the slot's request placeable on node n from idle or releasing.
__device__ __forceinline__ int capacity(const Static& sc, const Slot& s, int n, int head,
                                        bool use_rel) {
  if (head == HEAD_NONE) return 0;
  if (sc.best_effort) return min(head, s.has_ports ? 1 : sc.s_max);
  const int nc = min(n, sc.N - 1);
  const float* avail = (use_rel ? sc.rel : sc.idle) + (size_t)nc * sc.R;
  return copies(avail, s.req, sc.R, __int2float_rn(head), s.has_ports);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of wt[0 .. upto) over the block's warps (wt holds <= 32 totals).
__device__ __forceinline__ int warp_totals(const int* wt, int nw, int upto) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < nw && lane < upto ? wt[lane] : 0);
}

__global__ void __launch_bounds__(1024) admit_chunk_kernel(Static sc, Slots sl) {
  extern __shared__ int cache[];  // [3][L]: node, head, capacity per owned position
  __shared__ int wtot[2][32];                    // [pass][warp]
  __shared__ int ctot[2][2][MAX_CLUSTER];        // [slot parity][pass][cta]
  const int C = sc.cluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int M = sc.panel ? sc.NC : sc.N;
  const int L = (M + C - 1) / C;
  const int lo = min(M, rank * L), hi = min(M, lo + L);
  // each warp owns a contiguous segment of the CTA's positions
  const int Lw = ((hi - lo + nw - 1) / nw + 31) & ~31;
  const int wlo = min(hi, lo + warp * Lw), whi = min(hi, wlo + Lw);
  const bool cached = L <= sc.cache_positions;
  int* n_c = cache;
  int* head_c = cache + L;
  int* k_c = cache + 2 * L;
  const int ns = *sl.n_slots;
  if (rank == 0) {  // slots not run place nothing
    for (int j = max(ns, 0) + tid; j < sc.S; j += blockDim.x) {
      sc.placed_v[j] = 0;
      sc.use_rel_v[j] = 0;
    }
  }
  const bool panel_cluster = C > 1 && sc.panel != nullptr;
  for (int i = 0; i < ns; ++i) {
    const int par = i & 1;
    Slot s;
    s.g = sl.g_sel[i];
    s.req = sl.req_s + (size_t)i * sc.R;
    s.budget = sl.budget_s[i];
    s.ports = sl.ports_s + (size_t)i * sc.W;
    s.has_ports = sc.preds_on && sl.has_ports_s[i] != 0;
    s.klass = sc.group_klass[s.g];
    s.row = sc.panel ? sc.panel + (size_t)s.klass * sc.NC : nullptr;

    // pass 1: capacity from idle
    int sum = 0;
    for (int m = wlo + lane; m < whi; m += 32) {
      int head;
      const int n = locate(sc, s, m, &head);
      const int k = capacity(sc, s, n, head, false);
      if (cached) {
        n_c[m - lo] = n;
        head_c[m - lo] = head;
        k_c[m - lo] = k;
      }
      sum += k;
    }
    sum = warp_sum(sum);
    if (lane == 0) wtot[0][warp] = sum;
    __syncthreads();
    int cta_tot = warp_totals(wtot[0], nw, 32);
    int tot = cta_tot;
    if (C > 1) {
      if (tid < C) *cluster.map_shared_rank(&ctot[par][0][rank], tid) = cta_tot;
      cluster.sync();
      tot = 0;
      for (int r = 0; r < C; ++r) tot += ctot[par][0][r];
    }
    const bool use_rel = !sc.best_effort && tot == 0 && s.budget > 0;
    const int pass = use_rel ? 1 : 0;
    if (use_rel) {
      // pass 2: nothing idle-fits anywhere: capacity from releasing
      sum = 0;
      for (int m = wlo + lane; m < whi; m += 32) {
        int n, head;
        if (cached) {
          n = n_c[m - lo];
          head = head_c[m - lo];
        } else {
          n = locate(sc, s, m, &head);
        }
        const int k = capacity(sc, s, n, head, true);
        if (cached) k_c[m - lo] = k;
        sum += k;
      }
      sum = warp_sum(sum);
      if (lane == 0) wtot[1][warp] = sum;
      __syncthreads();
      cta_tot = warp_totals(wtot[1], nw, 32);
      tot = cta_tot;
      if (C > 1) {
        if (tid < C) *cluster.map_shared_rank(&ctot[par][1][rank], tid) = cta_tot;
        cluster.sync();
        tot = 0;
        for (int r = 0; r < C; ++r) tot += ctot[par][1][r];
      }
    }
    int run = warp_totals(wtot[pass], nw, warp);  // this warp's offset in the CTA
    for (int r = 0; r < rank; ++r) run += ctot[par][pass][r];
    const int placed_total = min(s.budget, tot);
    // pass 3: the prefix fill, 32 positions a step, and the writeback
    for (int mb = wlo; mb < whi; mb += 32) {
      const int m = mb + lane;
      int n = 0, k = 0;
      if (m < whi) {
        if (cached) {
          n = n_c[m - lo];
          k = k_c[m - lo];
        } else {
          int head;
          n = locate(sc, s, m, &head);
          k = capacity(sc, s, n, head, use_rel);
        }
      }
      int incl = k;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int p = min(max(placed_total - (run + incl - k), 0), k);
      run += __shfl_sync(0xffffffffu, incl, 31);
      if (p > 0) {
        const float pf = __int2float_rn(p);
        float* avail = (use_rel ? sc.rel : sc.idle) + (size_t)n * sc.R;
        for (int r = 0; r < sc.R; ++r) avail[r] = __fsub_rn(avail[r], __fmul_rn(pf, s.req[r]));
        sc.num_tasks[n] += p;
        if (s.has_ports) {
          for (int w = 0; w < sc.W; ++w) sc.ports[(size_t)n * sc.W + w] |= s.ports[w];
        }
        int* gn = use_rel ? sc.gn_p : sc.gn_a;
        gn[(size_t)s.g * sc.N + n] += p;
      }
    }
    if (rank == 0 && tid == 0) {
      sc.placed_v[i] = placed_total;
      sc.use_rel_v[i] = use_rel ? 1 : 0;
    }
    // node state of this slot is visible to the next
    if (panel_cluster) {
      __threadfence();
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
  if (C > 1) cluster.sync();  // no CTA leaves while another may write its shared memory
}

}  // namespace

extern "C" int kat_admit_chunk(const void* static_args, const int* n_slots, const int* g_sel,
                               const float* req_s, const int* budget_s, const int* ports_s,
                               const uint8_t* has_ports_s, void* stream) {
  const Static* sc = static_cast<const Static*>(static_args);
  const int C = sc->cluster;
  if (C < 1 || C > MAX_CLUSTER || sc->threads < 32 || sc->threads > 1024 || sc->threads % 32 ||
      sc->S > 1024)
    return (int)cudaErrorInvalidValue;
  const int M = sc->panel ? sc->NC : sc->N;
  const int L = (M + C - 1) / C;
  const size_t smem = L <= sc->cache_positions ? 3 * (size_t)L * sizeof(int) : 0;
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        admit_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  Slots sl = {n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(sc->threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, admit_chunk_kernel, *sc, sl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
