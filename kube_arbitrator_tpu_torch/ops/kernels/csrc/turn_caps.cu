// K9 turn_caps: one immediate-path turn's per-node copy capacity and,
// under binpack / spread, its node packing order.
//
// Replaces the first half of kube_arbitrator_tpu/ops/allocate.py:
// _process_queue (:585-643) with _node_capacity / _copies_fit (:335-353):
// the static class fit, host ports, pod headroom and (when given) K11's
// pod-affinity mask make ok; k_idle and k_rel are the copies of the
// group's request that idle and releasing capacity hold (backfill: the
// pod headroom, one copy for a host-port group); the nodeorder policy's
// packing order is the reference's jnp.lexsort((arange(N), key)) with
// key = -/+ the node's dominant used share (binpack / spread), invalid
// nodes at BIG.  Both rows are written in packing order.
//
// The order is a stable LSD radix sort (radix.cuh) of the key's
// order-preserving int32 image: the float's bits, with the 31 low bits
// flipped for a negative float, so signed int order is float order.  The
// key is canonicalised first: an idle node's binpack key is -0.0, which
// the reference's sort compares equal to +0.0 (ties then fall to the node
// index); raw float bits would put it first.  A stable sort of the image
// with the node index as payload gives ties in node order with no index in
// the key, and a digit that every key shares costs no pass.
//
// Variants (turn_caps.py's turn_caps_variant picks by policy and N):
// * first_fit: no order; one coalesced pass over the nodes, a thread each.
// * one_cta (N <= ONE_CTA_MAX_N, the main path: 10,240 nodes): one launch.
//   A CTA of 1,024 threads per 1,024 nodes writes their keys and both
//   capacities to the plan's scratch in node order; the last CTA done (a
//   ticket) sorts the keys in shared memory with the node index as payload
//   (16 B a node: two ping-pong pairs of key and index, 160 KB at N =
//   10,240, beside the per-warp digit counts), then writes nperm and both
//   rows in packing order by gathering the scratch.  The node pass is
//   spread because in the sorting CTA alone it made the launch slower
//   than the tiled route (56.3 against 44.7 us of device on one H100;
//   spread, 29.4 us: PERF.md).
// * tiles (any larger N): the keys and capacities in node order (a grid of
//   CTAs), K19's tiled sort of the keys (radix.cuh's run_tiles, one
//   cooperative launch) writing nperm, then the gather of both rows in
//   packing order: three launches.
//
// Bound: bytes — per node R f32 of idle, releasing and allocatable, W
// i32 of ports, the counts and flags read once, two i32 rows and the
// permutation written: ~0.6 MB at N = 10,240 (~0.2 us).  The floor is the
// sorting CTA's chain: the ticket, then each live digit pass, a few
// block-wide barriers over shared memory on one SM.
//
// Arithmetic mirrors the plain version exactly: IEEE divides, separate
// roundings (built with -fmad=false), saturating float -> int.
#include "radix.cuh"

namespace {

constexpr int FF_THREADS = 256;  // first-fit and the tiles variant's node passes
constexpr int ONE_CTA_MAX_N = 12288;  // turn_caps.py's ONE_CTA_MAX_N

// the plan's fixed arguments (turn_caps.py's _Static mirrors this layout)
struct Static {
  const float* idle;
  const float* rel;
  const float* alloc;
  const int* node_ports;
  const int* node_num_tasks;
  const uint8_t* class_fit;
  const int* node_klass;
  const uint8_t* node_valid;
  const uint8_t* node_unsched;
  const int* node_max_tasks;
  const int* group_klass;
  const int* group_ports;
  int* k_out;      // [2, N]
  int* nperm_out;  // [N] (policy != 0)
  int* kc;         // [2, N] the capacities in node order (scratch)
  int* keys;       // [N] the keys in node order (scratch)
  int* sort_scratch;  // [4N] the tiles variant's ping-pong buffers
  int* ws;            // the tiles variant's workspace
  unsigned* ticket;   // [1] the one_cta variant's CTAs done, zero between launches
  int ws_words, CN, N, R, F, W, s_max, best_effort, preds_on, policy, variant;
};

constexpr int V_FIRST_FIT = 0, V_ONE_CTA = 1, V_TILES = 2;  // turn_caps.py's VARIANTS

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
  return __float2int_rz(k);
}

// the reference's dominant_share(max(alloc - idle, 0), alloc) over the F
// fair resources (ops/common.py:safe_share, subnormals flushed)
__device__ __forceinline__ float used_share(const float* alloc, const float* idle, int F) {
  float s = 0.f;
  for (int r = 0; r < F; ++r) {
    const float total = alloc[r];
    const float used = fmaxf(__fsub_rn(total, idle[r]), 0.f);
    const float sh = kat_safe_share(used, total);
    s = r == 0 ? sh : fmaxf(s, sh);
  }
  return s;
}

// node n's sort key: the order-preserving int32 image of the canonical
// float key (-0.0 -> +0.0; invalid nodes at BIG)
__device__ __forceinline__ int sort_key(const Static& s, int n) {
  const float us = used_share(s.alloc + (size_t)n * s.R, s.idle + (size_t)n * s.R, s.F);
  float kv = s.node_valid[n] ? (s.policy == 1 ? -us : us) : KAT_BIG;
  if (kv == 0.f) kv = 0.f;  // -0.0 -> +0.0
  const int b = __float_as_int(kv);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The turn's group: what every node's capacity needs of it.
struct Group {
  int klass;
  const int* ports;
  bool has_ports;
};

__device__ __forceinline__ Group group_of(const Static& s, const void* g_p, int g_wide) {
  const int g = g_wide ? (int)*static_cast<const long long*>(g_p) : *static_cast<const int*>(g_p);
  Group gr;
  gr.klass = s.group_klass[g];
  gr.ports = s.group_ports + (size_t)g * s.W;
  gr.has_ports = false;
  if (s.preds_on)
    for (int w = 0; w < s.W; ++w) gr.has_ports |= gr.ports[w] != 0;
  return gr;
}

// node n's (idle, releasing) copies of the group's request
__device__ __forceinline__ int2 node_caps(const Static& s, const Group& gr, const float* req,
                                          const uint8_t* pa_ok, int n) {
  int pods_head;
  bool ok;
  if (s.preds_on) {
    bool ports_ok = true;
    for (int w = 0; w < s.W; ++w) ports_ok &= (gr.ports[w] & s.node_ports[(size_t)n * s.W + w]) == 0;
    pods_head = s.node_max_tasks[n] - s.node_num_tasks[n];
    ok = s.class_fit[(size_t)gr.klass * s.CN + s.node_klass[n]] != 0 && s.node_valid[n] != 0 &&
         s.node_unsched[n] == 0 && ports_ok && pods_head > 0;
  } else {
    pods_head = s.s_max;
    ok = s.node_valid[n] != 0;
  }
  if (pa_ok) ok = ok && pa_ok[n] != 0;
  if (s.best_effort) return make_int2(ok ? min(pods_head, gr.has_ports ? 1 : s.s_max) : 0, 0);
  const float ph = __int2float_rn(pods_head);
  return make_int2(copies(s.idle + (size_t)n * s.R, req, s.R, ph, gr.has_ports, ok),
                   copies(s.rel + (size_t)n * s.R, req, s.R, ph, gr.has_ports, ok));
}

// first_fit: both rows in node order.  tiles, phase 1: the capacities
// into the scratch and the keys, in node order.
__global__ void __launch_bounds__(FF_THREADS) turn_caps_nodes_kernel(
    Static s, const void* g_p, int g_wide, const float* __restrict__ req,
    const uint8_t* __restrict__ pa_ok) {
  const int n = blockIdx.x * FF_THREADS + threadIdx.x;
  if (n >= s.N) return;
  const Group gr = group_of(s, g_p, g_wide);
  const int2 k = node_caps(s, gr, req, pa_ok, n);
  int* out = s.variant == V_FIRST_FIT ? s.k_out : s.kc;
  out[n] = k.x;
  out[(size_t)s.N + n] = k.y;
  if (s.variant == V_TILES) s.keys[n] = sort_key(s, n);
}

// tiles, phase 3: both rows in packing order
__global__ void __launch_bounds__(FF_THREADS) turn_caps_gather_kernel(Static s) {
  const int i = blockIdx.x * FF_THREADS + threadIdx.x;
  if (i >= s.N) return;
  const int n = s.nperm_out[i];
  s.k_out[i] = s.kc[n];
  s.k_out[(size_t)s.N + i] = s.kc[(size_t)s.N + n];
}

// one_cta: a CTA per 1,024 nodes writes their keys and capacities in node
// order; the CTA that takes the last ticket (each CTA fences its writes
// before it takes one) loads the keys into shared memory, sorts them and
// writes both rows in packing order, then resets the ticket
__global__ void __launch_bounds__(THREADS) turn_caps_sort_kernel(
    Static s, const void* g_p, int g_wide, const float* __restrict__ req,
    const uint8_t* __restrict__ pa_ok) {
  extern __shared__ int sm[];  // keys A, nodes A, keys B, nodes B: [N] each
  __shared__ int cnt[WARPS * ROW];
  __shared__ int uniform;
  __shared__ bool last;
  const int N = s.N, tid = threadIdx.x, warp = tid >> 5;
  {
    const int n = blockIdx.x * THREADS + tid;
    if (n < N) {
      const Group gr = group_of(s, g_p, g_wide);
      const int2 k = node_caps(s, gr, req, pa_ok, n);
      s.kc[n] = k.x;
      s.kc[(size_t)N + n] = k.y;
      s.keys[n] = sort_key(s, n);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(s.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int* kin = sm;
  int* pin = sm + N;
  int* kout = sm + 2 * N;
  int* pout = sm + 3 * N;
  for (int n = tid; n < N; n += THREADS) {
    kin[n] = __ldcg(&s.keys[n]);
    pin[n] = n;
  }
  __syncthreads();
  const int per = (N + WARPS - 1) / WARPS;
  const int lo = min(N, warp * per), hi = min(N, lo + per);
  for (int shift = 0; shift < 32; shift += 8) {
    const bool moved = block_radix_pass(
        N, lo, hi, shift, cnt, &uniform,
        [&](int i, int& x, int& p) {
          x = kin[i];
          p = pin[i];
        },
        [&](int pos, int x, int p) {
          kout[pos] = x;
          pout[pos] = p;
        });
    if (!moved) continue;
    int* t = kin;
    kin = kout;
    kout = t;
    t = pin;
    pin = pout;
    pout = t;
  }
#pragma unroll 4
  for (int i = tid; i < N; i += THREADS) {
    const int n = pin[i];
    s.nperm_out[i] = n;
    s.k_out[i] = __ldcg(&s.kc[n]);
    s.k_out[(size_t)N + i] = __ldcg(&s.kc[(size_t)N + n]);
  }
  if (tid == 0) *s.ticket = 0;
}

}  // namespace

extern "C" int kat_turn_caps(const void* static_args, const void* g, int g_wide, const float* req,
                             const uint8_t* pa_ok, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  cudaStream_t st = (cudaStream_t)stream;
  if (s.N <= 0) return 0;
  const int node_grid = (s.N + FF_THREADS - 1) / FF_THREADS;
  if (s.variant == V_FIRST_FIT) {
    turn_caps_nodes_kernel<<<node_grid, FF_THREADS, 0, st>>>(s, g, g_wide, req, pa_ok);
    return (int)cudaGetLastError();
  }
  if (s.variant == V_ONE_CTA) {
    if (s.N > ONE_CTA_MAX_N) return (int)cudaErrorInvalidValue;
    const size_t smem = 4 * (size_t)s.N * sizeof(int);
    static size_t smem_set = 0;  // the attribute is raised once per size, not per launch
    if (smem > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          turn_caps_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      smem_set = smem;
    }
    turn_caps_sort_kernel<<<(s.N + THREADS - 1) / THREADS, THREADS, smem, st>>>(s, g, g_wide, req,
                                                                             pa_ok);
    return (int)cudaGetLastError();
  }
  if (s.variant != V_TILES) return (int)cudaErrorInvalidValue;
  turn_caps_nodes_kernel<<<node_grid, FF_THREADS, 0, st>>>(s, g, g_wide, req, pa_ok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Plan pl;
  pl.keys = {{s.keys, nullptr, nullptr, nullptr, nullptr, nullptr}};
  pl.nkeys = 1;
  pl.npass = 4;
  pl.bins = RADIX;
  pl.count_S = -1;
  for (int p = 0; p < 4; ++p) {
    pl.key_of[p] = 0;
    pl.shift_of[p] = (signed char)(8 * p);
  }
  const int rc = run_tiles(pl, s.N, s.ws, s.ws_words, s.sort_scratch, s.nperm_out, nullptr,
                           nullptr, st);
  if (rc != 0) return rc;
  turn_caps_gather_kernel<<<node_grid, FF_THREADS, 0, st>>>(s);
  return (int)cudaGetLastError();
}
