// K9 turn_caps: one immediate-path turn's per-node copy capacity and,
// under binpack / spread, its node packing order.
//
// Replaces the first half of kube_arbitrator_tpu/ops/allocate.py:
// _process_queue (:585-643) with _node_capacity / _copies_fit (:335-353):
// the static class fit, host ports, pod headroom and (when given) K11's
// pod-affinity mask make ok; k_idle and k_rel are the copies of the
// group's request that idle and releasing capacity hold (backfill: the
// pod headroom, one copy for a host-port group); the nodeorder policy's
// packing order is a stable sort of (score, node) with score = -/+ the
// node's dominant used share (binpack / spread), invalid nodes at BIG.
// Both rows are written in packing order.
//
// One block.  The sort is a bitonic sort of the padded power of two of
// (key, node) pairs in dynamic shared memory (16,384 x 8 B = 128 KB at
// N = 10,240); the pairs are distinct, so the result is the stable
// order.  The key is canonicalised: an idle node's binpack key is -0.0,
// which the reference's sort compares equal to +0.0 (ties then fall to
// the node index); raw float bits would put it first.
//
// Bound: bytes — per node R f32 of idle, releasing and allocatable, W
// i32 of ports, the counts and flags read once, two i32 rows and the
// permutation written: ~0.6 MB at N = 10,240 (~0.2 us).  The sort's
// 105 block-wide passes over shared memory are the floor.
//
// Arithmetic mirrors the plain version exactly: IEEE divides, separate
// roundings (built with -fmad=false), saturating float -> int.
#include "common.cuh"

namespace {

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
// fair resources (ops/common.py:safe_share)
__device__ __forceinline__ float used_share(const float* alloc, const float* idle, int F) {
  float s = 0.f;
  for (int r = 0; r < F; ++r) {
    const float total = alloc[r];
    const float used = fmaxf(__fsub_rn(total, idle[r]), 0.f);
    const float sh = total > 0.f ? __fdiv_rn(used, fmaxf(total, 1e-30f)) : (used > 0.f ? 1.f : 0.f);
    s = r == 0 ? sh : fmaxf(s, sh);
  }
  return s;
}

__device__ __forceinline__ bool pair_gt(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

__global__ void __launch_bounds__(1024) turn_caps_kernel(
    const int* __restrict__ g_p, const float* __restrict__ req, const float* __restrict__ idle,
    const float* __restrict__ rel, const float* __restrict__ alloc,
    const int* __restrict__ node_ports, const int* __restrict__ node_num_tasks,
    const uint8_t* __restrict__ class_fit, int CN, const int* __restrict__ node_klass,
    const uint8_t* __restrict__ node_valid, const uint8_t* __restrict__ node_unsched,
    const int* __restrict__ node_max_tasks, const int* __restrict__ group_klass,
    const int* __restrict__ group_ports, const uint8_t* __restrict__ pa_ok, int N, int R,
    int F, int W, int s_max, int best_effort, int preds_on, int policy, int P2,
    int* __restrict__ k_out, int* __restrict__ nperm_out) {
  extern __shared__ unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);
  int* idx = reinterpret_cast<int*>(key + P2);
  const int g = *g_p;
  if (policy != 0) {
    for (int i = threadIdx.x; i < P2; i += blockDim.x) {
      if (i < N) {
        const float us = used_share(alloc + (size_t)i * R, idle + (size_t)i * R, F);
        float kv = node_valid[i] ? (policy == 1 ? -us : us) : KAT_BIG;
        if (kv == 0.f) kv = 0.f;  // -0.0 -> +0.0
        key[i] = kv;
        idx[i] = i;
      } else {
        key[i] = INFINITY;
        idx[i] = 0x7fffffff;
      }
    }
    __syncthreads();
    for (int size = 2; size <= P2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < P2; i += blockDim.x) {
          const int l = i ^ stride;
          if (l > i) {
            const bool up = (i & size) == 0;
            const float ki = key[i], kl = key[l];
            const int ii = idx[i], il = idx[l];
            if (up == pair_gt(ki, ii, kl, il)) {
              key[i] = kl;
              key[l] = ki;
              idx[i] = il;
              idx[l] = ii;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < N; i += blockDim.x) nperm_out[i] = idx[i];
  }
  const int klass = group_klass[g];
  const int* gports = group_ports + (size_t)g * W;
  bool has_ports = false;
  if (preds_on)
    for (int w = 0; w < W; ++w) has_ports |= gports[w] != 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int n = policy != 0 ? idx[i] : i;
    int pods_head;
    bool ok;
    if (preds_on) {
      bool ports_ok = true;
      for (int w = 0; w < W; ++w) ports_ok &= (gports[w] & node_ports[(size_t)n * W + w]) == 0;
      pods_head = node_max_tasks[n] - node_num_tasks[n];
      ok = class_fit[(size_t)klass * CN + node_klass[n]] != 0 && node_valid[n] != 0 &&
           node_unsched[n] == 0 && ports_ok && pods_head > 0;
    } else {
      pods_head = s_max;
      ok = node_valid[n] != 0;
    }
    if (pa_ok) ok = ok && pa_ok[n] != 0;
    int ki, kr;
    if (best_effort) {
      ki = ok ? min(pods_head, has_ports ? 1 : s_max) : 0;
      kr = 0;
    } else {
      const float ph = __int2float_rn(pods_head);
      ki = copies(idle + (size_t)n * R, req, R, ph, has_ports, ok);
      kr = copies(rel + (size_t)n * R, req, R, ph, has_ports, ok);
    }
    k_out[i] = ki;
    k_out[(size_t)N + i] = kr;
  }
}

}  // namespace

extern "C" int kat_turn_caps(
    const int* g, const float* req, const float* idle, const float* rel, const float* alloc,
    const int* node_ports, const int* node_num_tasks, const uint8_t* class_fit, int CN,
    const int* node_klass, const uint8_t* node_valid, const uint8_t* node_unsched,
    const int* node_max_tasks, const int* group_klass, const int* group_ports,
    const uint8_t* pa_ok, int N, int R, int F, int W, int s_max, int best_effort, int preds_on,
    int policy, int P2, int* k_out, int* nperm_out, void* stream) {
  const size_t shmem = policy != 0 ? (size_t)P2 * (sizeof(float) + sizeof(int)) : 0;
  cudaError_t e = cudaFuncSetAttribute(turn_caps_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  turn_caps_kernel<<<1, 1024, shmem, (cudaStream_t)stream>>>(
      g, req, idle, rel, alloc, node_ports, node_num_tasks, class_fit, CN, node_klass,
      node_valid, node_unsched, node_max_tasks, group_klass, group_ports, pa_ok, N, R, F, W,
      s_max, best_effort, preds_on, policy, P2, k_out, nperm_out);
  return (int)cudaGetLastError();
}
