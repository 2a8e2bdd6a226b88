// K12 pa_shape: the pod-affinity shaping of one turn's per-node capacity.
//
// Replaces kube_arbitrator_tpu/ops/podaffinity.py:apply_seed (:173-193)
// and apply_domain_cap (:196-227).  The capacity rows arrive in PACKING
// order (node nperm[i] at position i, or node i without a permutation);
// the terms fold in order, seed terms first:
//   seed  — the capacity summed per domain of the term's key (integer,
//           exact in any order), the FIRST domain with the largest sum
//           (jnp.argmax), and every node outside it zeroed;
//   cap   — per domain of the term's key, the first position in packing
//           order with capacity > 0 keeps min(k, 1), every other node of
//           the domain 0; nodes without the key's label stay uncapped.
//           (The reference keeps the first node of the domain among k > 0
//           nodes, then among k = 0 nodes; a kept k = 0 node stays 0, so
//           the first k > 0 position is the only one that matters.)
// Each row (idle, releasing) is shaped with the same terms.
//
// One block: every fold is a pass over the nodes, a block-wide reduction
// or an integer atomicMin into a [D] scratch, and a second pass.  Bound:
// bytes — per fold the row and the key's domain ordinals read, the row
// written (~60 KB at N = 5,120); the block's barriers are the floor.
#include "common.cuh"

namespace {

__device__ __forceinline__ int dom_at(const int* node_dom, int key, int N, const int* nperm, int i) {
  return node_dom[(size_t)key * N + (nperm ? nperm[i] : i)];
}

__global__ void __launch_bounds__(1024) pa_shape_kernel(
    const int* __restrict__ k_in, int* __restrict__ k_out, int rows, int N,
    const int* __restrict__ nperm, const int* __restrict__ node_dom, int D,
    const uint8_t* __restrict__ seed_flags, const int* __restrict__ seed_keys, int MA,
    const uint8_t* __restrict__ cap_flags, const int* __restrict__ cap_keys, int MB,
    int* __restrict__ scratch) {
  for (int r = 0; r < rows; ++r) {
    int* k = k_out + (size_t)r * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) k[i] = k_in[(size_t)r * N + i];
    __syncthreads();
    for (int m = 0; m < MA; ++m) {
      if (!seed_flags[m]) continue;  // the same for every thread
      const int key = seed_keys[m];
      for (int d = threadIdx.x; d < D; d += blockDim.x) scratch[d] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int nd = dom_at(node_dom, key, N, nperm, i);
        if (nd >= 0 && k[i] != 0) atomicAdd(&scratch[nd], k[i]);
      }
      __syncthreads();
      int vmax = -1;  // sums are >= 0
      for (int d = threadIdx.x; d < D; d += blockDim.x) vmax = max(vmax, scratch[d]);
      vmax = -kat_block_min_i32(-vmax);
      int first = 0x7fffffff;
      for (int d = threadIdx.x; d < D; d += blockDim.x)
        if (scratch[d] == vmax) first = min(first, d);
      const int best = kat_block_min_i32(first);
      for (int i = threadIdx.x; i < N; i += blockDim.x)
        if (dom_at(node_dom, key, N, nperm, i) != best) k[i] = 0;
      __syncthreads();
    }
    for (int m = 0; m < MB; ++m) {
      if (!cap_flags[m]) continue;
      const int key = cap_keys[m];
      for (int d = threadIdx.x; d < D; d += blockDim.x) scratch[d] = 0x7fffffff;
      __syncthreads();
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int nd = dom_at(node_dom, key, N, nperm, i);
        if (nd >= 0 && k[i] > 0) atomicMin(&scratch[nd], i);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        const int nd = dom_at(node_dom, key, N, nperm, i);
        if (nd >= 0) k[i] = (k[i] > 0 && scratch[nd] == i) ? 1 : 0;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int kat_pa_shape(const int* k_in, int* k_out, int rows, int N, const int* nperm,
                            const int* node_dom, int D, const uint8_t* seed_flags,
                            const int* seed_keys, int MA, const uint8_t* cap_flags,
                            const int* cap_keys, int MB, int* scratch, void* stream) {
  pa_shape_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(k_in, k_out, rows, N, nperm, node_dom, D,
                                                        seed_flags, seed_keys, MA, cap_flags,
                                                        cap_keys, MB, scratch);
  return (int)cudaGetLastError();
}
