// K17 queue_order: a round's queue order, perm = lexsort of a key stack
// with key 0 primary, ties by index, and the active-queue count.
//
// Replaces the reference's queue lexsort, kube_arbitrator_tpu/ops/
// allocate.py:1026-1043 (and its twins ops/preempt.py:893-908, :1871,
// :2246-2259): jnp.lexsort(tuple(reversed(keys))) over the stack
// [inactive flag, queue_order_keys with BIG on inactive queues], and
// nq = sum(q_active).
//
// Rank by counting: thread i counts the queues j that sort before i
// (lexicographically smaller, or equal with j < i) and writes
// perm[rank_i] = i.  Every rank is distinct, so perm is a permutation.
// The comparator is the sort's, not a bare float `<`: -0.0 equals +0.0,
// NaN sorts after every number and NaNs equal each other (the order
// jnp.lexsort and torch.sort(stable=True) give).
//
// Bound: bytes — K*Q key floats and Q flags read once, Q i64 and one i32
// written: ~12 KB at Q = 512, K = 3 (~4 ns at 3.35 TB/s); the O(Q^2 K)
// comparisons (0.8 M at Q = 512) take ~1 us of one SM's issue, so the
// launch is the floor.  A multi-block grid over i takes any Q; each
// block stages the key columns of j in shared memory tile by tile.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 16;  // queue_order.py's MAX_KEYS

// -1 / 0 / 1: a before / tied with / after b in the sort's order
__device__ __forceinline__ int cmp_key(float a, float b) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na ? 1 : 0) - (nb ? 1 : 0);
  return (a < b) ? -1 : ((a > b) ? 1 : 0);  // -0.0 == +0.0 here
}

__global__ void __launch_bounds__(THREADS) queue_order_kernel(
    const float* __restrict__ keys, int K, int Q,
    const uint8_t* __restrict__ q_active, long long* __restrict__ perm,
    int* __restrict__ nq) {
  __shared__ float tile[MAX_K][THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float mine[MAX_K];
  if (i < Q) {
    for (int k = 0; k < K; ++k) mine[k] = keys[(size_t)k * Q + i];
  }
  int rank = 0;
  for (int base = 0; base < Q; base += THREADS) {
    const int j = base + threadIdx.x;
    for (int k = 0; k < K; ++k) tile[k][threadIdx.x] = j < Q ? keys[(size_t)k * Q + j] : 0.0f;
    __syncthreads();
    const int n = min(THREADS, Q - base);
    if (i < Q) {
      for (int t = 0; t < n; ++t) {
        int c = 0;
        for (int k = 0; k < K && c == 0; ++k) c = cmp_key(tile[k][t], mine[k]);
        rank += (c < 0) || (c == 0 && base + t < i);
      }
    }
    __syncthreads();
  }
  if (i < Q) {
    perm[rank] = (long long)i;
    if (q_active[i]) atomicAdd(nq, 1);
  }
}

}  // namespace

extern "C" int kat_queue_order(const float* keys, int K, int Q, const uint8_t* q_active,
                               long long* perm, int* nq, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(nq, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (Q > 0) {
    queue_order_kernel<<<(Q + THREADS - 1) / THREADS, THREADS, 0, s>>>(keys, K, Q, q_active,
                                                                      perm, nq);
  }
  return (int)cudaGetLastError();
}
