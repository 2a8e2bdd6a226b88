// K12 pa_shape: the pod-affinity shaping of one turn's per-node capacity.
//
// Replaces kube_arbitrator_tpu/ops/podaffinity.py:apply_seed (:173-193)
// and apply_domain_cap (:196-227).  The capacity rows arrive in PACKING
// order (node nperm[i] at position i, or node i without a permutation)
// and are shaped IN PLACE; the terms fold in order, seed terms first:
//   seed  — the capacity summed per domain of the term's key (integer,
//           exact in any order), the FIRST domain with the largest sum
//           (jnp.argmax), and every node outside it zeroed;
//   cap   — per domain of the term's key, the first position in packing
//           order with capacity > 0 keeps min(k, 1), every other node of
//           the domain 0; nodes without the key's label stay uncapped.
//           (The reference keeps the first node of the domain among k > 0
//           nodes, then among k = 0 nodes; a kept k = 0 node stays 0, so
//           the first k > 0 position is the only one that matters.)
// A term whose flag is off is skipped, with no barrier.
//
// One CTA a row, so the idle and releasing rows run side by side.  Up to
// TILE positions a thread holds its ITEMS positions of the row and, per
// fold, their domain ordinals node_dom[key][nperm[i]] in registers: the
// row is read once and written once, and each fold gathers the ordinals
// once.  Past TILE ("tiled": not met by any shipped world) the row is
// shaped in global memory a tile at a time and the ordinals are gathered
// once per pass.  The [D] domain scratch lives in dynamic shared memory
// (D * 4 bytes: ~21 KB at the pod-affinity world's 5,129 domains) or,
// past SMEM_MAX_D, in a per-row global scratch; the kernel zeroes it.
//   seed: integer atomicAdd into the scratch; one barrier; each thread
//         reads and re-zeroes its strided domains into a packed
//         (sum, ~d) u64 max (the first domain wins ties), a warp shuffle
//         and one block step give the winner; a second barrier.
//   cap:  atomicMax of (fold stamp << 24 | N - i) over positions with
//         k > 0 gives each domain's first position; a barrier; each
//         position compares.  The stamp (the cap fold's ordinal, from 1)
//         makes every earlier cap fold's entries smaller, so the scratch
//         needs no zeroing between caps, only a barrier before the next
//         cap fold's atomics.
//
// Bound: bytes — per row the row read and written once, per active fold
// the key's N domain ordinals (and nperm) read once: ~80-120 KB at N =
// 5,000 and two rows (~0.03 us at 3.35 TB/s); the barriers and the
// gathers' latency are the floor.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 12;              // positions a thread holds in registers
constexpr int TILE = THREADS * ITEMS;  // past it the row is shaped a tile at a time

// The plan's fixed arguments (pa_shape.PaShapePlan's _Static).
struct Static {
  int* k;                     // i32[rows, N] shaped in place (null: the launch passes the rows)
  const int* nperm;           // i32[N] node at each position, or null (node order)
  const int* node_dom;        // i32[K, N] domain ordinal of node n under key k, -1 unlabelled
  const uint8_t* seed_flags;  // bool[MA]
  const int* seed_keys;       // i32[MA]
  const uint8_t* cap_flags;   // bool[MB]
  const int* cap_keys;        // i32[MB]
  int* scratch;               // i32[rows, D] when the scratch is global, else null
  int rows, N, D, MA, MB;
};

// The domain ordinal of every position a thread holds in the tile at base.
__device__ __forceinline__ void gather(const Static& s, int key, int base, int (&nd)[ITEMS]) {
  const int* dom = s.node_dom + (size_t)key * s.N;
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int i = base + t * THREADS + threadIdx.x;
    nd[t] = i < s.N ? dom[s.nperm ? s.nperm[i] : i] : -1;
  }
}

__device__ __forceinline__ void load(const int* row, int N, int base, int (&kv)[ITEMS]) {
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int i = base + t * THREADS + threadIdx.x;
    kv[t] = i < N ? row[i] : 0;
  }
}

__device__ __forceinline__ void store(int* row, int N, int base, const int (&kv)[ITEMS]) {
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int i = base + t * THREADS + threadIdx.x;
    if (i < N) row[i] = kv[t];
  }
}

__global__ void __launch_bounds__(THREADS) pa_shape_kernel(Static s, int* rows_k) {
  extern __shared__ int smem_dom[];
  __shared__ unsigned long long warp_best[THREADS / 32];
  const int N = s.N, D = s.D;
  int* row = rows_k + (size_t)blockIdx.x * N;
  int* dom = s.scratch ? s.scratch + (size_t)blockIdx.x * D : smem_dom;
  const bool tiled = N > TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int kv[ITEMS], nd[ITEMS];
  for (int d = threadIdx.x; d < D; d += THREADS) dom[d] = 0;
  if (!tiled) load(row, N, 0, kv);
  __syncthreads();
  for (int m = 0; m < s.MA; ++m) {
    if (!s.seed_flags[m]) continue;  // the same for every thread
    const int key = s.seed_keys[m];
    for (int base = 0; base < N; base += TILE) {
      if (tiled) load(row, N, base, kv);
      gather(s, key, base, nd);
#pragma unroll
      for (int t = 0; t < ITEMS; ++t)
        if (nd[t] >= 0 && kv[t] != 0) atomicAdd(&dom[nd[t]], kv[t]);
    }
    __syncthreads();
    // (sum, ~d) packed: the largest sum, then the smallest d; the signed
    // sum mapped to unsigned order
    unsigned long long best = 0;
    for (int d = threadIdx.x; d < D; d += THREADS) {
      const unsigned long long c =
          ((unsigned long long)((unsigned)dom[d] ^ 0x80000000u) << 32) | (0xFFFFFFFFu - (unsigned)d);
      dom[d] = 0;  // zero again for the next fold: only this thread reads dom[d] here
      best = c > best ? c : best;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long y = __shfl_xor_sync(0xffffffffu, best, o);
      best = y > best ? y : best;
    }
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    best = 0;
#pragma unroll 8
    for (int w = 0; w < THREADS / 32; ++w) best = warp_best[w] > best ? warp_best[w] : best;
    const int bd = D > 0 ? (int)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFu)) : 0x7fffffff;
    for (int base = 0; base < N; base += TILE) {
      if (tiled) {
        load(row, N, base, kv);
        gather(s, key, base, nd);
      }
#pragma unroll
      for (int t = 0; t < ITEMS; ++t)
        if (nd[t] != bd) kv[t] = 0;
      if (tiled) store(row, N, base, kv);
    }
  }
  int stamp = 0;
  for (int m = 0; m < s.MB; ++m) {
    if (!s.cap_flags[m]) continue;
    const int key = s.cap_keys[m];
    if (stamp > 0) __syncthreads();  // the last cap fold's compares are done
    ++stamp;
    for (int base = 0; base < N; base += TILE) {
      if (tiled) load(row, N, base, kv);
      gather(s, key, base, nd);
#pragma unroll
      for (int t = 0; t < ITEMS; ++t) {
        const int i = base + t * THREADS + threadIdx.x;
        if (nd[t] >= 0 && kv[t] > 0) atomicMax(&dom[nd[t]], (stamp << 24) | (N - i));
      }
    }
    __syncthreads();
    for (int base = 0; base < N; base += TILE) {
      if (tiled) {
        load(row, N, base, kv);
        gather(s, key, base, nd);
      }
#pragma unroll
      for (int t = 0; t < ITEMS; ++t) {
        const int i = base + t * THREADS + threadIdx.x;
        if (nd[t] >= 0) kv[t] = (kv[t] > 0 && dom[nd[t]] == ((stamp << 24) | (N - i))) ? 1 : 0;
      }
      if (tiled) store(row, N, base, kv);
    }
  }
  if (!tiled) store(row, N, 0, kv);
}

}  // namespace

extern "C" int kat_pa_shape(const void* static_args, int* k, int rows, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  int* rows_k = k ? k : s.k;
  const int nrows = k ? rows : s.rows;
  if (nrows <= 0 || s.N <= 0) return 0;
  const size_t smem = s.scratch ? 0 : (size_t)s.D * sizeof(int);
  static size_t smem_set = 48 * 1024;  // raised once per size, not per launch
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pa_shape_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  pa_shape_kernel<<<nrows, THREADS, smem, (cudaStream_t)stream>>>(s, rows_k);
  return (int)cudaGetLastError();
}
