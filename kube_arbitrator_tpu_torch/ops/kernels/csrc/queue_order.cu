// K17 queue_order: a round's queue order, keys and all — the proportion
// share of every queue, the key stack, its lexsort and the active-queue
// count, in one launch.
//
// Replaces the reference's B3, kube_arbitrator_tpu/ops/allocate.py:
// 1026-1043 (and its twins ops/preempt.py:893-908, :1871, :2246-2259):
//   q_share = max_r safe_share(alloc_r, deserved_r) over the NUM_FAIR
//             columns, safe_share = total > 0 ? alloc / max(total, 1e-30)
//             : (alloc > 0 ? 1 : 0) with subnormal inputs and quotients
//             flushed to signed zeros (common.cuh's kat_safe_share, as
//             XLA computes it), NaN propagating as jnp.max does;
//   keys    = [active ? 0 : 1, q_share (S times, S >= 0), f32(uid rank)],
//             every key but the first BIG on an inactive queue;
//   perm    = jnp.lexsort(tuple(reversed(keys))): key 0 primary, ties by
//             index, -0.0 == +0.0, NaN after every number, NaNs equal;
//   nq      = sum(q_active).
// The division is IEEE (no fast math; build.py's -fmad=false keeps nvcc
// from contracting anything around it); the share alone flushes
// subnormals, explicitly, so no other kernel's arithmetic changes.
//
// Keys as integers: S copies of one key order like one copy, and an
// inactive queue ties with every other inactive queue on every key, so
// the stack maps to one u64 per queue — ~0 for an inactive queue, else
// (ord(share) << 32) | ord(f32(uid)) with ord the order-preserving u32
// image of a float (-0.0 canonicalised to +0.0, every NaN to 0xFFFFFFFF,
// above +inf).  An active key is below ~0: ord(f32(uid)) of a finite uid
// is below 0xFFFFFFFF.  Compares are then integer compares in registers.
//
// Rank by counting, a warp a queue: the lanes stride over the other
// queues' keys and __reduce_add_sync sums how many sort before this one
// (smaller, or equal with a smaller index); lane 0 writes
// perm[rank] = i.  Every rank is distinct, so perm is a permutation.  A
// grid of ceil(Q / 8) CTAs of 8 warps; each CTA builds all Q keys into
// shared memory itself (8 B a queue: 4 KB at Q = 512), so no CTA waits
// for another.  Route "global" (Q past STAGED_MAX_Q, or forced by the
// plan): no staging, each lane builds the keys it compares from global
// memory.  CTA 0 also counts the active queues by a block reduction and
// writes nq: no memset, no atomics.
//
// Bound: bytes — Q flags, 2*Q*F floats and Q uid ranks read once, Q i64
// and one i32 written: ~19 KB at Q = 512 (~6 ns at 3.35 TB/s); the Q^2
// integer compares (262 K at Q = 512) spread over the grid, so the
// launch is the floor.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
enum { V_STAGED = 0, V_GLOBAL = 1 };

// The plan's fixed arguments (queue_order.QueueOrderPlan's _Static).
struct Static {
  const float* deserved;  // f32[Q, R]
  const int* uid;         // i32[Q] queue uid rank
  long long* perm;        // i64[Q] out
  int* nq;                // i32[] out
  int Q, R, F, use_share, variant;
};

__device__ __forceinline__ unsigned ord_f32(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;
  if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long queue_key(const Static& s, const uint8_t* q_active,
                                                        const float* alloc, int q) {
  if (!q_active[q]) return ~0ull;
  unsigned hi = 0;
  if (s.use_share) {
    const float* a = alloc + (size_t)q * s.R;
    const float* t = s.deserved + (size_t)q * s.R;
    float m = 0.0f;
    for (int r = 0; r < s.F; ++r) {
      const float sh = kat_safe_share(a[r], t[r]);
      if (r == 0 || isnan(sh)) {
        m = sh;
      } else if (!isnan(m)) {  // a NaN stays
        m = fmaxf(m, sh);
      }
    }
    hi = ord_f32(m);
  }
  return ((unsigned long long)hi << 32) | ord_f32((float)s.uid[q]);
}

__global__ void __launch_bounds__(THREADS) queue_order_kernel(Static s, const uint8_t* q_active,
                                                              const float* alloc) {
  extern __shared__ unsigned long long keys[];
  const int Q = s.Q;
  const bool staged = s.variant == V_STAGED;
  if (staged) {
    for (int q = threadIdx.x; q < Q; q += THREADS) keys[q] = queue_key(s, q_active, alloc, q);
  }
  if (blockIdx.x == 0) {
    int c = 0;
    for (int q = threadIdx.x; q < Q; q += THREADS) c += q_active[q] != 0;
    int total;
    kat_block_excl_scan(c, &total);  // synchronises: the staged keys are ready after it
    if (threadIdx.x == 0) *s.nq = total;
  } else {
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= Q) return;
  const unsigned long long mine = staged ? keys[i] : queue_key(s, q_active, alloc, i);
  int before = 0;
  for (int j = lane; j < Q; j += 32) {
    const unsigned long long kj = staged ? keys[j] : queue_key(s, q_active, alloc, j);
    before += (kj < mine) | ((kj == mine) & (j < i));
  }
  before = __reduce_add_sync(0xffffffffu, before);
  if (lane == 0) s.perm[before] = (long long)i;
}

}  // namespace

extern "C" int kat_queue_order(const void* static_args, const uint8_t* q_active,
                               const float* alloc, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const size_t smem = s.variant == V_STAGED ? (size_t)s.Q * sizeof(unsigned long long) : 0;
  static size_t smem_set = 48 * 1024;  // raised once per size, not per launch
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        queue_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = s.Q > 0 ? (s.Q + WARPS - 1) / WARPS : 1;
  queue_order_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(s, q_active, alloc);
  return (int)cudaGetLastError();
}
