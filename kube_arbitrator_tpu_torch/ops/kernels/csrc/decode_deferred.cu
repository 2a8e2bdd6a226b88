// K3 decode_deferred: [G, N] placement counts -> task -> node, in place.
//
// Replaces kube_arbitrator_tpu/ops/allocate.py:_decode_deferred
// (:1059-1131) and its gate (:1254-1257).  A group's pending tasks are
// interchangeable, so the task of rank r (uid order, offset by what
// earlier actions placed) goes to the first node whose inclusive count
// along its group's row exceeds r: allocated counts first (gn_a), then
// pipelined ones (gn_p, rank r - total_a, for tasks the first pass
// missed).  Integer-exact.
//
// The gate is read on the device: nothing happens unless any_a | any_p,
// and the pipelined pass runs only when any_p is set and gn_p exists
// (backfill passes none), as the reference's lax.cond does.
//
// One cooperative launch, two phases joined by a grid barrier (the
// reference's own two-level design, one level deeper):
//   phase 1  a warp a (matrix, row, BLOCK-chunk block) item: the block's
//            BLOCK * CHUNK cells read once with coalesced loads (16 bytes
//            a lane when N % 4 == 0, all issued before any sum), each
//            CHUNK-cell chunk summed by a shuffle over its lanes, and the
//            chunk sums and the block's sum written to the plan's scratch.
//            Warps stream independently: no CTA barrier, no scan;
//   phase 2  a lane a task: its row's block sums (NB of them, LEVEL1
//            loads at a time) give the row's total and the block holding
//            the rank, the block's BLOCK chunk sums the chunk, and one
//            CHUNK-cell walk the node — three dependent round trips where
//            a binary search of the row would take fourteen.  A lane
//            reads and writes only its own task's status and node, so the
//            result is written in place.  (Eight lanes walking a chunk
//            with one coalesced load measured no faster.)
// The plan (decode_deferred.py's DecodePlan) binds the pack's task arrays,
// the action's counts, entry_placed, status / node and its own scratch
// once per allocate action; a launch passes only the two flags.
//
// Bound: bytes — each count matrix the launch reads once (2 * 4 * G * N:
// ~84 MB at G = 1,024, N = 10,240, ~25 us at 3.35 TB/s; half without
// gn_p), plus each task's group, rank and valid flag read and status /
// node written where a task lands (the rest are not read).  The
// scratch is 4 * G * (NB * BLOCK + NB) bytes a matrix (1.3 MB at that
// shape), read by phase 2 from L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;   // cells a chunk (decode_deferred.py's CHUNK)
constexpr int BLOCK = 32;   // chunks a block: one warp's item (decode_deferred.py's BLOCK)
constexpr int LEVEL1 = 16;  // block sums a task loads at once (N <= 16,384: one round)
constexpr int MIN_CTAS = 4; // CTAs an SM holds: 135k threads, one task each at T = 102,400
// A spin that outlasts this many polls means the co-residency the launch
// was granted failed: trap (a launch error) rather than hang the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

// the plan's fixed arguments (decode_deferred.py's _Static mirrors this layout)
struct Static {
  const int* gn_a;             // i32[G, N] allocated counts
  const int* gn_p;             // i32[G, N] pipelined counts, or null (backfill)
  int* csum;                   // i32[2, G, NB * BLOCK] scratch: chunk sums (0 past N)
  int* bsum;                   // i32[2, G, NB] scratch: block sums
  unsigned* ticket;            // [1] the grid barrier's arrivals, zero between launches
  const int* task_group;       // i32[T]
  const int* task_group_rank;  // i32[T]
  const uint8_t* task_valid;   // bool[T]
  const int* entry_placed;     // i32[G] group_placed at the action's entry
  int* status;                 // i32[T] read and written in place
  int* node;                   // i32[T] read and written in place
  int G, N, NB, T, vec, allocated, pipelined;  // NB: ceil(N / (BLOCK * CHUNK))
};

// a launch's own arguments (decode_deferred.py's _Call mirrors this layout)
struct Call {
  const uint8_t* any_a;        // bool scalar: a turn allocated
  const uint8_t* any_p;        // bool scalar: a turn pipelined
};

// Block b of ``row`` (cells [b * BLOCK * CHUNK, ...) below N) -> its
// BLOCK chunk sums at csum[0, BLOCK) and its sum at *bsum, by one warp.
// VEC: lane l's j-th load is int4 j * 32 + l of the block (coalesced), so
// eight lanes hold a chunk; else lane l sums chunk l cell by cell.
template <bool VEC>
__device__ __forceinline__ void block_sums(const int* __restrict__ row, int N, int b,
                                           int* __restrict__ csum, int* __restrict__ bsum) {
  const int lane = threadIdx.x & 31;
  const int lo = b * BLOCK * CHUNK;
  int total = 0;
  if (VEC) {
    constexpr int LOADS = BLOCK * CHUNK / 4 / 32;  // int4s a lane
    const int4* p = reinterpret_cast<const int4*>(row + lo);
    int v[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int u = j * 32 + lane;
      v[j] = 0;
      if (lo + 4 * u < N) {
        const int4 q = __ldg(p + u);
        v[j] = q.x + q.y + q.z + q.w;
      }
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      int x = v[j];
      total += x;
#pragma unroll
      for (int o = CHUNK / 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if ((lane & (CHUNK / 4 - 1)) == 0) csum[(j * 32 + lane) / (CHUNK / 4)] = x;
    }
  } else {
    const int c0 = lo + lane * CHUNK;
#pragma unroll 8
    for (int i = 0; i < CHUNK; ++i) total += c0 + i < N ? __ldg(row + c0 + i) : 0;
    csum[lane] = total;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0) *bsum = total;
}

// Levels 1-2 of rank r in a row: its block sums (the row's total to
// *total, LEVEL1 loads at a time), then the chunk sums of the block
// holding r.  True when r is below the total: *c is the chunk holding r
// and *r_in r less the counts before that chunk.
__device__ __forceinline__ bool find_chunk(const int* csum, const int* bsum, int NB, int r,
                                           int* total, int* c, int* r_in) {
  int run = 0, b = -1, before = 0;
  for (int b0 = 0; b0 < NB; b0 += LEVEL1) {
    int v[LEVEL1];
#pragma unroll
    for (int i = 0; i < LEVEL1; ++i) v[i] = b0 + i < NB ? __ldcg(bsum + b0 + i) : 0;
#pragma unroll
    for (int i = 0; i < LEVEL1; ++i) {
      if (b < 0 && run + v[i] > r) {
        b = b0 + i;
        before = run;
      }
      run += v[i];
    }
  }
  *total = run;
  if (r < 0 || r >= run) return false;
  const int4* cs = reinterpret_cast<const int4*>(csum + b * BLOCK);
  int4 q[BLOCK / 4];
#pragma unroll
  for (int i = 0; i < BLOCK / 4; ++i) q[i] = __ldcg(cs + i);
  int k = -1;
#pragma unroll
  for (int i = 0; i < BLOCK / 4; ++i) {
    const int v[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k < 0 && before + v[j] > r) k = 4 * i + j;
      if (k < 0) before += v[j];
    }
  }
  *c = b * BLOCK + k;
  *r_in = r - before;
  return true;
}

// Level 3: the first node n of chunk c with sum(row[c * CHUNK .. n]) >
// r_in, the chunk's loads (eight int4, or 32 cells) issued first.
template <bool VEC>
__device__ __forceinline__ int chunk_walk(const int* __restrict__ row, int N, int c, int r_in) {
  const int lo = c * CHUNK, hi = min(lo + CHUNK, N);
  int acc = 0;
  if (VEC) {
    int4 q[CHUNK / 4];
#pragma unroll
    for (int i = 0; i < CHUNK / 4; ++i)
      q[i] = lo + 4 * i < hi ? __ldg(reinterpret_cast<const int4*>(row + lo) + i)
                             : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < CHUNK / 4; ++i) {
      const int n = lo + 4 * i;
      if ((acc += q[i].x) > r_in) return n;
      if ((acc += q[i].y) > r_in) return n + 1;
      if ((acc += q[i].z) > r_in) return n + 2;
      if ((acc += q[i].w) > r_in) return n + 3;
    }
  } else {
    int q[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) q[i] = lo + i < hi ? __ldg(row + lo + i) : 0;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if ((acc += q[i]) > r_in) return lo + i;
    }
  }
  return hi - 1;
}

// task t's group (clamped) and rank within it, or false when t has no
// valid group
__device__ __forceinline__ bool task_rank(const Static& s, int t, int* g, int* r0) {
  const int tg = s.task_group[t];
  if (tg < 0 || s.task_valid[t] == 0) return false;
  *g = min(tg, s.G - 1);
  *r0 = s.task_group_rank[t] - s.entry_placed[*g];
  return true;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) decode_kernel(const Static s, const Call c) {
  __shared__ bool last;
  const bool go_p = *c.any_p != 0;
  if (!(*c.any_a != 0 || go_p)) return;  // uniform: no CTA reaches the barrier
  const bool pipe = go_p && s.gn_p != nullptr;
  const int tid = threadIdx.x, lane = tid & 31;
  const int CP = s.NB * BLOCK;  // chunk sums a row
  // phase 1: a warp a block of a row, gn_p's rows first so that gn_a's,
  // which most tasks walk, are the ones left in L2
  const int items = (pipe ? 2 : 1) * s.G * s.NB;
  for (int it = blockIdx.x * WARPS + (tid >> 5); it < items; it += gridDim.x * WARPS) {
    const int k = pipe ? (it + s.G * s.NB) % items : it;
    const int rowi = k / s.NB, b = k - rowi * s.NB;  // rowi = m * G + g
    const int m = rowi >= s.G, g = rowi - m * s.G;
    block_sums<VEC>((m ? s.gn_p : s.gn_a) + (size_t)g * s.N, s.N, b,
                    s.csum + (size_t)rowi * CP + b * BLOCK, s.bsum + (size_t)rowi * s.NB + b);
  }
  // a warp takes 32 tasks at a time; its lanes' first tasks are read
  // before the barrier (they need no sums)
  const int stride = gridDim.x * THREADS;
  int base = blockIdx.x * THREADS + (tid & ~31), g = 0, r0 = 0;
  bool ok = base + lane < s.T && task_rank(s, base + lane, &g, &r0);
  // grid barrier: every block's sums before any task's lookup
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(s.ticket, 1u);
    for (unsigned spin = 0; __ldcv(s.ticket) < gridDim.x; ++spin) {
      if (spin > SPIN_LIMIT) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  // phase 2: a lane a task, allocated else pipelined
  for (; base < s.T; base += stride) {  // uniform across the warp
    const int t = base + lane;
    int m = -1, cc = 0, r_in = 0, total_a = 0, total_p;
    if (ok) {
      const size_t rp = (size_t)s.G + g;
      if (find_chunk(s.csum + (size_t)g * CP, s.bsum + (size_t)g * s.NB, s.NB, r0, &total_a,
                     &cc, &r_in)) {
        m = 0;
      } else if (pipe && find_chunk(s.csum + rp * CP, s.bsum + rp * s.NB, s.NB, r0 - total_a,
                                    &total_p, &cc, &r_in)) {
        m = 1;
      }
    }
    if (m >= 0) {
      s.status[t] = m ? s.pipelined : s.allocated;
      s.node[t] = chunk_walk<VEC>((m ? s.gn_p : s.gn_a) + (size_t)g * s.N, s.N, cc, r_in);
    }
    ok = base + stride + lane < s.T && task_rank(s, base + stride + lane, &g, &r0);
  }
  // the last CTA out zeroes the barrier word for the next launch
  __syncthreads();
  if (tid == 0) last = atomicAdd(s.ticket, 1u) == 2 * gridDim.x - 1;
  __syncthreads();
  if (last && tid == 0) *s.ticket = 0;
}

template <bool VEC>
int launch(const Static& s, const Call& c, cudaStream_t stream) {
  // CTAs that are resident together (the launch is cooperative: its CTAs
  // meet at a grid barrier), no more than a warp a block item or a thread
  // a task asks for
  static int resident = 0;
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel<VEC>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int items = (s.gn_p != nullptr ? 2 : 1) * s.G * s.NB;
  const int work = max((items + WARPS - 1) / WARPS, (s.T + THREADS - 1) / THREADS);
  const int grid = max(1, min(work, resident));
  void* args[] = {(void*)&s, (void*)&c};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)decode_kernel<VEC>, dim3(grid),
                                                    dim3(THREADS), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kat_decode_deferred(const void* static_args, const void* call_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Call& c = *static_cast<const Call*>(call_args);
  cudaStream_t st = (cudaStream_t)stream;
  return s.vec ? launch<true>(s, c, st) : launch<false>(s, c, st);
}
