// K10 turn_fill: one immediate-path turn's fill, node writeback and task
// decode.
//
// Replaces the second half of kube_arbitrator_tpu/ops/allocate.py:
// _process_queue (:623-706): use_rel (the releasing fallback when no
// idle capacity is left anywhere and the budget is positive); the int32
// prefix fill p = clip(placed_total - exclusive prefix, 0, k) of
// placed_total = min(budget, sum k) in packing order; p scattered back to
// node order into node_idle or node_releasing (p * req subtracted,
// rounded apart), node_num_tasks and node_ports; the slot -> node map
// (searchsorted of the slot over the inclusive prefix, through the
// packing order); and the decode of the group's pending tasks by rank,
// ALLOCATED (or PIPELINED on the fallback) on their slot's node.
//
// The node phase (both routes): a CTA of 32 warps, warp w on a
// contiguous run of positions, its lanes on neighbouring positions
// (coalesced).  A first pass loads both capacity rows into registers
// (all loads in flight together) and sums them per warp; one combine of
// the 32 warp totals gives use_rel, placed_total and each warp's base; a
// second pass scans the chosen row from the registers 32 positions at a
// time (a warp-shuffle int32 scan carried across the run: exact in any
// order) and writes each position's fill.
//
// The decode, two routes chosen when the plan is bound:
// * by_group: the pack ranks each group's valid tasks densely by uid
//   (0..n-1), so the plan builds a group -> task index in rank order
//   once per action (kat_turn_fill_index: counts, their scan, each task
//   scattered to gstart[g] + rank, every index slot checked to be written
//   exactly once on the device; the plan reads the check once).  The
//   turn's CTA writes the slot -> node map into plan scratch for the
//   slots it fills, then decodes only the placed_total tasks at
//   gidx[gstart[g] + group_placed[g] + s] — not the whole task axis.  One
//   CTA, one launch.
// * walk: for a pack whose ranks fail the check.  The whole task axis,
//   spread over CTAs of WALK_TASKS tasks; each CTA runs the node phase
//   itself into an inclusive prefix in shared memory (only CTA 0 writes
//   the node state and the outputs) and finds a task's node by binary
//   search over it, so no CTA waits for another.
// The reference's edge cases hold in both: a slot >= s_max takes the
// node of slot s_max - 1; a rank past the group's count assigns nothing.
//
// Bound: bytes — the two capacity rows and the order read, the touched
// node rows written, the group's tasks written (by_group; walk reads the
// task axis's group, rank and validity too): ~0.2 MB at N = 10,240 by
// group (~0.06 us), ~1.3 MB walking T = 102,400 (~0.4 us).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int WALK_TASKS = 4096;  // tasks a walk CTA decodes
constexpr int KREG = 12;          // positions of each row a lane keeps in registers
constexpr int kAllocated = 1, kPipelined = 2;  // api/types.TaskStatus
enum { V_BY_GROUP = 0, V_WALK = 1 };

// the plan's fixed arguments (turn_fill.py's _Static mirrors this layout)
struct Static {
  const int* k_rows;          // i32[2, N] idle / releasing capacity, packing order
  const int* nperm;           // i32[N] node at each position, or null (first fit)
  const int* group_ports;     // i32[G, W]
  const int* group_placed;    // i32[G]
  float* idle;                // f32[N, R]
  float* rel;                 // f32[N, R]
  int* node_ports;            // i32[N, W]
  int* node_num_tasks;        // i32[N]
  const int* task_group;      // i32[T]
  const int* task_group_rank; // i32[T]
  const uint8_t* task_valid;  // bool[T]
  int* task_status;           // i32[T]
  int* task_node;             // i32[T]
  int* node_of_slot;          // i32[s_max] by_group scratch
  const int* gstart;          // i32[G + 1] by_group index starts
  const int* gidx;            // i32[T] by_group index: tasks in (group, rank) order
  int* placed;                // i32[1] out
  uint8_t* use_rel;           // bool[1] out
  int N, R, W, T, s_max, best_effort, preds_on, variant;
};

struct Fill {
  int placed_total;
  bool use_rel;
};

// The node phase; at(i, run, ki, fill) for every position i with its
// exclusive prefix run in the chosen row.  Called by all THREADS threads.
// A lane's first KREG positions of both rows stay in registers between
// the passes (every position up to N = THREADS * KREG); past them the
// second pass reads the row again.
template <typename At>
__device__ __forceinline__ Fill node_phase(const Static& s, int budget, At at) {
  __shared__ int tot[WARPS][2];
  const int N = s.N, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int iters = (N + THREADS - 1) / THREADS;  // positions a lane owns
  const int lo = min(N, warp * iters * 32), hi = min(N, lo + iters * 32);
  int k0[KREG], k1[KREG];
  int si = 0, sr = 0;
#pragma unroll
  for (int it = 0; it < KREG; ++it) {
    const int i = lo + it * 32 + lane;
    const bool in = it < iters && i < hi;
    k0[it] = in ? s.k_rows[i] : 0;
    k1[it] = in ? s.k_rows[(size_t)N + i] : 0;
    si += k0[it];
    sr += k1[it];
  }
  for (int it = KREG; it < iters; ++it) {
    const int i = lo + it * 32 + lane;
    if (i < hi) {
      si += s.k_rows[i];
      sr += s.k_rows[(size_t)N + i];
    }
  }
  si = __reduce_add_sync(0xffffffffu, si);
  sr = __reduce_add_sync(0xffffffffu, sr);
  if (lane == 0) {
    tot[warp][0] = si;
    tot[warp][1] = sr;
  }
  __syncthreads();
  int total_idle = 0;
  for (int w = 0; w < WARPS; ++w) total_idle += tot[w][0];
  Fill f;
  f.use_rel = !s.best_effort && total_idle == 0 && budget > 0;
  const int row = f.use_rel ? 1 : 0;
  int carry = 0, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int t = tot[w][row];
    carry += w < warp ? t : 0;
    total += t;
  }
  f.placed_total = min(budget, total);
  // one step of the warp's scan: 32 positions, carried
  auto step = [&](int it, int ki) {
    const int i = lo + it * 32 + lane;
    int x = ki;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (i < hi) at(i, carry + x - ki, ki, f);
    carry += __shfl_sync(0xffffffffu, x, 31);
  };
#pragma unroll
  for (int it = 0; it < KREG; ++it) {
    if (it < iters) step(it, f.use_rel ? k1[it] : k0[it]);  // warp-uniform
  }
  const int* k = s.k_rows + (f.use_rel ? (size_t)N : 0);
  for (int it = KREG; it < iters; ++it) {
    const int i = lo + it * 32 + lane;
    step(it, i < hi ? k[i] : 0);
  }
  return f;
}

// position i's fill p written back to its node (only where p > 0)
__device__ __forceinline__ void write_node(const Static& s, int i, int run, int ki, const Fill& f,
                                           const float* __restrict__ req, const int* gports,
                                           bool has_ports) {
  const int p = min(max(f.placed_total - run, 0), ki);
  if (p <= 0) return;
  const int n = s.nperm ? s.nperm[i] : i;
  float* avail = f.use_rel ? s.rel : s.idle;
  const float pf = __int2float_rn(p);
  for (int r = 0; r < s.R; ++r) {
    float* a = avail + (size_t)n * s.R + r;
    *a = __fsub_rn(*a, __fmul_rn(pf, req[r]));
  }
  s.node_num_tasks[n] += p;
  if (has_ports)
    for (int w = 0; w < s.W; ++w) s.node_ports[(size_t)n * s.W + w] |= gports[w];
}

__device__ __forceinline__ bool group_has_ports(const Static& s, const int* gports) {
  bool has = false;
  if (s.preds_on)
    for (int w = 0; w < s.W; ++w) has |= gports[w] != 0;
  return has;
}

__global__ void __launch_bounds__(THREADS) fill_by_group_kernel(
    Static s, const void* g_p, int g_wide, const float* __restrict__ req,
    const int* __restrict__ budget_p) {
  const int g = kat_read_index(g_p, g_wide);
  const int budget = *budget_p;
  // the decode's scalars, read now: their latency hides behind the scan
  const int before = s.group_placed[g];
  const int g0 = s.gstart[g], g1 = s.gstart[g + 1];
  const int* gports = s.group_ports + (size_t)g * s.W;
  const bool has_ports = group_has_ports(s, gports);
  const Fill f = node_phase(s, budget, [&](int i, int run, int ki, const Fill& ff) {
    write_node(s, i, run, ki, ff, req, gports, has_ports);
    const int end = min(run + ki, min(ff.placed_total, s.s_max));
    const int n = s.nperm ? s.nperm[i] : i;
    for (int sl = run; sl < end; ++sl) s.node_of_slot[sl] = n;
  });
  __syncthreads();  // the slot -> node map is complete
  const int m = min(f.placed_total, g1 - g0 - before);
  const int status = f.use_rel ? kPipelined : kAllocated;
  for (int sl = threadIdx.x; sl < m; sl += THREADS) {
    const int t = s.gidx[g0 + before + sl];
    s.task_status[t] = status;
    s.task_node[t] = s.node_of_slot[min(sl, s.s_max - 1)];
  }
  if (threadIdx.x == 0) {
    *s.placed = f.placed_total;
    *s.use_rel = f.use_rel ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS) fill_walk_kernel(
    Static s, const void* g_p, int g_wide, const float* __restrict__ req,
    const int* __restrict__ budget_p) {
  extern __shared__ int cum[];  // [N] inclusive prefix of the chosen row
  const int g = kat_read_index(g_p, g_wide);
  const int budget = *budget_p, before = s.group_placed[g];
  const bool lead = blockIdx.x == 0;
  const int* gports = s.group_ports + (size_t)g * s.W;
  const bool has_ports = lead && group_has_ports(s, gports);
  const Fill f = node_phase(s, budget, [&](int i, int run, int ki, const Fill& ff) {
    cum[i] = run + ki;
    if (lead) write_node(s, i, run, ki, ff, req, gports, has_ports);
  });
  __syncthreads();
  const int status = f.use_rel ? kPipelined : kAllocated;
  const int t_end = min(s.T, (blockIdx.x + 1) * WALK_TASKS);
  for (int t = blockIdx.x * WALK_TASKS + threadIdx.x; t < t_end; t += THREADS) {
    if (s.task_group[t] != g || !s.task_valid[t]) continue;
    const int slot = s.task_group_rank[t] - before;
    if (slot < 0 || slot >= f.placed_total) continue;
    const int q = min(slot, s.s_max - 1);
    int a = 0, b = s.N;  // the first position whose inclusive prefix passes q
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (cum[mid] > q) b = mid; else a = mid + 1;
    }
    s.task_status[t] = status;
    s.task_node[t] = s.nperm ? s.nperm[min(a, s.N - 1)] : a;
  }
  if (lead && threadIdx.x == 0) {
    *s.placed = f.placed_total;
    *s.use_rel = f.use_rel ? 1 : 0;
  }
}

// ---- the by_group index, built once per plan

__global__ void index_count_kernel(const int* __restrict__ task_group,
                                   const uint8_t* __restrict__ task_valid, int T, int G,
                                   int* __restrict__ gstart) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int g = task_group[t];
  if (task_valid[t] && g >= 0 && g < G) atomicAdd(&gstart[g + 1], 1);
}

// gstart[1..G] from counts to an inclusive scan, in place (one CTA)
__global__ void __launch_bounds__(THREADS) index_scan_kernel(int G, int* __restrict__ gstart) {
  int carry = 0;
  for (int c0 = 1; c0 <= G; c0 += THREADS) {
    const int i = c0 + threadIdx.x;
    const int v = i <= G ? gstart[i] : 0;
    int total;
    const int ex = kat_block_excl_scan(v, &total);
    if (i <= G) gstart[i] = carry + ex + v;
    carry += total;
  }
}

// each member task at gstart[g] + rank; *bad where a rank falls outside
// [0, count) or a slot is taken twice (so no slot is left empty)
__global__ void index_scatter_kernel(const int* __restrict__ task_group,
                                     const int* __restrict__ task_group_rank,
                                     const uint8_t* __restrict__ task_valid, int T, int G,
                                     const int* __restrict__ gstart, int* __restrict__ gidx,
                                     int* __restrict__ hits, int* __restrict__ bad) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int g = task_group[t];
  if (!task_valid[t] || g < 0 || g >= G) return;
  const int g0 = gstart[g], r = task_group_rank[t];
  if (r < 0 || r >= gstart[g + 1] - g0 || atomicAdd(&hits[g0 + r], 1) != 0) {
    *bad = 1;
    return;
  }
  gidx[g0 + r] = t;
}

}  // namespace

extern "C" int kat_turn_fill(const void* static_args, const void* g, int g_wide, const float* req,
                             const int* budget, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  cudaStream_t st = (cudaStream_t)stream;
  if (s.N <= 0 || s.s_max <= 0) return (int)cudaErrorInvalidValue;
  if (s.variant == V_BY_GROUP) {
    fill_by_group_kernel<<<1, THREADS, 0, st>>>(s, g, g_wide, req, budget);
    return (int)cudaGetLastError();
  }
  if (s.variant != V_WALK) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)s.N * sizeof(int);
  static size_t smem_set = 48 * 1024;  // raised once per size, not per launch
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fill_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = max((s.T + WALK_TASKS - 1) / WALK_TASKS, 1);
  fill_walk_kernel<<<grid, THREADS, smem, st>>>(s, g, g_wide, req, budget);
  return (int)cudaGetLastError();
}

extern "C" int kat_turn_fill_index(const int* task_group, const int* task_group_rank,
                                   const uint8_t* task_valid, int T, int G, int* gstart,
                                   int* gidx, int* hits, int* bad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(gstart, 0, (size_t)(G + 1) * sizeof(int), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(hits, 0, (size_t)max(T, 1) * sizeof(int), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const int grid = max((T + 255) / 256, 1);
  index_count_kernel<<<grid, 256, 0, st>>>(task_group, task_valid, T, G, gstart);
  index_scan_kernel<<<1, THREADS, 0, st>>>(G, gstart);
  index_scatter_kernel<<<grid, 256, 0, st>>>(task_group, task_group_rank, task_valid, T, G,
                                             gstart, gidx, hits, bad);
  return (int)cudaGetLastError();
}
