// K11 pa_fit: one turn's pod-(anti-)affinity fit of group g.
//
// Replaces kube_arbitrator_tpu/ops/podaffinity.py:pod_affinity_fit
// (:73-170): per-domain counts of the pods placed earlier this cycle for
// each of the group's affinity and anti-affinity terms (dyn_count), the
// dynamic symmetry over placed pods' own anti terms (term_block), the
// static symmetry table, and the ok mask over nodes; plus the group's
// seed and cap flags (first-pod self-affinity, self-anti-affinity).
//
// One cooperative launch, two phases joined by a grid barrier:
//   count  one thread per task: a pod placed this cycle (PENDING in the
//          snapshot, now ALLOCATED or PIPELINED on a node) adds 1 to the
//          count of each of the group's terms whose selector matches its
//          class, at its node's domain of the term's key, and marks its
//          node's domain of each of its own anti terms that matches the
//          group's class.  Integer atomics: exact in any order.  The marks
//          live on the GLOBAL domain axis (a domain ordinal belongs to one
//          topology key), so one [D] array serves every term.
//   fit    after the barrier (each CTA fences its counts before it
//          arrives), one thread per node over the whole grid: the affinity
//          terms (count or the first-pod case), the anti terms, the marks
//          under every key, symm_ok; CTA 0's thread 0 writes the flags.
//          The last CTA to finish (a second arrival on the same word)
//          zeroes the counts, any_aff and the marks and resets the word,
//          so the next launch (in stream order) finds them zero: the plan
//          zeroes them once, at build.
// A grid barrier rather than a last-CTA-done ticket: with a ticket the
// last CTA fits all N nodes alone (17.0 us of device on one H100 against
// 9.8 us with the barrier: PERF.md).
// The plan (pa_fit.py's PaFitPlan) binds the fixed arguments once per
// action; a launch passes the group (i32 or i64, read as either) and the
// two state arrays that change between turns.
//
// Bound: bytes — per task the snapshot status, status, node, validity,
// group and class (21 B) read once, per node K domain ordinals and one ok
// byte: ~1.1 MB at T = 51,200, N = 5,120, K = 3.  The launch (~5 us) and
// the barrier's round trip are the floor at these sizes.
#include "common.cuh"

namespace {

constexpr int kPending = 0, kAllocated = 1, kPipelined = 2;  // api/types.TaskStatus
constexpr int THREADS = 1024;

// the plan's fixed arguments (pa_fit.py's _Static mirrors this layout)
struct Static {
  const int* snap_status;
  const uint8_t* task_valid;
  const int* task_group;
  const int* task_pa_class;
  const int* group_pa_class;
  const int* gaff;
  const int* ganti;
  const int* aff_key;
  const int* anti_key;
  const int* aff_static;
  const int* anti_static;
  const int* aff_static_total;
  const uint8_t* aff_match;
  const uint8_t* anti_match;
  const int* node_dom;
  const uint8_t* symm_ok;
  int* dyn;           // [(MA + MB) * D] counts, zero between launches
  int* any_aff;       // [MA], zero between launches
  int* marks;         // [D], zero between launches
  unsigned* ticket;   // [1] the barrier's arrivals, zero between launches
  uint8_t* ok_out;    // [N]
  uint8_t* seed_flags;  // [MA]
  int* seed_keys;       // [MA]
  uint8_t* cap_flags;   // [MB]
  int* cap_keys;        // [MB]
  int MA, MB, CP, K, N, D, T, TA, CS;
};

__device__ __forceinline__ void count_task(const Static& s, int g, int t, const int* status,
                                           const int* task_node) {
  const int st = status[t], n = task_node[t];
  if (s.snap_status[t] != kPending || (st != kAllocated && st != kPipelined) || n < 0 ||
      !s.task_valid[t])
    return;
  const int cp = s.task_pa_class[t];
  for (int m = 0; m < s.MA; ++m) {
    const int term = s.gaff[(size_t)g * s.MA + m];
    if (term < 0) continue;
    const int d = s.node_dom[(size_t)s.aff_key[term] * s.N + n];
    if (d >= 0 && s.aff_match[(size_t)term * s.CP + cp]) {
      atomicAdd(&s.dyn[(size_t)m * s.D + d], 1);
      atomicOr(&s.any_aff[m], 1);
    }
  }
  for (int m = 0; m < s.MB; ++m) {
    const int term = s.ganti[(size_t)g * s.MB + m];
    if (term < 0) continue;
    const int d = s.node_dom[(size_t)s.anti_key[term] * s.N + n];
    if (d >= 0 && s.anti_match[(size_t)term * s.CP + cp])
      atomicAdd(&s.dyn[(size_t)(s.MA + m) * s.D + d], 1);
  }
  const int tg = s.task_group[t];
  if (s.TA > 0 && tg >= 0) {
    const int cpg = s.group_pa_class[g];
    for (int m = 0; m < s.MB; ++m) {
      const int term = s.ganti[(size_t)tg * s.MB + m];
      if (term < 0 || !s.anti_match[(size_t)term * s.CP + cpg]) continue;
      const int d = s.node_dom[(size_t)s.anti_key[term] * s.N + n];
      if (d >= 0) atomicOr(&s.marks[d], 1);
    }
  }
}

// node n's verdict; the counts, any_aff and marks are read through L2
// (other CTAs wrote them with atomics during this launch)
__device__ __forceinline__ bool fit_node(const Static& s, int g, int cpg, int n) {
  bool ok = true;
  for (int m = 0; m < s.MA; ++m) {
    const int term = s.gaff[(size_t)g * s.MA + m];
    if (term < 0) continue;
    const int nd = s.node_dom[(size_t)s.aff_key[term] * s.N + n];
    const bool any_match = s.aff_static_total[term] > 0 || __ldcg(&s.any_aff[m]) != 0;
    const bool self_seed = !any_match && s.aff_match[(size_t)term * s.CP + cpg];
    const bool hit =
        nd >= 0 && s.aff_static[(size_t)term * s.D + nd] + __ldcg(&s.dyn[(size_t)m * s.D + nd]) > 0;
    ok = ok && nd >= 0 && (hit || self_seed);
  }
  for (int m = 0; m < s.MB; ++m) {
    const int term = s.ganti[(size_t)g * s.MB + m];
    if (term < 0) continue;
    const int nd = s.node_dom[(size_t)s.anti_key[term] * s.N + n];
    if (nd >= 0 &&
        s.anti_static[(size_t)term * s.D + nd] + __ldcg(&s.dyn[(size_t)(s.MA + m) * s.D + nd]) > 0)
      ok = false;
  }
  if (s.TA > 0) {
    for (int k = 0; k < s.K; ++k) {
      const int nd = s.node_dom[(size_t)k * s.N + n];
      if (nd >= 0 && __ldcg(&s.marks[nd])) ok = false;
    }
  }
  if (s.CS > 0) ok = ok && s.symm_ok[(size_t)min(max(cpg, 0), s.CS - 1) * s.N + n];
  return ok;
}

// A spin that outlasts this many polls means the co-residency the launch
// was granted failed: trap (a launch error) rather than hang the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

__global__ void __launch_bounds__(THREADS) pa_fit_kernel(Static s, const void* g_p, int g_wide,
                                                         const int* __restrict__ status,
                                                         const int* __restrict__ task_node) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int stride = gridDim.x * THREADS;
  const int g = g_wide ? (int)*static_cast<const long long*>(g_p) : *static_cast<const int*>(g_p);
  for (int t = blockIdx.x * THREADS + tid; t < s.T; t += stride) count_task(s, g, t, status, task_node);
  // grid barrier: every CTA's counts before any CTA's fit
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
  const int cpg = s.group_pa_class[g];
  if (blockIdx.x == 0 && tid == 0) {
    for (int m = 0; m < s.MA; ++m) {
      const int term = s.gaff[(size_t)g * s.MA + m];
      const int tc = max(term, 0);
      const bool any_match = s.aff_static_total[tc] > 0 || __ldcg(&s.any_aff[m]) != 0;
      s.seed_flags[m] = term >= 0 && !any_match && s.aff_match[(size_t)tc * s.CP + cpg];
      s.seed_keys[m] = s.aff_key[tc];
    }
    for (int m = 0; m < s.MB; ++m) {
      const int term = s.ganti[(size_t)g * s.MB + m];
      const int tc = max(term, 0);
      s.cap_flags[m] = term >= 0 && s.anti_match[(size_t)tc * s.CP + cpg];
      s.cap_keys[m] = s.anti_key[tc];
    }
  }
  for (int n = blockIdx.x * THREADS + tid; n < s.N; n += stride)
    s.ok_out[n] = fit_node(s, g, cpg, n) ? 1 : 0;
  // the last CTA out (every CTA's reads of the scratch are done) zeroes it
  // and the barrier word for the next launch
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(s.ticket, 1u) == 2 * gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int words = (s.MA + s.MB) * s.D;
  for (int i = tid; i < words; i += THREADS) s.dyn[i] = 0;
  for (int i = tid; i < s.MA; i += THREADS) s.any_aff[i] = 0;
  for (int i = tid; i < s.D; i += THREADS) s.marks[i] = 0;
  if (tid == 0) *s.ticket = 0;
}

}  // namespace

extern "C" int kat_pa_fit(const void* static_args, const void* g, int g_wide, const int* status,
                          const int* task_node, void* stream) {
  Static s = *static_cast<const Static*>(static_args);
  // CTAs that are resident together (the launch is cooperative: its CTAs
  // meet at a grid barrier), at most one task or node a thread
  static int resident = 0;
  if (resident == 0) {
    int dev, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pa_fit_kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int work = max(max(s.T, s.N), 1);
  const int grid = min((work + THREADS - 1) / THREADS, resident);
  void* args[] = {(void*)&s, (void*)&g, (void*)&g_wide, (void*)&status, (void*)&task_node};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)pa_fit_kernel, dim3(grid),
                                                    dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
