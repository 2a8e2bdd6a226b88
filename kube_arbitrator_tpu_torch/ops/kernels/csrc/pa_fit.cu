// K11 pa_fit: one turn's pod-(anti-)affinity fit of group g.
//
// Replaces kube_arbitrator_tpu/ops/podaffinity.py:pod_affinity_fit
// (:73-170): per-domain counts of the pods placed earlier this cycle for
// each of the group's affinity and anti-affinity terms (dyn_count), the
// dynamic symmetry over placed pods' own anti terms (term_block), the
// static symmetry table, and the ok mask over nodes; plus the group's
// seed and cap flags (first-pod self-affinity, self-anti-affinity).
//
// Two entry points, two grids:
//   pa_count_kernel  one thread per task: a pod placed this cycle (PENDING
//                    in the snapshot, now ALLOCATED or PIPELINED on a node)
//                    adds 1 to the count of each of the group's terms whose
//                    selector matches its class, at its node's domain of
//                    the term's key, and marks its node's domain of each of
//                    its own anti terms that matches the group's class.
//                    Integer atomics: exact in any order.  The marks live
//                    on the GLOBAL domain axis (a domain ordinal belongs to
//                    one topology key), so one [D] array serves every term.
//   pa_fit_kernel    one thread per node: the affinity terms (count or the
//                    first-pod case), the anti terms, the marks under every
//                    key, symm_ok; thread 0 writes the flags.
//
// Bound: bytes — per task the snapshot status, status, node, validity,
// group and class (21 B) read once, per node K domain ordinals and one ok
// byte: ~1.1 MB at T = 51,200, N = 5,120, K = 3.  The launches (~5 us
// each) are the floor at these sizes.
#include "common.cuh"

namespace {

constexpr int kPending = 0, kAllocated = 1, kPipelined = 2;  // api/types.TaskStatus

__global__ void pa_count_kernel(
    const int* __restrict__ g_p, const int* __restrict__ snap_status,
    const int* __restrict__ status, const int* __restrict__ task_node,
    const uint8_t* __restrict__ task_valid, const int* __restrict__ task_group,
    const int* __restrict__ task_pa_class, const int* __restrict__ group_pa_class,
    const int* __restrict__ gaff, int MA, const int* __restrict__ ganti, int MB,
    const int* __restrict__ aff_key, const int* __restrict__ anti_key,
    const uint8_t* __restrict__ aff_match, const uint8_t* __restrict__ anti_match, int CP,
    const int* __restrict__ node_dom, int N, int D, int T, int TA,
    int* __restrict__ dyn, int* __restrict__ any_aff, int* __restrict__ marks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int s = status[t], n = task_node[t];
  if (snap_status[t] != kPending || (s != kAllocated && s != kPipelined) || n < 0 ||
      !task_valid[t])
    return;
  const int g = *g_p;
  const int cp = task_pa_class[t];
  for (int m = 0; m < MA; ++m) {
    const int term = gaff[(size_t)g * MA + m];
    if (term < 0) continue;
    const int d = node_dom[(size_t)aff_key[term] * N + n];
    if (d >= 0 && aff_match[(size_t)term * CP + cp]) {
      atomicAdd(&dyn[(size_t)m * D + d], 1);
      atomicOr(&any_aff[m], 1);
    }
  }
  for (int m = 0; m < MB; ++m) {
    const int term = ganti[(size_t)g * MB + m];
    if (term < 0) continue;
    const int d = node_dom[(size_t)anti_key[term] * N + n];
    if (d >= 0 && anti_match[(size_t)term * CP + cp]) atomicAdd(&dyn[(size_t)(MA + m) * D + d], 1);
  }
  const int tg = task_group[t];
  if (TA > 0 && tg >= 0) {
    const int cpg = group_pa_class[g];
    for (int m = 0; m < MB; ++m) {
      const int term = ganti[(size_t)tg * MB + m];
      if (term < 0 || !anti_match[(size_t)term * CP + cpg]) continue;
      const int d = node_dom[(size_t)anti_key[term] * N + n];
      if (d >= 0) atomicOr(&marks[d], 1);
    }
  }
}

__global__ void pa_fit_kernel(
    const int* __restrict__ g_p, const int* __restrict__ group_pa_class,
    const int* __restrict__ gaff, int MA, const int* __restrict__ ganti, int MB,
    const int* __restrict__ aff_key, const int* __restrict__ anti_key,
    const int* __restrict__ aff_static, const int* __restrict__ anti_static,
    const int* __restrict__ aff_static_total, const uint8_t* __restrict__ aff_match,
    const uint8_t* __restrict__ anti_match, int CP, const int* __restrict__ node_dom, int K,
    int N, int D, int TA, const uint8_t* __restrict__ symm_ok, int CS,
    const int* __restrict__ dyn, const int* __restrict__ any_aff,
    const int* __restrict__ marks, uint8_t* __restrict__ ok_out,
    uint8_t* __restrict__ seed_flags, int* __restrict__ seed_keys,
    uint8_t* __restrict__ cap_flags, int* __restrict__ cap_keys) {
  const int g = *g_p;
  const int cpg = group_pa_class[g];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n == 0) {
    for (int m = 0; m < MA; ++m) {
      const int term = gaff[(size_t)g * MA + m];
      const int tc = max(term, 0);
      const bool any_match = aff_static_total[tc] > 0 || any_aff[m] != 0;
      seed_flags[m] = term >= 0 && !any_match && aff_match[(size_t)tc * CP + cpg];
      seed_keys[m] = aff_key[tc];
    }
    for (int m = 0; m < MB; ++m) {
      const int term = ganti[(size_t)g * MB + m];
      const int tc = max(term, 0);
      cap_flags[m] = term >= 0 && anti_match[(size_t)tc * CP + cpg];
      cap_keys[m] = anti_key[tc];
    }
  }
  if (n >= N) return;
  bool ok = true;
  for (int m = 0; m < MA; ++m) {
    const int term = gaff[(size_t)g * MA + m];
    if (term < 0) continue;
    const int nd = node_dom[(size_t)aff_key[term] * N + n];
    const bool any_match = aff_static_total[term] > 0 || any_aff[m] != 0;
    const bool self_seed = !any_match && aff_match[(size_t)term * CP + cpg];
    const bool hit =
        nd >= 0 && aff_static[(size_t)term * D + nd] + dyn[(size_t)m * D + nd] > 0;
    ok = ok && nd >= 0 && (hit || self_seed);
  }
  for (int m = 0; m < MB; ++m) {
    const int term = ganti[(size_t)g * MB + m];
    if (term < 0) continue;
    const int nd = node_dom[(size_t)anti_key[term] * N + n];
    if (nd >= 0 && anti_static[(size_t)term * D + nd] + dyn[(size_t)(MA + m) * D + nd] > 0)
      ok = false;
  }
  if (TA > 0) {
    for (int k = 0; k < K; ++k) {
      const int nd = node_dom[(size_t)k * N + n];
      if (nd >= 0 && marks[nd]) ok = false;
    }
  }
  if (CS > 0) ok = ok && symm_ok[(size_t)min(max(cpg, 0), CS - 1) * N + n];
  ok_out[n] = ok ? 1 : 0;
}

}  // namespace

extern "C" int kat_pa_fit(
    const int* g, const int* snap_status, const int* status, const int* task_node,
    const uint8_t* task_valid, const int* task_group, const int* task_pa_class,
    const int* group_pa_class, const int* gaff, int MA, const int* ganti, int MB,
    const int* aff_key, const int* anti_key, const int* aff_static, const int* anti_static,
    const int* aff_static_total, const uint8_t* aff_match, const uint8_t* anti_match, int CP,
    const int* node_dom, int K, int N, int D, int T, int TA, const uint8_t* symm_ok, int CS,
    int* dyn, int* any_aff, int* marks, uint8_t* ok_out, uint8_t* seed_flags, int* seed_keys,
    uint8_t* cap_flags, int* cap_keys, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 0) {
    pa_count_kernel<<<(T + 255) / 256, 256, 0, s>>>(
        g, snap_status, status, task_node, task_valid, task_group, task_pa_class,
        group_pa_class, gaff, MA, ganti, MB, aff_key, anti_key, aff_match, anti_match, CP,
        node_dom, N, D, T, TA, dyn, any_aff, marks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  pa_fit_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      g, group_pa_class, gaff, MA, ganti, MB, aff_key, anti_key, aff_static, anti_static,
      aff_static_total, aff_match, anti_match, CP, node_dom, K, N, D, TA, symm_ok, CS, dyn,
      any_aff, marks, ok_out, seed_flags, seed_keys, cap_flags, cap_keys);
  return (int)cudaGetLastError();
}
