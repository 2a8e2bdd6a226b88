// K3 decode_deferred: [G, N] placement counts -> task -> node.
//
// Replaces kube_arbitrator_tpu/ops/allocate.py:_decode_deferred
// (:1059-1131).  A group's pending tasks are interchangeable, so the task
// of rank r (uid order, offset by what earlier actions placed) goes to the
// first node whose inclusive count along its group's row exceeds r:
// allocated counts first (gn_a), then pipelined ones (gn_p, rank
// r - total_a, for tasks the first pass missed).  The reference reaches
// the same node through a two-level chunked cumsum + searchsorted; here
// each row gets an int32 inclusive scan (one block per row), then one
// thread per task binary-searches its row.  Integer-exact either way.
//
// Bound: bytes — each count matrix read once and its scan written once
// (2 * 4 * G * N per matrix: ~80 MB at G = 1k, N = 10k, ~24 us at
// 3.35 TB/s per matrix), plus the task arrays.  The scan scratch is
// allocated by the wrapper.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024) row_scan_kernel(
    const int* __restrict__ gn, int N, int* __restrict__ out) {
  const size_t g = blockIdx.x;
  const int* row = gn + g * N;
  int* orow = out + g * N;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, N);
  const int hi = min(lo + per, N);
  int tsum = 0;
  for (int m = lo; m < hi; ++m) tsum += row[m];
  int total;
  int run = kat_block_excl_scan(tsum, &total);
  for (int m = lo; m < hi; ++m) {
    run += row[m];
    orow[m] = run;
  }
}

// first n in [0, N) with inc[n] > r (callers guarantee inc[N-1] > r)
__device__ __forceinline__ int upper_bound(const int* inc, int N, int r) {
  int lo = 0, hi = N - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (inc[mid] > r) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void task_lookup_kernel(
    const int* __restrict__ scan_a, const int* __restrict__ scan_p, int N,
    const int* __restrict__ task_group, const int* __restrict__ task_group_rank,
    const uint8_t* __restrict__ task_valid, const int* __restrict__ entry_placed,
    const int* __restrict__ status_in, const int* __restrict__ node_in, int T,
    int* __restrict__ status_out, int* __restrict__ node_out, int allocated,
    int pipelined) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int tg = task_group[t];
  const size_t gq = tg > 0 ? tg : 0;
  const bool in_group = tg >= 0 && task_valid[t] != 0;
  const int r0 = task_group_rank[t] - entry_placed[gq];
  int status = status_in[t], node = node_in[t];
  const int* ra = scan_a + gq * N;
  const int total_a = ra[N - 1];
  if (in_group && r0 >= 0 && r0 < total_a) {
    status = allocated;
    node = upper_bound(ra, N, r0);
  } else if (scan_p != nullptr) {
    const int r1 = r0 - total_a;
    const int* rp = scan_p + gq * N;
    if (in_group && r1 >= 0 && r1 < rp[N - 1]) {
      status = pipelined;
      node = upper_bound(rp, N, r1);
    }
  }
  status_out[t] = status;
  node_out[t] = node;
}

}  // namespace

extern "C" int kat_decode_deferred(
    const int* gn_a, const int* gn_p, int G, int N, int* scan_a, int* scan_p,
    const int* task_group, const int* task_group_rank,
    const uint8_t* task_valid, const int* entry_placed,
    const int* status_in, const int* node_in, int T, int* status_out,
    int* node_out, int allocated, int pipelined, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  row_scan_kernel<<<G, 1024, 0, s>>>(gn_a, N, scan_a);
  if (gn_p != nullptr) row_scan_kernel<<<G, 1024, 0, s>>>(gn_p, N, scan_p);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (T > 0) {
    task_lookup_kernel<<<(T + 255) / 256, 256, 0, s>>>(
        scan_a, gn_p != nullptr ? scan_p : nullptr, N, task_group,
        task_group_rank, task_valid, entry_placed, status_in, node_in, T,
        status_out, node_out, allocated, pipelined);
  }
  return (int)cudaGetLastError();
}
