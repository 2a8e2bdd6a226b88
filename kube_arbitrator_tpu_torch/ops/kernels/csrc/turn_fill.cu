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
// One block: each thread owns a contiguous run of positions, a block
// int32 scan gives the exact prefix; the slots a position covers are
// written by its thread, and after a barrier the block walks the task
// axis.  Every quantity stays on the device: the turn needs no host read.
//
// Bound: bytes — the capacity row read, the touched node rows written,
// the task axis's group, rank and validity read and the group's tasks
// written: ~1.3 MB at T = 102,400, N = 10,240 (~0.4 us).  One block
// walking 100k tasks is the floor here (a second grid for the decode is
// later work).
#include "common.cuh"

namespace {

constexpr int kAllocated = 1, kPipelined = 2;  // api/types.TaskStatus

__global__ void __launch_bounds__(1024) turn_fill_kernel(
    const int* __restrict__ k_rows, const int* __restrict__ nperm, const int* __restrict__ g_p,
    const float* __restrict__ req, const int* __restrict__ budget_p,
    const int* __restrict__ group_ports, const int* __restrict__ group_placed,
    float* __restrict__ idle, float* __restrict__ rel, int* __restrict__ node_ports,
    int* __restrict__ node_num_tasks, const int* __restrict__ task_group,
    const int* __restrict__ task_group_rank, const uint8_t* __restrict__ task_valid,
    int* __restrict__ task_status, int* __restrict__ task_node, int* __restrict__ node_of_slot,
    int N, int R, int W, int T, int s_max, int best_effort, int preds_on,
    int* __restrict__ placed_out, uint8_t* __restrict__ use_rel_out) {
  const int g = *g_p;
  const int budget = *budget_p;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, N);
  const int hi = min(lo + per, N);
  int s_idle = 0;
  for (int i = lo; i < hi; ++i) s_idle += k_rows[i];
  int total_idle;
  kat_block_excl_scan(s_idle, &total_idle);
  const bool use_rel = !best_effort && total_idle == 0 && budget > 0;
  const int* k = k_rows + (use_rel ? N : 0);
  int tsum = 0;
  for (int i = lo; i < hi; ++i) tsum += k[i];
  int total;
  int run = kat_block_excl_scan(tsum, &total);
  const int placed_total = min(budget, total);
  const int* gports = group_ports + (size_t)g * W;
  bool has_ports = false;
  if (preds_on)
    for (int w = 0; w < W; ++w) has_ports |= gports[w] != 0;
  float* avail = use_rel ? rel : idle;
  const int slot_end = min(placed_total, s_max);
  for (int i = lo; i < hi; ++i) {
    const int ki = k[i];
    const int p = min(max(placed_total - run, 0), ki);
    const int n = nperm ? nperm[i] : i;
    if (p > 0) {
      const float pf = __int2float_rn(p);
      for (int r = 0; r < R; ++r) {
        float* a = avail + (size_t)n * R + r;
        *a = __fsub_rn(*a, __fmul_rn(pf, req[r]));
      }
      node_num_tasks[n] += p;
      if (has_ports)
        for (int w = 0; w < W; ++w) node_ports[(size_t)n * W + w] |= gports[w];
    }
    for (int s = run; s < min(run + ki, slot_end); ++s) node_of_slot[s] = n;
    run += ki;
  }
  __syncthreads();  // node_of_slot is complete
  const int placed_before = group_placed[g];
  const int new_status = use_rel ? kPipelined : kAllocated;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    if (task_group[t] != g || !task_valid[t]) continue;
    const int slot = task_group_rank[t] - placed_before;
    if (slot >= 0 && slot < placed_total) {
      task_status[t] = new_status;
      task_node[t] = node_of_slot[min(slot, s_max - 1)];
    }
  }
  if (threadIdx.x == 0) {
    placed_out[0] = placed_total;
    use_rel_out[0] = use_rel ? 1 : 0;
  }
}

}  // namespace

extern "C" int kat_turn_fill(
    const int* k_rows, const int* nperm, const int* g, const float* req, const int* budget,
    const int* group_ports, const int* group_placed, float* idle, float* rel, int* node_ports,
    int* node_num_tasks, const int* task_group, const int* task_group_rank,
    const uint8_t* task_valid, int* task_status, int* task_node, int* node_of_slot, int N,
    int R, int W, int T, int s_max, int best_effort, int preds_on, int* placed_out,
    uint8_t* use_rel_out, void* stream) {
  turn_fill_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      k_rows, nperm, g, req, budget, group_ports, group_placed, idle, rel, node_ports,
      node_num_tasks, task_group, task_group_rank, task_valid, task_status, task_node,
      node_of_slot, N, R, W, T, s_max, best_effort, preds_on, placed_out, use_rel_out);
  return (int)cudaGetLastError();
}
