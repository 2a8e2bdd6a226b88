// K15 window_gate: the optimistic reclaim engine's commit gate over one
// speculation window, in place.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_reclaim_canon_optimistic's
// gate (:2735-2800).  A window is RP turns of the round's queue order
// starting at ctl[START]; row r was popped and screened (K14's pick[r] <
// N: a speculative claim) from window-start state.  The gate:
//   * first = the first speculative claim (RP when none);
//   * the burn / fail prefix (rows r < first inside the window) commits
//     wholesale: each row's queue spends one entry (q_entries - 1 where
//     the row burned or popped), a popped row's job is consumed, and
//     progress is set if any row popped;
//   * conflicts = speculative claims after the first, discarded;
//   * the window advances by the prefix plus the accepted claim; the
//     round ends when that reaches ctl[TRIP]; a round finished in its
//     first window with no claim is a gated round;
//   * the accepted row's (q, j, g, pick | has_grp, pop, burn_now,
//     has_claim | req) go to sel_i / sel_b / sel_req, where K8 commits
//     the claim (K8 does nothing when has_claim is clear).
// The rows of a window are distinct queues (positions below the trip of
// a permutation), so the prefix writes need no atomics.
//
// One block; each thread walks rows r, r + blockDim, ...; two block
// reductions (the first claim, the conflict count).
//
// Bound: bytes — the RP rows read once (pick, queue, job, group, flags:
// ~10 KB at RP = 512) and a few hundred entries written: nanoseconds at
// 3.35 TB/s.  The launch is the floor.
#include "common.cuh"

namespace {

enum { START = 0, TRIP = 1, ROUNDS = 2, GATED = 3, CONFLICTS = 4, ROUND_DONE = 5, WINDOWS = 6 };

__global__ void window_gate_kernel(
    const int* __restrict__ pick, int N, int RP, const int* __restrict__ q_panel,
    const int* __restrict__ jp, const int* __restrict__ gp, const uint8_t* __restrict__ hgp,
    const float* __restrict__ reqp, int R, const uint8_t* __restrict__ popp,
    const uint8_t* __restrict__ burnp, int* __restrict__ ctl, int* __restrict__ q_entries,
    uint8_t* __restrict__ job_consumed, uint8_t* __restrict__ progress,
    int* __restrict__ sel_i, uint8_t* __restrict__ sel_b, float* __restrict__ sel_req) {
  const int start = ctl[START], trip = ctl[TRIP];
  const int n_in = max(0, min(RP, trip - start));  // rows inside the window
  int f = RP;
  for (int r = threadIdx.x; r < RP; r += blockDim.x) {
    if (pick[r] < N) f = min(f, r);
  }
  const int first = kat_block_min_i32(f);
  int c = 0;
  for (int r = threadIdx.x; r < RP; r += blockDim.x) c += (pick[r] < N && r > first) ? 1 : 0;
  int conflicts;
  kat_block_excl_scan(c, &conflicts);
  const int n_commit = min(first, n_in);
  bool popped = false;
  for (int r = threadIdx.x; r < n_commit; r += blockDim.x) {
    if (burnp[r] || popp[r]) q_entries[q_panel[r]] -= 1;
    if (popp[r]) {
      job_consumed[jp[r]] = 1;
      popped = true;
    }
  }
  if (popped) *progress = 1;
  if (threadIdx.x != 0) return;
  const bool has_claim = first < RP;
  const int start_next = start + n_commit + (has_claim ? 1 : 0);
  const bool round_done = start_next >= trip;
  const bool gated = round_done && start == 0 && !has_claim;
  ctl[START] = round_done ? 0 : start_next;
  ctl[ROUNDS] += round_done ? 1 : 0;
  ctl[GATED] += gated ? 1 : 0;
  ctl[CONFLICTS] += conflicts;
  ctl[ROUND_DONE] = round_done ? 1 : 0;
  ctl[WINDOWS] += 1;
  const int s = min(first, RP - 1);
  sel_i[0] = q_panel[s];
  sel_i[1] = jp[s];
  sel_i[2] = gp[s];
  sel_i[3] = pick[s];
  sel_b[0] = hgp[s];
  sel_b[1] = popp[s];
  sel_b[2] = burnp[s];
  sel_b[3] = has_claim ? 1 : 0;
  for (int k = 0; k < R; ++k) sel_req[k] = reqp[(size_t)s * R + k];
}

}  // namespace

extern "C" int kat_window_gate(
    const int* pick, int N, int RP, const int* q_panel, const int* jp, const int* gp,
    const uint8_t* hgp, const float* reqp, int R, const uint8_t* popp, const uint8_t* burnp,
    int* ctl, int* q_entries, uint8_t* job_consumed, uint8_t* progress, int* sel_i,
    uint8_t* sel_b, float* sel_req, void* stream) {
  if (RP <= 0) return (int)cudaErrorInvalidValue;
  window_gate_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(
      pick, N, RP, q_panel, jp, gp, hgp, reqp, R, popp, burnp, ctl, q_entries, job_consumed,
      progress, sel_i, sel_b, sel_req);
  return (int)cudaGetLastError();
}
