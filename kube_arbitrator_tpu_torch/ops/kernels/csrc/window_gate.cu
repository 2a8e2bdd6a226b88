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
// reductions (the first claim, the conflict count) and a block vote (a
// prefix row popped).  ctl[PROGRESS] receives the round's progress after
// the prefix; K8 sets it too where it sets progress (its progress_out),
// so the engine's one host read of ctl needs nothing else.
//
// The plan (window_gate.py's WindowGatePlan) binds ctl and sel (its own),
// q_entries and job_consumed, K14's plan-owned pick and K2's plan-owned
// jp / gp / hgp / popp / burnp once per optimistic engine call: a launch
// passes only a Call — q_panel (i32 or i64, read as either), reqp and
// the round's progress word (the engine gives progress a new tensor
// every round).
//
// Bound: bytes — the RP rows read once (pick, queue, job, group, flags:
// ~10 KB at RP = 512) and a few hundred entries written: nanoseconds at
// 3.35 TB/s.  The launch is the floor.
#include "common.cuh"

namespace {

// the plan's fixed arguments (window_gate.py's _Static mirrors this layout)
struct Static {
  const int* pick;            // i32[RP] K14's first feasible node per row (N: none)
  const int* jp;              // i32[RP] K2's pops: job
  const int* gp;              // i32[RP] group
  const uint8_t* hgp;         // bool[RP] has a group
  const uint8_t* popp;        // bool[RP] popped
  const uint8_t* burnp;       // bool[RP] burned its entry
  int* ctl;                   // i32[KAT_CTL_LEN] the window's control words
  int* q_entries;             // i32[Q]
  uint8_t* job_consumed;      // bool[J]
  int* sel_i;                 // i32[4] out: q, j, g, pick of the accepted row
  uint8_t* sel_b;             // bool[4] out: has_grp, pop, burn_now, has_claim
  float* sel_req;             // f32[R] out
  int N, RP, R;
};

// a launch's own arguments (window_gate.py's _Call mirrors this layout)
struct Call {
  const void* q_panel;        // i32 or i64 [RP] the window's queues
  const float* reqp;          // f32[RP, R]
  uint8_t* progress;          // bool scalar, the round's
  int q_wide;
};

__global__ void window_gate_kernel(const Static s, const Call c) {
  const int RP = s.RP;
  int* ctl = s.ctl;
  const int start = ctl[KAT_CTL_START], trip = ctl[KAT_CTL_TRIP];
  const bool progress0 = *c.progress != 0;  // read before any thread writes it
  const int n_in = max(0, min(RP, trip - start));  // rows inside the window
  int f = RP;
  for (int r = threadIdx.x; r < RP; r += blockDim.x) {
    if (s.pick[r] < s.N) f = min(f, r);
  }
  const int first = kat_block_min_i32(f);
  // the accepted row, read by thread 0 while the block counts conflicts
  const int sr = min(first, RP - 1);
  int sel_q = 0, sel_j = 0, sel_g = 0, sel_n = 0;
  uint8_t sel_h = 0, sel_p = 0, sel_bn = 0;
  if (threadIdx.x == 0) {
    sel_q = kat_read_index(c.q_panel, c.q_wide, sr);
    sel_j = s.jp[sr];
    sel_g = s.gp[sr];
    sel_n = s.pick[sr];
    sel_h = s.hgp[sr];
    sel_p = s.popp[sr];
    sel_bn = s.burnp[sr];
  }
  int cnt = 0;
  for (int r = threadIdx.x; r < RP; r += blockDim.x) cnt += (s.pick[r] < s.N && r > first) ? 1 : 0;
  int conflicts;
  kat_block_excl_scan(cnt, &conflicts);
  const int n_commit = min(first, n_in);
  bool popped = false;
  for (int r = threadIdx.x; r < n_commit; r += blockDim.x) {
    if (s.burnp[r] || s.popp[r]) s.q_entries[kat_read_index(c.q_panel, c.q_wide, r)] -= 1;
    if (s.popp[r]) {
      s.job_consumed[s.jp[r]] = 1;
      popped = true;
    }
  }
  const bool any_pop = __syncthreads_or(popped) != 0;
  if (threadIdx.x != 0) return;
  if (any_pop) *c.progress = 1;
  const bool has_claim = first < RP;
  const int start_next = start + n_commit + (has_claim ? 1 : 0);
  const bool round_done = start_next >= trip;
  const bool gated = round_done && start == 0 && !has_claim;
  ctl[KAT_CTL_START] = round_done ? 0 : start_next;
  ctl[KAT_CTL_ROUNDS] += round_done ? 1 : 0;
  ctl[KAT_CTL_GATED] += gated ? 1 : 0;
  ctl[KAT_CTL_CONFLICTS] += conflicts;
  ctl[KAT_CTL_ROUND_DONE] = round_done ? 1 : 0;
  ctl[KAT_CTL_WINDOWS] += 1;
  ctl[KAT_CTL_PROGRESS] = (progress0 || any_pop) ? 1 : 0;
  s.sel_i[0] = sel_q;
  s.sel_i[1] = sel_j;
  s.sel_i[2] = sel_g;
  s.sel_i[3] = sel_n;
  s.sel_b[0] = sel_h;
  s.sel_b[1] = sel_p;
  s.sel_b[2] = sel_bn;
  s.sel_b[3] = has_claim ? 1 : 0;
  for (int k = 0; k < s.R; ++k) s.sel_req[k] = c.reqp[(size_t)sr * s.R + k];
}

}  // namespace

extern "C" int kat_window_gate(const void* static_args, const void* call_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Call& c = *static_cast<const Call*>(call_args);
  if (s.RP <= 0) return (int)cudaErrorInvalidValue;
  window_gate_kernel<<<1, 512, 0, (cudaStream_t)stream>>>(s, c);
  return (int)cudaGetLastError();
}
