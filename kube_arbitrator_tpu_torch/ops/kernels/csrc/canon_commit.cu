// K8 canon_commit: the commit tail of one reclaim canon turn, in place.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_canon_fit_commit
// (:2080-2219) after the node pick: the turn's claim flag and pop
// accounting, the covering-prefix eviction inside the chosen node's
// W-wide canon window (:2114-2124), the cand / evicted updates, the
// restore of the carried scans rank_nj / cum_nq over the window
// (:2137-2147), the W-wide job and queue stat sums and the accounting
// they feed (:2149-2167), the claim-log slot (:2169-2174), the node
// releasing / ports / pod-count updates and the audit aux (:2176-2196).
// n_star comes from K7's pick (or K14's, in the batched and optimistic
// engines) on the device, so a turn needs no host sync.  Two optional
// device flags: active (clear: the launch does nothing; the optimistic
// window's has_claim) and claimed_out (receives the turn's claimed
// bit; the batched engine's refresh flag for K13).
//
// One block.  The window mask is evaluated by all threads from the
// turn-entry state (the same definition K7 used), then thread 0 runs the
// serial parts in slot order — the covering prefix, freed, the segmented
// restores and the per-job / per-queue sums — and the threads write the
// evicted slots' flags and audit fields in parallel.  Serial order is
// the port's one order for these f32 sums (from zero, in slot order).
//
// Bound: bytes — a W-wide window of the canon arrays plus a handful of
// job / queue / node rows: ~2 KB at W = 32, nanoseconds at 3.35 TB/s.
// The launch and the serial chain of one thread are the floor.
#include "canon.cuh"

namespace {

struct Turn {
  int q, j, g;
  bool claimed, pop, fail, burn;
  int n_star, start, blen;
};

__global__ void canon_commit_kernel(
    CanonElig e, const int* __restrict__ pick, const int* __restrict__ q_p,
    const int* __restrict__ j_p, const int* __restrict__ g_p,
    const uint8_t* __restrict__ has_grp_p, const uint8_t* __restrict__ pop_p,
    const uint8_t* __restrict__ burn_p, const float* __restrict__ req,
    const int* __restrict__ bstart, const int* __restrict__ rv_idx,
    const float* __restrict__ cres, const uint8_t* __restrict__ nj_start,
    const uint8_t* __restrict__ nq_start, const int* __restrict__ group_ports,
    uint8_t* cand, uint8_t* __restrict__ evicted_c, float* rank_nj, float* cum_nq,
    int* job_ready_cnt, float* job_alloc, float* queue_alloc,
    int* __restrict__ q_entries, uint8_t* __restrict__ job_consumed,
    int* __restrict__ group_placed, int* __restrict__ log_g, int* __restrict__ log_n,
    int* __restrict__ log_r, int* __restrict__ n_claims, float* __restrict__ node_releasing,
    int* __restrict__ node_ports, int* __restrict__ node_num_tasks,
    int* __restrict__ evict_claimant, int* __restrict__ evict_phase,
    int* __restrict__ evict_round, uint8_t* __restrict__ progress, int N, int W, int PW,
    int rounds, int phase_code, const uint8_t* __restrict__ active,
    uint8_t* __restrict__ claimed_out) {
  // a turn the caller switched off (an optimistic window with no claim)
  // touches nothing
  if (active != nullptr && *active == 0) return;
  extern __shared__ uint8_t smem[];
  uint8_t* m_w = smem;      // window victim mask
  uint8_t* ev_w = smem + W; // evicted in this turn
  const int R = e.R, F = e.F;
  Turn t;
  t.q = *q_p;
  t.j = *j_p;
  t.g = *g_p;
  const bool has_node = *pick < N;
  t.n_star = has_node ? *pick : 0;
  t.pop = *pop_p != 0;
  t.claimed = t.pop && *has_grp_p && has_node;
  t.fail = t.pop && !t.claimed;
  t.burn = *burn_p != 0;
  t.start = bstart[t.n_star];
  t.blen = bstart[t.n_star + 1] - t.start;

  // ---- the window mask, from the turn-entry state
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    m_w[w] = (w < t.blen && kat_canon_victim(e, t.start + w, t.q)) ? 1 : 0;
  }
  __syncthreads();

  // ---- covering prefix: evict while the masked cumulative before the
  // slot is still short of req - EPS in some resource
  if (threadIdx.x == 0) {
    float acc[8];
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int w = 0; w < W; ++w) {
      bool ev = false;
      for (int r = 0; r < R; ++r) {
        const float v = m_w[w] ? cres[(size_t)(t.start + w) * R + r] : 0.f;
        acc[r] = __fadd_rn(acc[r], v);
        ev |= __fsub_rn(acc[r], v) < __fsub_rn(req[r], KAT_EPS);
      }
      ev_w[w] = (m_w[w] && t.claimed && ev) ? 1 : 0;
    }
  }
  __syncthreads();

  // ---- per-slot updates of the evicted slots
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    if (!ev_w[w]) continue;
    const int s = t.start + w;
    cand[s] = 0;
    evicted_c[s] = 1;
    const int task = rv_idx[s];
    evict_claimant[task] = t.j;
    evict_phase[task] = phase_code;
    evict_round[task] = rounds;
  }
  __syncthreads();

  if (threadIdx.x != 0) return;
  if (claimed_out != nullptr) *claimed_out = t.claimed ? 1 : 0;
  // ---- restore the carried scans over the window (segments are
  // node-contained and the window starts at a block start)
  float cnt = 0.f;
  float acc[8];
  for (int w = 0; w < W; ++w) {
    const int s = t.start + w;
    const float cf = cand[s] ? 1.f : 0.f;
    if (e.use_gang) {
      if (w == 0 || nj_start[s]) cnt = 0.f;
      cnt = __fadd_rn(cnt, cf);
      rank_nj[s] = __fsub_rn(cnt, cf);
    }
    if (e.use_prop) {
      for (int r = 0; r < F; ++r) {
        if (w == 0 || nq_start[s]) acc[r] = 0.f;
        acc[r] = __fadd_rn(acc[r], cand[s] ? cres[(size_t)s * R + r] : 0.f);
        cum_nq[(size_t)s * F + r] = acc[r];
      }
    }
  }

  // ---- job and queue stats of the evicted slots: per ordinal, summed
  // from zero in slot order, then subtracted once
  float freed[8], sum[8];
  for (int r = 0; r < R; ++r) freed[r] = 0.f;
  for (int w = 0; w < W; ++w) {
    if (!ev_w[w]) continue;
    const float* v = cres + (size_t)(t.start + w) * R;
    for (int r = 0; r < R; ++r) freed[r] = __fadd_rn(freed[r], v[r]);
  }
  for (int pass = 0; pass < 2; ++pass) {
    const int* key = pass == 0 ? e.cj : e.cq;
    float* alloc = pass == 0 ? job_alloc : queue_alloc;
    for (int w = 0; w < W; ++w) {
      if (!ev_w[w]) continue;
      const int k = key[t.start + w];
      bool seen = false;
      for (int u = 0; u < w; ++u) seen |= ev_w[u] && key[t.start + u] == k;
      if (seen) continue;
      int c = 0;
      for (int r = 0; r < R; ++r) sum[r] = 0.f;
      for (int u = w; u < W; ++u) {
        if (!ev_w[u] || key[t.start + u] != k) continue;
        ++c;
        for (int r = 0; r < R; ++r) sum[r] = __fadd_rn(sum[r], cres[(size_t)(t.start + u) * R + r]);
      }
      for (int r = 0; r < R; ++r) alloc[(size_t)k * R + r] = __fsub_rn(alloc[(size_t)k * R + r], sum[r]);
      if (pass == 0) job_ready_cnt[k] -= c;
    }
  }
  const float cl = t.claimed ? 1.f : 0.f;
  for (int r = 0; r < R; ++r) {
    const float creq = __fmul_rn(req[r], cl);
    job_alloc[(size_t)t.j * R + r] = __fadd_rn(job_alloc[(size_t)t.j * R + r], creq);
    queue_alloc[(size_t)t.q * R + r] = __fadd_rn(queue_alloc[(size_t)t.q * R + r], creq);
    float* rel = node_releasing + (size_t)t.n_star * R + r;
    *rel = __fadd_rn(*rel, __fsub_rn(freed[r], creq));
  }
  job_ready_cnt[t.j] += t.claimed ? 1 : 0;
  q_entries[t.q] -= (t.burn || t.fail) ? 1 : 0;
  if (t.pop) job_consumed[t.j] = 1;
  if (t.claimed) {
    const int slot = *n_claims;
    log_g[slot] = t.g;
    log_n[slot] = t.n_star;
    log_r[slot] = group_placed[t.g];
    *n_claims = slot + 1;
    for (int w = 0; w < PW; ++w) node_ports[(size_t)t.n_star * PW + w] |= group_ports[(size_t)t.g * PW + w];
    node_num_tasks[t.n_star] += 1;
    group_placed[t.g] += 1;
  }
  if (t.pop) *progress = 1;
}

}  // namespace

extern "C" int kat_canon_commit(
    const uint8_t* cand_in, const float* rank_in, const float* cum_in, const int* cj,
    const int* cq, const float* deserved_c, const int* job_ready_cnt_in,
    const int* min_avail, const float* queue_alloc_in, int R, int F, int use_gang,
    int use_prop, const int* pick, const int* q, const int* j, const int* g,
    const uint8_t* has_grp, const uint8_t* pop, const uint8_t* burn, const float* req,
    const int* bstart, const int* rv_idx, const float* cres, const uint8_t* nj_start,
    const uint8_t* nq_start, const int* group_ports, uint8_t* evicted_c,
    float* job_alloc, int* q_entries, uint8_t* job_consumed, int* group_placed,
    int* log_g, int* log_n, int* log_r, int* n_claims, float* node_releasing,
    int* node_ports, int* node_num_tasks, int* evict_claimant, int* evict_phase,
    int* evict_round, uint8_t* progress, int N, int W, int PW, int rounds,
    int phase_code, const uint8_t* active, uint8_t* claimed_out, void* stream) {
  if (R > 8 || W <= 0) return (int)cudaErrorInvalidValue;
  // cand, the carried scans, the ready counts and the queue allocations
  // are read through the eligibility view and updated in place
  CanonElig e{cand_in, rank_in, cum_in, cj, cq, deserved_c, job_ready_cnt_in, min_avail,
              queue_alloc_in, R, F, use_gang != 0, use_prop != 0};
  canon_commit_kernel<<<1, 128, 2 * W, (cudaStream_t)stream>>>(
      e, pick, q, j, g, has_grp, pop, burn, req, bstart, rv_idx, cres, nj_start,
      nq_start, group_ports, const_cast<uint8_t*>(cand_in), evicted_c,
      const_cast<float*>(rank_in), const_cast<float*>(cum_in),
      const_cast<int*>(job_ready_cnt_in), job_alloc, const_cast<float*>(queue_alloc_in),
      q_entries, job_consumed, group_placed, log_g, log_n, log_r, n_claims,
      node_releasing, node_ports, node_num_tasks, evict_claimant, evict_phase,
      evict_round, progress, N, W, PW, rounds, phase_code, active, claimed_out);
  return (int)cudaGetLastError();
}
