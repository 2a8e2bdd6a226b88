// K8 canon_commit: the commit tail of one reclaim canon turn, in place.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_canon_fit_commit
// (:2080-2219) after the node pick: the turn's claim flag and pop
// accounting, the covering-prefix eviction inside the chosen node's
// W-wide canon window (:2114-2124), the cand / evicted updates, the
// restore of the carried scans rank_nj / cum_nq over the window
// (:2137-2147), the W-wide job and queue stat sums and the accounting
// they feed (:2149-2167), the claim-log slot (:2169-2174; row J takes the
// writes of a turn that did not claim), the node releasing / ports /
// pod-count updates and the audit aux (:2176-2196).  n_star comes from
// K7's pick (or K14's, in the batched and optimistic engines) on the
// device, so a turn needs no host sync.  Three optional device words:
// active (clear: the launch does nothing; the optimistic window's
// has_claim), claimed_out (receives the turn's claimed bit; the batched
// engine's refresh flag for K13) and progress_out (an i32 set to 1
// wherever progress is set; the optimistic window's ctl[PROGRESS]).
//
// One CTA of four warps, every read of the window from shared memory:
// * stage: one coalesced pass loads the window's W x R resreq rows and,
//   a thread a slot, its job, queue, task, cand and segment-start flags
//   and the job and queue rows an eviction would update, and evaluates the
//   victim mask from the turn-entry state (the same definition K7 used,
//   csrc/canon.cuh);
// * the covering prefix: lane r < R of warp 0 runs resource r's masked
//   cumulative in slot order (from zero, each slot's value added, masked
//   slots adding 0.0, as the plain version's scan) and flags the slots
//   where cum - v is still short of req - EPS; a slot is evicted when it
//   is a victim, the turn claimed and some resource flagged it;
// * then the serial parts that depend only on the evictions run on
//   separate warps at once, each an exact slot-order f32 chain:
//   warp 0 the rank_nj restore (lane 0), warp 1 the cum_nq restore (lane
//   r < F), warp 2 freed (lane r < R), warp 3 the evicted slots' flags and
//   audit fields and the job and queue sums — the lowest evicted slot of
//   each job (queue) sums its group in slot order from zero and
//   subtracts once, as the plain version's segment sums do;
// * warp 0 last: the claim's accounting, the log, the node updates, from
//   the rows it read while the window loaded.
// The pointers the mask reads are written only after a barrier, from
// the staged copy (cand) or in place by the one CTA.
//
// The plan (canon_commit.py's CanonCommitPlan) binds the canon context,
// the carry, the job / queue / node state, the audit fields and the
// pack's arrays once per engine call: a launch passes only a Turn — the
// pick, the turn's q / j / g (i32 or i64, read as either), its flags and
// req, the optional device flags, the progress word (the engines reset
// progress to a new tensor every round) and the round.
//
// Bound: bytes — a W-wide window of the canon arrays plus a handful of
// job / queue / node rows: ~2 KB at W = 32, nanoseconds at 3.35 TB/s.
// The launch and the W-long chains are the floor.
#include "canon.cuh"

namespace {

constexpr int THREADS = 128;  // four warps: see above
constexpr int MAX_R = 8;

// the plan's fixed arguments (canon_commit.py's _Static mirrors this layout)
struct Static {
  const int* cj;              // i32[Vp] slot -> job
  const int* cq;              // i32[Vp] slot -> queue
  const float* cres;          // f32[Vp, R] victim resreq
  const float* deserved_c;    // f32[Vp, F]
  const int* min_avail;       // i32[J]
  const int* bstart;          // i32[N + 1] node blocks
  const int* rv_idx;          // i32[Vp] slot -> task
  const uint8_t* nj_start;    // bool[Vp] (node, job) segment starts
  const uint8_t* nq_start;    // bool[Vp] (node, queue) segment starts
  const int* group_ports;     // i32[G, PW]
  uint8_t* cand;              // bool[Vp] live candidates
  uint8_t* evicted_c;         // bool[Vp]
  float* rank_nj;             // f32[Vp]
  float* cum_nq;              // f32[Vp, F]
  int* q_entries;             // i32[Q]
  uint8_t* job_consumed;      // bool[J]
  int* log_g;                 // i32[J + 1] claim log (row J: dropped writes)
  int* log_n;
  int* log_r;
  int* n_claims;              // i32[1]
  float* job_alloc;           // f32[J, R]
  float* queue_alloc;         // f32[Q, R]
  int* job_ready_cnt;         // i32[J]
  int* group_placed;          // i32[G]
  float* node_releasing;      // f32[N, R]
  int* node_ports;            // i32[N, PW]
  int* node_num_tasks;        // i32[N]
  int* evict_claimant;        // i32[T]
  int* evict_phase;
  int* evict_round;
  int R, F, use_gang, use_prop, N, W, PW, J, phase_code;
};

// a launch's own arguments (canon_commit.py's _Turn mirrors this layout)
struct Turn {
  const int* pick;            // i32[1] the first feasible node, N if none
  const void* q;              // i32 or i64 [1]
  const void* j;
  const void* g;
  const uint8_t* has_grp;     // bool[1]
  const uint8_t* pop;
  const uint8_t* burn;
  const float* req;           // f32[R]
  const uint8_t* active;      // bool[1] or null: clear, the launch does nothing
  uint8_t* claimed_out;       // bool[1] or null
  uint8_t* progress;          // bool scalar: set when the turn popped
  int* progress_out;          // i32[1] or null: set to 1 with progress
  int q_wide, j_wide, g_wide, rounds;
};

__global__ void __launch_bounds__(THREADS) canon_commit_kernel(Static s, Turn t) {
  // a turn the caller switched off (an optimistic window with no claim)
  // touches nothing
  if (t.active != nullptr && *t.active == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = s.W, R = s.R, F = s.F;
  extern __shared__ float smem[];
  float* res_w = smem;                                  // [W][R] resreq rows
  int* key_w = reinterpret_cast<int*>(res_w + W * R);   // [2][W] job, queue
  int* task_w = key_w + 2 * W;                          // [W]
  int* ready_w = task_w + W;                            // [W] job_ready_cnt of its job
  float* rows_w = reinterpret_cast<float*>(ready_w + W);  // [2][W][R] its job's, queue's alloc
  // a bit a slot: some resource still short before the slot
  unsigned* short_w = reinterpret_cast<unsigned*>(rows_w + 2 * W * R);
  uint8_t* m_w = reinterpret_cast<uint8_t*>(short_w + (W + 31) / 32);  // victim mask
  uint8_t* cand_w = m_w + W;   // cand at entry, then after this turn's evictions
  uint8_t* ev_w = cand_w + W;  // evicted in this turn
  uint8_t* njs_w = ev_w + W;
  uint8_t* nqs_w = njs_w + W;
  __shared__ float freed[MAX_R];

  // the turn's scalars, read together by every thread
  const int pick = *t.pick;
  const bool pop = *t.pop != 0, has_grp = *t.has_grp != 0;
  const int q = kat_read_index(t.q, t.q_wide);
  const bool has_node = pick < s.N;
  const int n_star = has_node ? pick : 0;
  const bool claimed = pop && has_grp && has_node;
  const int start = s.bstart[n_star];
  const int blen = s.bstart[n_star + 1] - start;
  const float* __restrict__ req = t.req;
  uint8_t* __restrict__ cand = s.cand;
  float* __restrict__ rank_nj = s.rank_nj;
  float* __restrict__ cum_nq = s.cum_nq;
  float* __restrict__ job_alloc = s.job_alloc;
  float* __restrict__ queue_alloc = s.queue_alloc;
  int* __restrict__ job_ready_cnt = s.job_ready_cnt;

  // warp 0 reads the claim's rows now, while the window loads: nothing
  // before the tail writes them, but the claimant's job and queue rows,
  // which a victim shares only if the caller's j is not of queue q (then
  // the tail reads them again)
  const int j = kat_read_index(t.j, t.j_wide), g = kat_read_index(t.g, t.g_wide);
  float job_r = 0.f, queue_r = 0.f, rel_r = 0.f, req_r = 0.f;
  int ready_j = 0, entries_q = 0, slot = 0, placed_g = 0, tasks_n = 0;
  bool burn = false;
  if (warp == 0) {
    if (lane < R) {
      job_r = job_alloc[(size_t)j * R + lane];
      queue_r = queue_alloc[(size_t)q * R + lane];
      rel_r = s.node_releasing[(size_t)n_star * R + lane];
      req_r = req[lane];
    }
    if (lane == 0) {
      ready_j = job_ready_cnt[j];
      entries_q = s.q_entries[q];
      slot = claimed ? *s.n_claims : s.J;
      placed_g = s.group_placed[g];
      tasks_n = s.node_num_tasks[n_star];
      burn = *t.burn != 0;
    }
  }

  // ---- stage the window; the mask from the turn-entry state
  const CanonElig e{cand, rank_nj, cum_nq, s.cj, s.cq, s.deserved_c, job_ready_cnt,
                    s.min_avail, queue_alloc, R, F, s.use_gang != 0, s.use_prop != 0};
  const float* __restrict__ cres_w = s.cres + (size_t)start * R;
  for (int k = tid; k < W * R; k += THREADS) res_w[k] = cres_w[k];
  for (int w = tid; w < W; w += THREADS) {
    const int sl = start + w;
    const int kj = s.cj[sl], kq = s.cq[sl];
    key_w[w] = kj;
    key_w[W + w] = kq;
    task_w[w] = s.rv_idx[sl];
    // the rows a victim's eviction updates, read with the mask's (only
    // their slot's group leader writes them, below)
    ready_w[w] = job_ready_cnt[kj];
    for (int r = 0; r < R; ++r) {
      rows_w[w * R + r] = job_alloc[(size_t)kj * R + r];
      rows_w[(W + w) * R + r] = queue_alloc[(size_t)kq * R + r];
    }
    cand_w[w] = cand[sl];
    njs_w[w] = s.nj_start[sl];
    nqs_w[w] = s.nq_start[sl];
    m_w[w] = (w < blen && kat_canon_victim(e, sl, q)) ? 1 : 0;
    if ((w & 31) == 0) short_w[w >> 5] = 0u;
  }
  __syncthreads();

  // ---- covering prefix: resource r's masked cumulative, lane r; a
  // chunk's short flags gather in a register (no store inside the chain)
  if (claimed && tid < R) {
    const float rq = __fsub_rn(req[tid], KAT_EPS);
    float acc = 0.f;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int n = min(32, W - w0);
      unsigned bits = 0u;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const float v = m_w[w0 + i] ? res_w[(w0 + i) * R + tid] : 0.f;
        acc = __fadd_rn(acc, v);
        bits |= (__fsub_rn(acc, v) < rq ? 1u : 0u) << i;
      }
      atomicOr(short_w + (w0 >> 5), bits);
    }
  }
  __syncthreads();
  for (int w = tid; w < W; w += THREADS) {
    const bool ev = claimed && m_w[w] && ((short_w[w >> 5] >> (w & 31)) & 1u);
    ev_w[w] = ev ? 1 : 0;
    if (ev) cand_w[w] = 0;
  }
  __syncthreads();

  // ---- the parts that depend only on the evictions, a warp each
  if (warp == 0) {
    // rank_nj: exclusive in-(node, job) candidate rank over the window
    if (s.use_gang && lane == 0) {
      float cnt = 0.f;
      for (int w = 0; w < W; ++w) {
        const float cf = cand_w[w] ? 1.f : 0.f;
        if (w == 0 || njs_w[w]) cnt = 0.f;
        cnt = __fadd_rn(cnt, cf);
        rank_nj[start + w] = __fsub_rn(cnt, cf);
      }
    }
  } else if (warp == 1) {
    // cum_nq: inclusive in-(node, queue) fair cumulative, lane r < F
    if (s.use_prop && lane < F) {
      float acc = 0.f;
      for (int w = 0; w < W; ++w) {
        if (w == 0 || nqs_w[w]) acc = 0.f;
        acc = __fadd_rn(acc, cand_w[w] ? res_w[w * R + lane] : 0.f);
        cum_nq[(size_t)(start + w) * F + lane] = acc;
      }
    }
  } else if (warp == 2) {
    // freed: the evicted slots' resreq, lane r < R
    if (lane < R) {
      float acc = 0.f;
      for (int w = 0; w < W; ++w)
        if (ev_w[w]) acc = __fadd_rn(acc, res_w[w * R + lane]);
      freed[lane] = acc;
    }
  } else {
    // the evicted slots, a chunk of 32 a step: flags, audit fields, job
    // and queue sums.  Within a chunk, a key's evicted slots find each
    // other with one match; a slot leads its key when no evicted slot
    // before it has that key
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = w0 + lane;
      const bool ev = w < W && ev_w[w];
      const unsigned evm = __ballot_sync(0xffffffffu, ev);
      unsigned peers[2];
      peers[0] = __match_any_sync(0xffffffffu, ev ? key_w[w] : -1) & evm;
      peers[1] = __match_any_sync(0xffffffffu, ev ? key_w[W + w] : -1) & evm;
      if (!ev) continue;
      const int sl = start + w, task = task_w[w];
      cand[sl] = 0;
      s.evicted_c[sl] = 1;
      s.evict_claimant[task] = j;
      s.evict_phase[task] = s.phase_code;
      s.evict_round[task] = t.rounds;
      for (int pass = 0; pass < 2; ++pass) {
        const int* key = key_w + pass * W;
        const int k = key[w];
        bool lead = (peers[pass] & ((1u << lane) - 1u)) == 0u;
        for (int u = 0; lead && u < w0; ++u) lead = !(ev_w[u] && key[u] == k);
        if (!lead) continue;
        float sum[MAX_R];
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) sum[r] = 0.f;
        int c = 0;
        // slot order: this chunk's peers, then the later chunks
        for (unsigned b = peers[pass]; b != 0u; b &= b - 1u) {
          const int u = w0 + __ffs((int)b) - 1;
          ++c;
#pragma unroll
          for (int r = 0; r < MAX_R; ++r)
            if (r < R) sum[r] = __fadd_rn(sum[r], res_w[u * R + r]);
        }
        for (int u = w0 + 32; u < W; ++u) {
          if (!ev_w[u] || key[u] != k) continue;
          ++c;
#pragma unroll
          for (int r = 0; r < MAX_R; ++r)
            if (r < R) sum[r] = __fadd_rn(sum[r], res_w[u * R + r]);
        }
        float* alloc = pass == 0 ? job_alloc : queue_alloc;
        const float* row = rows_w + (pass * W + w) * R;
#pragma unroll
        for (int r = 0; r < MAX_R; ++r)
          if (r < R) alloc[(size_t)k * R + r] = __fsub_rn(row[r], sum[r]);
        if (pass == 0) job_ready_cnt[k] = ready_w[w] - c;
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- the claim's accounting, the log, the node
  bool j_hit = false, q_hit = false;
  for (int w = lane; w < W; w += 32) {
    j_hit |= ev_w[w] && key_w[w] == j;
    q_hit |= ev_w[w] && key_w[W + w] == q;
  }
  j_hit = __any_sync(0xffffffffu, j_hit);
  q_hit = __any_sync(0xffffffffu, q_hit);
  const float cl = claimed ? 1.f : 0.f;
  if (lane < R) {
    if (j_hit) job_r = job_alloc[(size_t)j * R + lane];
    if (q_hit) queue_r = queue_alloc[(size_t)q * R + lane];
    const float creq = __fmul_rn(req_r, cl);
    job_alloc[(size_t)j * R + lane] = __fadd_rn(job_r, creq);
    queue_alloc[(size_t)q * R + lane] = __fadd_rn(queue_r, creq);
    s.node_releasing[(size_t)n_star * R + lane] = __fadd_rn(rel_r, __fsub_rn(freed[lane], creq));
  }
  if (claimed) {
    for (int w = lane; w < s.PW; w += 32)
      s.node_ports[(size_t)n_star * s.PW + w] |= s.group_ports[(size_t)g * s.PW + w];
  }
  if (lane != 0) return;
  if (j_hit) ready_j = job_ready_cnt[j];
  const bool fail = pop && !claimed;
  if (t.claimed_out != nullptr) *t.claimed_out = claimed ? 1 : 0;
  job_ready_cnt[j] = ready_j + (claimed ? 1 : 0);
  s.q_entries[q] = entries_q - ((burn || fail) ? 1 : 0);
  if (pop) s.job_consumed[j] = 1;
  s.log_g[slot] = g;
  s.log_n[slot] = n_star;
  s.log_r[slot] = placed_g;
  if (claimed) {
    *s.n_claims = slot + 1;
    s.node_num_tasks[n_star] = tasks_n + 1;
    s.group_placed[g] = placed_g + 1;
  }
  if (pop) {
    *t.progress = 1;
    if (t.progress_out != nullptr) *t.progress_out = 1;
  }
}

size_t smem_bytes(int W, int R) {
  return (size_t)W * (3 * R * sizeof(float) + 4 * sizeof(int) + 5) +
         (W + 31) / 32 * sizeof(unsigned);
}

}  // namespace

extern "C" int kat_canon_commit(const void* static_args, const void* turn_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Turn& t = *static_cast<const Turn*>(turn_args);
  if (s.R < 1 || s.R > MAX_R || s.F > s.R || s.W <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s.W, s.R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(canon_commit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  canon_commit_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(s, t);
  return (int)cudaGetLastError();
}
