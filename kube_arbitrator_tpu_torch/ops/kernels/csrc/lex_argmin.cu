// K2 turn pick: both argmins of a turn selection — the job a queue turn
// serves, then the group within that job — one CTA a slot row, one launch
// a selection.
//
// Replaces kube_arbitrator_tpu/ops/common.py:lex_argmin (:49-66) as
// ops/allocate.py:_select_turn / select_turns (:505-550) apply it twice a
// turn, and as the reclaim pops (ops/preempt.py:_reclaim_pop, :1980-2010)
// do, with the OverusedFn row filter.  Per slot row s, queue q = q[s]:
//   row filter   select: ok = q_ok[s];
//                pop:    active = queue_valid[q] & q_entry[s] > 0,
//                        q_over = all_f deserved[q, f] < queue_alloc[q, f] + EPS,
//                        ok = active & ~q_over
//   job mask     job_queue == q & job_valid & job_has_pending & ok
//   job pick     the reference's filter over the job keys
//   group mask   group_job == j & grp_elig & any(job mask)
//   group pick   the filter over the group keys
// The filter, key by key: kmin = min_m where(cand, key, BIG);
// cand &= where(cand, key, BIG) <= kmin.  A NaN among the candidates makes
// kmin NaN, as jnp.min propagates it, and then no candidate survives;
// then the first surviving index (0 when none) and any(mask).
//
// Keys: the job columns are built here in ops/ordering.job_order_key_spec's
// order from the plan's static rows (-priority, creation rank + 1,
// creation rank: cast by torch once, at bind) and the round's job_ready
// and job_share; the group columns are static rows.  When they fit
// ("staged"), the first pass loads every job's and group's inputs at once
// (the loads in flight together, none waiting on a mask or on the job
// pick) and builds the keys into shared memory, so a filter stage is one
// shared-memory pass and one block reduction with one barrier; the
// candidate set lives in shared memory, never in a global scratch.  The
// earlier design took one CTA a row for each of the two picks, re-read a
// global candidate scratch at every stage (two passes and three barriers
// a stage) and dropped a NaN key (fminf).
//
// Bound: bytes — the keys of the masked entries, the job / group columns
// read once and the outputs written: ~20 KB at J = 1,024, K = 5, S = 8
// (~6 ns at 3.35 TB/s); the floor is the launch and the chain of block
// reductions (one a key, one a first index, one an any()).
#include "common.cuh"

namespace {

constexpr int TT = 256;  // threads of a CTA
constexpr int NW = TT / 32;
constexpr int MAX_KEYS = 8;  // lex_argmin.py's MAX_KEYS
enum { KIND_ROW = 0, KIND_READY = 1, KIND_NOT_READY_ROW = 2, KIND_SHARE = 3 };

// lex_argmin.py's _Static: the action's fixed arguments
struct Static {
  const int* job_queue;
  const uint8_t* job_valid;
  const int* group_job;
  const float* job_rows;    // f32[NR, J] static job key rows (NR <= 3)
  const float* group_rows;  // f32[KG, G]
  const uint8_t* queue_valid;
  const float* deserved;    // f32[Q, R] (pop rows)
  int J, G, KJ, KG, NR, R, F, staged, smem;
  int job_kind[MAX_KEYS];
  int job_row[MAX_KEYS];
};

// lex_argmin.py's _Call: a launch's own arguments
struct Call {
  const void* q;
  const uint8_t* ok;
  const int* q_entry;
  const float* queue_alloc;
  const uint8_t* job_has_pending;
  const uint8_t* job_ready;
  const float* job_share;
  const uint8_t* grp_elig;
  void* j_out;
  uint8_t* has_job_out;
  void* g_out;
  uint8_t* has_grp_out;
  uint8_t* jmask_out;  // bool[S, J] or null
  uint8_t* pop_out;
  uint8_t* burn_out;
  int S, q_wide, idx_wide, pop_mode;
};

// min that keeps a NaN, as jnp.min / torch.amin do
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }

// Block-wide reductions with one barrier: two alternating buffers, so a
// buffer is written again only after every thread has passed the barrier
// of the call between (and so finished reading it).
__device__ __forceinline__ float block_min_nan(float v, float (*red)[NW], int& parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  float* r = red[parity];
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = r[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = nan_min(m, r[w]);
  return m;
}

__device__ __forceinline__ int block_min_int(int v, int (*red)[NW], int& parity) {
  v = __reduce_min_sync(0xffffffffu, v);
  int* r = red[parity];
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = r[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = min(m, r[w]);
  return m;
}

// job key column k of job i, as job_order_keys computes it, from the
// job's static rows r0..r2 (st.job_row[k] picks one), its ready flag
// and its share
__device__ __forceinline__ float job_key(const Static& st, int k, float r0, float r1, float r2,
                                         bool ready, float share) {
  const int kind = st.job_kind[k], r = st.job_row[k];
  const float row = r == 0 ? r0 : (r == 1 ? r1 : r2);
  if (kind == KIND_ROW) return row;
  if (kind == KIND_READY) return ready ? 1.0f : 0.0f;
  if (kind == KIND_NOT_READY_ROW) return ready ? 0.0f : row;
  return share;
}

// job key column k of job i, read from global memory (the unstaged route)
__device__ __forceinline__ float job_key_at(const Static& st, const Call& c, int k, int i) {
  const float* rows = st.job_rows + i;
  const int J = st.J;
  return job_key(st, k, rows[0], st.NR > 1 ? rows[J] : 0.0f, st.NR > 2 ? rows[2 * J] : 0.0f,
                 c.job_ready && c.job_ready[i], c.job_share ? c.job_share[i] : 0.0f);
}

// The filter over candidates cand[0..M) and key columns 0..K-1 (from
// staged[k * M + i] when staged, else key(k, i)); returns the first
// surviving index, or M when none survives.
template <typename KeyFn>
__device__ __forceinline__ int lex_filter(uint8_t* cand, int M, int K, const float* staged,
                                          KeyFn key, float (*redf)[NW], int& pf,
                                          int (*redi)[NW], int& pi) {
  const int tid = threadIdx.x;
  for (int k = 0; k < K; ++k) {
    float lmin = INFINITY;
    for (int i = tid; i < M; i += TT) {
      const float v = cand[i] ? (staged ? staged[(size_t)k * M + i] : key(k, i)) : KAT_BIG;
      lmin = nan_min(lmin, v);
    }
    const float kmin = block_min_nan(lmin, redf, pf);
    for (int i = tid; i < M; i += TT) {
      if (cand[i]) cand[i] = (staged ? staged[(size_t)k * M + i] : key(k, i)) <= kmin;
    }
  }
  int first = M;
  for (int i = tid; i < M; i += TT) {
    if (cand[i]) {
      first = i;
      break;
    }
  }
  return block_min_int(first, redi, pi);
}

// Shared memory (dynamic): staged, the job keys [KJ][J], the group keys
// [KG][G], group_job [G] and grp_elig [G], then the candidates [max(J, G)];
// unstaged, the candidates only.
__global__ void __launch_bounds__(TT) turn_pick_kernel(const Static st, const Call c) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ float redf[2][NW];
  __shared__ int redi[2][NW];
  int pf = 0, pi = 0;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int J = st.J, G = st.G;
  float* jkeys = reinterpret_cast<float*>(sh);
  float* gkeys = jkeys + (size_t)st.KJ * J;
  int* gjob = reinterpret_cast<int*>(gkeys + (size_t)st.KG * G);
  uint8_t* gelig = reinterpret_cast<uint8_t*>(gjob + G);
  uint8_t* cand = st.staged ? gelig + G : sh;
  const long long q = c.q_wide ? static_cast<const long long*>(c.q)[row]
                               : static_cast<const int*>(c.q)[row];
  bool ok, active = false, q_over = false;
  if (c.pop_mode) {
    active = st.queue_valid[q] && c.q_entry[row] > 0;
    q_over = true;
    for (int f = 0; f < st.F; ++f) {
      const float alloc = c.queue_alloc[q * st.R + f];
      q_over = q_over && st.deserved[q * st.R + f] < __fadd_rn(alloc, KAT_EPS);
    }
    ok = active && !q_over;
  } else {
    ok = c.ok[row] != 0;
  }

  // ---- the job mask (and, staged, every key of every job and group:
  // the loads of a pass are in flight together, none waits on the mask)
  int any = 0;
  for (int i = tid; i < J; i += TT) {
    const bool m = ok && st.job_queue[i] == q && st.job_valid[i] && c.job_has_pending[i];
    cand[i] = m;
    if (c.jmask_out) c.jmask_out[(size_t)row * J + i] = m;
    any |= m;
    if (st.staged) {
      const float* rows = st.job_rows + i;
      const float r0 = rows[0], r1 = st.NR > 1 ? rows[J] : 0.0f;
      const float r2 = st.NR > 2 ? rows[2 * J] : 0.0f;
      const bool ready = c.job_ready && c.job_ready[i];
      const float share = c.job_share ? c.job_share[i] : 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_KEYS; ++k) {
        if (k < st.KJ) jkeys[(size_t)k * J + i] = job_key(st, k, r0, r1, r2, ready, share);
      }
    }
  }
  if (st.staged) {
    for (int i = tid; i < G; i += TT) {
      gjob[i] = st.group_job[i];
      gelig[i] = c.grp_elig[i];
#pragma unroll
      for (int k = 0; k < MAX_KEYS; ++k) {
        if (k < st.KG) gkeys[(size_t)k * G + i] = st.group_rows[(size_t)k * G + i];
      }
    }
  }
  const bool has_job = __syncthreads_or(any);
  int j = lex_filter(cand, J, st.KJ, st.staged ? jkeys : nullptr,
                     [&](int k, int i) { return job_key_at(st, c, k, i); }, redf, pf, redi, pi);
  if (j >= J) j = 0;

  // ---- the group pick (every thread is past the job pick's last
  // barrier, so the candidates can be overwritten)
  any = 0;
  for (int i = tid; i < G; i += TT) {
    const bool m = has_job && (st.staged ? gjob[i] == j && gelig[i]
                                         : st.group_job[i] == j && c.grp_elig[i]);
    cand[i] = m;
    any |= m;
  }
  const bool has_grp = __syncthreads_or(any);
  int g = lex_filter(cand, G, st.KG, st.staged ? gkeys : nullptr,
                     [&](int k, int i) { return st.group_rows[(size_t)k * G + i]; },
                     redf, pf, redi, pi);
  if (g >= G) g = 0;

  if (tid == 0) {
    if (c.idx_wide) {
      static_cast<long long*>(c.j_out)[row] = j;
      static_cast<long long*>(c.g_out)[row] = g;
    } else {
      static_cast<int*>(c.j_out)[row] = j;
      static_cast<int*>(c.g_out)[row] = g;
    }
    c.has_job_out[row] = has_job;
    c.has_grp_out[row] = has_grp;
    if (c.pop_mode) {
      c.pop_out[row] = ok && has_job;
      c.burn_out[row] = active && (q_over || !has_job);
    }
  }
}

}  // namespace

extern "C" int kat_turn_pick(const void* static_args, const void* call_args, void* stream) {
  const Static* st = static_cast<const Static*>(static_args);
  const Call* c = static_cast<const Call*>(call_args);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        turn_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (st->KJ > MAX_KEYS || st->KG > MAX_KEYS || st->smem > 200 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (c->S > 0) {
    turn_pick_kernel<<<c->S, TT, st->smem, (cudaStream_t)stream>>>(*st, *c);
  }
  return (int)cudaGetLastError();
}
