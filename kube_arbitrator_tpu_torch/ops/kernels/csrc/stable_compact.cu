// K16 stable_compact: a row-wise stable stream compaction with a cap, a
// pad value and the full count.
//
// Replaces three chains of the reference that compute this one function:
//   * ops/cycle.py:_compact_indices (:181-208): the commit's bind / evict
//     lists, bool[T] -> ascending i32[cap], -1 padded, and the full
//     population even past cap;
//   * ops/allocate.py:_compact_rows (:455-471) with the feasibility
//     predicate of _feasible_cells (:400-430), read from its inputs in
//     the same launch: per request class k and node n, the class fits
//     the node's predicate class (when the predicates plugin is on), the
//     node is valid and schedulable, and no requested resource of the
//     class's smallest request lies above max(idle, releasing) + EPS;
//     rows pad with N;
//   * ops/preempt.py:_build_view's panel (:233): the qualifying victims
//     bool[T] -> the [P] panel, padded with T.
//
// One launch a call.  A row is cut into `tiles` contiguous spans, a CTA
// a span (the grid K x tiles fits on the card at once: a cooperative
// launch when tiles > 1).  Each CTA counts its span's set elements and
// publishes the count as one 64-bit word stamped with the launch's
// number (seq << 32 | count), so no word is reset between launches; its
// warp 0 then reads the words of its row's other spans: the counts
// before its own give its base, all of them the row's count.  A second
// pass writes each set element's index at its rank below cap: a span of
// one chunk (every span at T = 102,400) keeps its flags and block ranks
// from the first pass, a longer one reads its chunks again from L1 / L2
// and scans them across the block (integer adds, exact in any order).
// The pads [count, cap)
// are spread over the row's CTAs; the row's first CTA writes the count.
// No host read, no scratch but the words.
//
// A row is a bool mask row (mask + k * L), a cells row (FeasCells: the
// predicate evaluated here), or, for the commit, the second of two rows
// given apart (mask1, idx1, count1, cap1, pad1), so the bind and evict
// lists are one launch.
//
// The plan (stable_compact.py's StableCompactPlan, one a device and row
// shape) binds the words and the launch shape once; a launch passes its
// rows, outputs, caps, pads and number.
//
// Bound: bytes — the mask (or the predicate inputs) read once, cap
// indices and the count written once: ~0.5 MB at T = 102,400 with cap
// 51,200 (~0.15 us at 3.35 TB/s).  The launch is the floor.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int CHUNK = THREADS * PER_THREAD;  // stable_compact.py's CHUNK
constexpr int AHEAD = 4;  // span words a lane of warp 0 reads at once
// A spin that outlasts this many polls means a CTA never published:
// trap (a launch error) rather than hang the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

// the plan's fixed arguments (stable_compact.py's _Static mirrors this layout)
struct Static {
  unsigned long long* words;  // [K * tiles] a span's count: seq << 32 | count
  int K, L, tiles, span;
};

// a launch's own arguments (stable_compact.py's _Call mirrors this layout)
struct Call {
  const uint8_t* mask;         // bool[K, L], or null: the cells below
  const uint8_t* mask1;        // row 1 given apart (the commit's second list), or null
  const uint8_t* class_fit;    // bool[K, CN]
  const int* node_klass;       // i32[L]
  const uint8_t* node_valid;   // bool[L]
  const uint8_t* node_unsched; // bool[L]
  const float* minreq;         // f32[K, R] or null: predicates only
  const float* basis;          // f32[L, R]
  int* idx;                    // i32[K, cap] out
  int* idx1;                   // i32[cap1] out, row 1 given apart
  int* count;                  // i32[K] out
  int* count1;                 // i32 out, row 1 given apart
  int CN, R, preds_on, cap, cap1, pad, pad1;
  unsigned seq;
};

struct Row {
  const uint8_t* mask;  // null: the cells
  int* idx;
  int* count;
  int cap, pad;
};

__device__ __forceinline__ Row row_of(const Call& c, int k, int L) {
  if (k == 1 && c.mask1 != nullptr) return Row{c.mask1, c.idx1, c.count1, c.cap1, c.pad1};
  return Row{c.mask != nullptr ? c.mask + (size_t)k * L : nullptr, c.idx + (size_t)k * c.cap,
             c.count + k, c.cap, c.pad};
}

// the flags of elements base .. base + PER_THREAD - 1 (false at or past
// hi), as bits; one 8-byte load where the row's bytes allow it
__device__ __forceinline__ unsigned flags_of(const Row& row, const Call& c, int k, int base,
                                             int hi) {
  unsigned bits = 0;
  if (row.mask != nullptr) {
    const uint8_t* m = row.mask + base;
    if (base + PER_THREAD <= hi && ((uintptr_t)m & 7) == 0) {
      const uint2 v = *reinterpret_cast<const uint2*>(m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bits |= ((v.x >> (8 * e)) & 0xffu) != 0 ? 1u << e : 0u;
        bits |= ((v.y >> (8 * e)) & 0xffu) != 0 ? 1u << (e + 4) : 0u;
      }
    } else {
      for (int e = 0; e < PER_THREAD; ++e)
        if (base + e < hi && m[e] != 0) bits |= 1u << e;
    }
  } else {
    // the cells: each level's loads for all PER_THREAD nodes issued together
    const int n_in = min(PER_THREAD, hi - base);
    uint8_t valid[PER_THREAD], unsched[PER_THREAD];
    int klass[PER_THREAD];
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const bool in = e < n_in;
      valid[e] = in ? c.node_valid[base + e] : 0;
      unsched[e] = in && c.preds_on ? c.node_unsched[base + e] : 0;
      klass[e] = in && c.preds_on ? c.node_klass[base + e] : 0;
    }
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      bool ok = valid[e] != 0;
      if (c.preds_on) ok = ok && unsched[e] == 0 && c.class_fit[(size_t)k * c.CN + klass[e]] != 0;
      if (ok) bits |= 1u << e;
    }
    // no requested resource of the class's smallest request above basis + EPS
    if (c.minreq != nullptr) {
      for (int r = 0; r < c.R; ++r) {
        const float m = c.minreq[(size_t)k * c.R + r];
        if (!(m > 0.f && m < 1.5e38f)) continue;
        const float lim = __fsub_rn(m, KAT_EPS);
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e)
          if (((bits >> e) & 1u) && c.basis[(size_t)(base + e) * c.R + r] < lim) bits &= ~(1u << e);
      }
    }
  }
  return bits;
}

__device__ __forceinline__ int await_count(const unsigned long long* w, unsigned seq) {
  unsigned long long x = __ldcv(w);
  for (unsigned spin = 0; (unsigned)(x >> 32) != seq; ++spin) {
    if (spin > SPIN_LIMIT) __trap();
    __nanosleep(32);
    x = __ldcv(w);
  }
  return (int)(unsigned)x;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS) stable_compact_kernel(const Static s, const Call c) {
  __shared__ int others[2];  // the counts of the row's other spans: before this one, all
  const int k = blockIdx.x / s.tiles, t = blockIdx.x - k * s.tiles;
  const Row row = row_of(c, k, s.L);
  const int lo = t * s.span, hi = min(s.L, lo + s.span);
  const int tid = threadIdx.x;

  // ---- pass 1: the span's count (the first chunk's flags and ranks kept
  // for pass 2)
  int n = 0;
  unsigned first = 0;
  for (int cb = lo; cb < hi; cb += CHUNK) {
    const unsigned bits = flags_of(row, c, k, cb + tid * PER_THREAD, hi);
    if (cb == lo) first = bits;
    n += __popc(bits);
  }
  int own;
  const int rank = kat_block_excl_scan(n, &own);  // in a one-chunk span, the chunk's ranks

  // ---- the row's other spans: warp 0 reads their words, AHEAD at once a lane
  int before = 0, all = own;
  if (s.tiles > 1) {
    if (tid < 32) {
      unsigned long long* words = s.words + (size_t)k * s.tiles;
      if (tid == 0) atomicExch(words + t, ((unsigned long long)c.seq << 32) | (unsigned)own);
      int b = 0, a = 0;
      for (int u0 = tid; u0 < s.tiles; u0 += 32 * AHEAD) {
        unsigned long long x[AHEAD];
#pragma unroll
        for (int i = 0; i < AHEAD; ++i) {
          const int u = u0 + 32 * i;
          x[i] = u < s.tiles && u != t ? __ldcv(words + u) : 0ull;
        }
#pragma unroll
        for (int i = 0; i < AHEAD; ++i) {
          const int u = u0 + 32 * i;
          if (u >= s.tiles) break;
          if (u == t) continue;
          const int v = (unsigned)(x[i] >> 32) == c.seq ? (int)(unsigned)x[i]
                                                         : await_count(words + u, c.seq);
          a += v;
          if (u < t) b += v;
        }
      }
      b = warp_sum(b);
      a = warp_sum(a);
      if (tid == 0) {
        others[0] = b;
        others[1] = a;
      }
    }
    __syncthreads();
    before = others[0];
    all = own + others[1];
  }

  // ---- pass 2: each set element's index at its rank below cap
  int* out = row.idx;
  if (hi - lo <= CHUNK) {  // one chunk: its flags and ranks are pass 1's
    const int base = lo + tid * PER_THREAD;
    int pos = before + rank;
    for (unsigned m = first; m != 0 && pos < row.cap; m &= m - 1, ++pos) out[pos] = base + __ffs(m) - 1;
  } else {
    int base_rank = before;
    for (int cb = lo; cb < hi; cb += CHUNK) {
      const int base = cb + tid * PER_THREAD;
      const unsigned bits = cb == lo ? first : flags_of(row, c, k, base, hi);
      int chunk_n;
      int pos = base_rank + kat_block_excl_scan(__popc(bits), &chunk_n);
      for (unsigned m = bits; m != 0 && pos < row.cap; m &= m - 1, ++pos) out[pos] = base + __ffs(m) - 1;
      base_rank += chunk_n;
    }
  }
  // ---- pads: this CTA's share of the positions [count, cap)
  const int ospan = (row.cap + s.tiles - 1) / s.tiles;
  const int phi = min(row.cap, (t + 1) * ospan);
  for (int p = max(all, t * ospan) + tid; p < phi; p += THREADS) out[p] = row.pad;
  if (t == 0 && tid == 0) *row.count = all;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  }
  return sms;
}

}  // namespace

// The CTAs the card holds at once for this kernel (0 on error): a plan's
// rows x tiles stay within it, so the spans of a row can wait on each
// other.
extern "C" int kat_stable_compact_capacity() {
  static int per_sm = 0;
  if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, stable_compact_kernel, THREADS, 0) != cudaSuccess) {
    return 0;
  }
  return per_sm * sm_count();
}

extern "C" int kat_stable_compact(const void* static_args, const void* call_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Call& c = *static_cast<const Call*>(call_args);
  if (s.K <= 0 || s.L < 0 || s.tiles < 1 || s.span < CHUNK || s.span % CHUNK != 0 ||
      (long long)s.tiles * s.span < s.L || c.cap < 0 || c.cap1 < 0 || c.seq == 0 ||
      (s.tiles > 1 && s.words == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(s.K * s.tiles);
  cudaStream_t st = (cudaStream_t)stream;
  if (s.tiles == 1) {
    stable_compact_kernel<<<grid, THREADS, 0, st>>>(s, c);
    return (int)cudaGetLastError();
  }
  void* args[] = {const_cast<Static*>(&s), const_cast<Call*>(&c)};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)stable_compact_kernel, grid,
                                                    dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
