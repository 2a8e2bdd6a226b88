// K4 segment_sum: out[idx[i]] += val[i] in SLOT ORDER, f32 and i32,
// out-of-range indices dropped.
//
// Replaces the segment sums of kube_arbitrator_tpu/ops/cycle.py:
// open_session (:233-239, :265-266) and ops/fairness.py (:178), keeping
// the contract of the reference's host kernels kat_scatter_add_f32/_i32
// (ops/native/segsum.cc via segsum.py:108-201): per segment the values
// are added one after another in slot order, from zero or (accumulate !=
// 0) from out's own row, in place; no float atomics, so a f32 result
// equals the sequential scatter bit for bit.
//
// The sums (sum_group, shared by both entries): a CTA takes a group of
// consecutive segments, whose slots are one contiguous run of the slot
// order.  Every thread stages the run's rows val[perm[j]] into shared
// memory, STAGE elements a chunk (the perm reads coalesced, the gathers
// in parallel); then, per (segment, column), one thread runs the
// dependent chain over the chunk from shared memory, its loads 8 ahead
// of its adds.  The next chunk's
// perm entries and rows are already in flight in registers while the
// chain runs, so one long segment (ordered_sum's 10,240 rows) costs about
// its chain of dependent adds.  The first design gave each (segment,
// column) one thread that walked its run with a dependent gathered global
// load per slot.
//
// * kat_segment_sum_*: the caller's slot order (perm, seg_start), or, with
//   perm == nullptr, the identity (ordered_sum: one segment of n rows with
//   seg_start == nullptr, so no order tensor exists).  One plain launch.
// * kat_segment_sum_count_*: no order given.  One cooperative launch that
//   computes the order and sums over it, with three grid barriers:
//   1. per tile of TILE slots, each segment's count (shared-memory counts,
//      lanes of one segment aggregated by __match_any_sync);
//   2. per segment, the exclusive prefix of its counts over the tiles and
//      its total (a warp per segment: its loads over the tiles in flight
//      together, scanned by shuffles);
//   3. every CTA scans the totals into the segment starts (CTA 0 publishes
//      them), then ranks each of its tiles' slots stably (per-warp counts
//      of contiguous slots) and writes perm; out-of-range slots get no
//      position;
//   4. the sums over the order just written.
//   A grid barrier rather than K19's decoupled look-back: the look-back
//   walks the tiles one dependent L2 round trip at a time (~35 us for
//   K19's counting pass at 102,400 slots -> 1,024 segments on one H100,
//   PERF.md), where a barrier costs one round trip for all of them.  The
//   launch leaves its barrier word zero again, so the workspace is zeroed
//   once, when the wrapper allocates it.
//
// Bound: bytes — val read once (T*C*4), idx or the permutation and
// segment starts read once, out written once: ~2 MB at T = 100k, C = 4,
// ~0.6 us at 3.35 TB/s.  The floor for a long segment is its chain of
// dependent adds (~4 cycles each: ~23 us for 10,240 rows); for the count
// route the cooperative launch and its barriers.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TT = 256;          // threads of a CTA
constexpr int TW = TT / 32;      // warps of a CTA
constexpr int STAGE = 4096;      // staged elements (rows * C) a chunk
constexpr int RPT = STAGE / TT;  // staged rows a thread a chunk, at most (C = 1)
constexpr int IPT = 4;           // count route: slots a thread a tile
constexpr int TILE = TT * IPT;   // count route: slots a tile (segment_sum.py's COUNT_TILE)
constexpr int MAX_SEGMENTS = 6144;  // count route (segment_sum.py's COUNT_MAX_SEGMENTS)
constexpr int MAX_COLUMNS = 1024;   // segment_sum.py's MAX_COLUMNS
constexpr unsigned SPIN_LIMIT = 1u << 24;

__device__ __forceinline__ float kat_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int kat_add(int a, int b) { return a + b; }

// segment s's first slot in the order: seg_start[s], or with no
// seg_start one segment of n slots (s == 0) and empty ones after it
__device__ __forceinline__ int start_of(const int* seg_start, int n, int s) {
  return seg_start ? __ldcg(seg_start + s) : (s == 0 ? 0 : n);
}

// x + col[a * C] + ... + col[(b - 1) * C], one add after another in that
// order.  Two register sets alternate, so the loads of the next eight
// values are in flight while the adds of these eight run.
template <typename T>
__device__ __forceinline__ T chain(T x, const T* col, int C, int a, int b) {
  int j = a;
  if (b - j >= 24) {
    T A[8], B[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) A[k] = col[(size_t)(j + k) * C];
    for (; j + 24 <= b; j += 16) {
#pragma unroll
      for (int k = 0; k < 8; ++k) B[k] = col[(size_t)(j + 8 + k) * C];
#pragma unroll
      for (int k = 0; k < 8; ++k) x = kat_add(x, A[k]);
#pragma unroll
      for (int k = 0; k < 8; ++k) A[k] = col[(size_t)(j + 16 + k) * C];
#pragma unroll
      for (int k = 0; k < 8; ++k) x = kat_add(x, B[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) x = kat_add(x, A[k]);
    j += 8;
  }
  for (; j < b; ++j) x = kat_add(x, col[(size_t)j * C]);
  return x;
}

// A 4-byte asynchronous copy from global into shared memory (cp.async):
// the copies of the next chunk run while this chunk's chains do.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sums of segments s0 .. s0 + ns - 1 (every thread of the CTA calls
// it).  sh: two stages of STAGE elements of T, then the group's ns + 1
// starts, then its ns * C running sums.  Chunk i (CH rows) is staged in
// stage i % 2 by asynchronous copies issued while chunk i - 1's chains
// run: thread t copies rows t, t + TT, ... of the chunk, each row's C
// contiguous values; the slot order's rows (perm reads) are loaded a
// chunk ahead into registers.
template <typename T>
__device__ void sum_group(const T* __restrict__ val, const int* perm, const int* seg_start, int n,
                          int s0, int ns, int C, int accumulate, T* __restrict__ out, void* sh) {
  T* stage = static_cast<T*>(sh);
  int* bnd = reinterpret_cast<int*>(stage + 2 * STAGE);
  T* acc = reinterpret_cast<T*>(bnd + TT + 1);
  const int tid = threadIdx.x;
  const int pairs = ns * C;
  for (int k = tid; k <= ns; k += TT) bnd[k] = start_of(seg_start, n, s0 + k);
  for (int p = tid; p < pairs; p += TT) acc[p] = accumulate ? out[(size_t)s0 * C + p] : (T)0;
  __syncthreads();
  const int lo = bnd[0], hi = bnd[ns];
  const int CH = STAGE / C;  // rows a chunk (at most STAGE: RPT rows a thread)
  const int nch = (hi - lo + CH - 1) / CH;
  int src[RPT];  // the slot order's rows of the next chunk's rows tid + q * TT (-1: none)
  auto rows_of = [&](int c0) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int k = tid + q * TT, r = lo + c0 * CH + k;
      src[q] = k < CH && r < hi ? (perm ? __ldcg(perm + r) : r) : -1;
    }
  };
  auto issue = [&](int c0) {  // chunk c0's copies into its stage, from the rows in src
    T* dst = stage + (c0 & 1) * STAGE;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (src[q] >= 0) {
        const T* from = val + (size_t)src[q] * C;
        T* to = dst + (size_t)(tid + q * TT) * C;
        for (int c = 0; c < C; ++c) cp_async4(to + c, from + c);
      }
    }
    cp_async_commit();
  };
  if (nch > 0) {
    rows_of(0);
    issue(0);
    if (nch > 1) rows_of(1);
  }
  for (int i = 0; i < nch; ++i) {
    if (i + 1 < nch) {
      issue(i + 1);
      if (i + 2 < nch) rows_of(i + 2);
      cp_async_wait<1>();  // chunk i's copies landed (i + 1's may be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int clo = lo + i * CH, chi = min(hi, clo + CH);
    const T* cur = stage + (i & 1) * STAGE;
    for (int p = tid; p < pairs; p += TT) {
      const int k = p / C, c = p - k * C;
      const int a = max(bnd[k], clo), b = min(bnd[k + 1], chi);
      if (a < b) acc[p] = chain<T>(acc[p], cur + c, C, a - clo, b - clo);
    }
    __syncthreads();  // stage i % 2 is free for chunk i + 2
  }
  for (int p = tid; p < pairs; p += TT) out[(size_t)s0 * C + p] = acc[p];
}

template <typename T>
__global__ void __launch_bounds__(TT) ordered_kernel(const T* __restrict__ val,
                                                     const int* __restrict__ perm,
                                                     const int* __restrict__ seg_start, int n,
                                                     int S, int C, int spc, int accumulate,
                                                     T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sh[];
  const int s0 = blockIdx.x * spc;
  if (s0 < S) sum_group<T>(val, perm, seg_start, n, s0, min(spc, S - s0), C, accumulate, out, sh);
}

// Every CTA arrives; the k-th barrier completes when the arrivals reach
// k * gridDim.x.  A spin past SPIN_LIMIT traps (a launch error) rather
// than hang the card.
__device__ __forceinline__ void grid_barrier(int* arrivals, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1);
    const int target = k * (int)gridDim.x;
    for (unsigned spin = 0; __ldcv(arrivals) < target; ++spin) {
      if (spin > SPIN_LIMIT) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// lanes a segment in the count route's phase 2: the grid's threads over
// the segments, rounded down to a power of two in [1, 32]
__host__ __device__ __forceinline__ int lanes_per_segment(int S, int grid) {
  const int share = (grid * TT) / (S > 0 ? S : 1);
  int L = 1;
  while (L < 32 && 2 * L <= share) L *= 2;
  return L;
}

// The workspace (int32 words): [0] barrier arrivals (zero between
// launches), then seg_start [S + 1], totals [S], the per-tile counts and
// their prefixes [ntiles][S], perm [n].
template <typename T>
__global__ void __launch_bounds__(TT) count_kernel(const T* __restrict__ val,
                                                   const int* __restrict__ idx, int n, int S,
                                                   int C, int spc, int accumulate,
                                                   T* __restrict__ out, int* ws) {
  extern __shared__ __align__(16) unsigned char sh[];
  int* cnt = reinterpret_cast<int*>(sh);  // [S] in phase 1, [TW][S] in phase 3
  int* start = cnt + TW * S;              // [S + 1], phase 3
  const int ntiles = (n + TILE - 1) / TILE;
  int* ctl = ws;
  int* seg_start = ws + 4;
  int* totals = seg_start + S + 1;
  int* M = totals + S;
  int* perm = M + (size_t)ntiles * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  // ---- 1. per tile, each segment's count
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int b = tid; b < S; b += TT) cnt[b] = 0;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int i = tile * TILE + q * TT + tid;
      const int d = i < n ? idx[i] : -1;
      const int key = (d >= 0 && d < S) ? d : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[key], __popc(peers));
    }
    __syncthreads();
    for (int b = tid; b < S; b += TT) M[(size_t)tile * S + b] = cnt[b];
    __syncthreads();
  }
  grid_barrier(ctl, 1);

  // ---- 2. per segment, its exclusive prefix over the tiles and its
  // total: L lanes a segment (L a power of two, as many as the grid's
  // threads allow, at most 32); lane l of a group takes tiles l, l + L,
  // ..., 8 of them loaded together, scanned L at a time by shuffles
  {
    const int L = lanes_per_segment(S, gridDim.x);
    const int per_warp = 32 / L, sub = lane & (L - 1);
    const int warps = gridDim.x * TW;
    for (int b0 = ((blockIdx.x * TT + tid) >> 5) * per_warp; b0 < S; b0 += warps * per_warp) {
      const int b = b0 + lane / L;
      const bool ok = b < S;
      int carry = 0;
      for (int t0 = 0; t0 < ntiles; t0 += 8 * L) {
        int x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = t0 + u * L + sub;
          x[u] = ok && t < ntiles ? __ldcg(&M[(size_t)t * S + b]) : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          int incl = x[u];
          for (int o = 1; o < L; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o, L);
            if (sub >= o) incl += y;
          }
          const int t = t0 + u * L + sub;
          if (ok && t < ntiles) M[(size_t)t * S + b] = carry + incl - x[u];
          carry += __shfl_sync(0xffffffffu, incl, L - 1, L);
        }
      }
      if (ok && sub == 0) totals[b] = carry;
    }
  }
  grid_barrier(ctl, 2);

  // ---- 3. the segment starts (every CTA its own copy), then perm
  {
    for (int b = tid; b < S; b += TT) start[b] = __ldcg(&totals[b]);  // loads in flight together
    __syncthreads();
    const int per = (S + TT - 1) / TT, b0 = min(S, tid * per), b1 = min(S, b0 + per);
    int s = 0;
    for (int b = b0; b < b1; ++b) s += start[b];
    int total;
    int run = kat_block_excl_scan(s, &total);
    for (int b = b0; b < b1; ++b) {
      const int x = start[b];
      start[b] = run;
      run += x;
    }
    if (tid == 0) start[S] = total;
    __syncthreads();
    if (blockIdx.x == 0) {
      for (int b = tid; b <= S; b += TT) seg_start[b] = start[b];
    }
  }
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int e = tid; e < TW * S; e += TT) cnt[e] = 0;
    __syncthreads();
    // warp w ranks the contiguous slots base .. base + 32 * IPT - 1
    const int base = tile * TILE + warp * (32 * IPT);
    int key[IPT], rank[IPT];
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int i = base + q * 32 + lane;
      const int d = i < n ? idx[i] : -1;
      key[q] = (d >= 0 && d < S) ? d : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key[q]);
      const int before = key[q] >= 0 ? cnt[warp * S + key[q]] : 0;
      __syncwarp();
      if (key[q] >= 0 && lane == __ffs(peers) - 1) cnt[warp * S + key[q]] = before + __popc(peers);
      __syncwarp();
      rank[q] = before + __popc(peers & lt);
    }
    __syncthreads();
    for (int b = tid; b < S; b += TT) {
      int run = start[b] + __ldcg(&M[(size_t)tile * S + b]);
      for (int w = 0; w < TW; ++w) {
        const int x = cnt[w * S + b];
        cnt[w * S + b] = run;
        run += x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      if (key[q] >= 0) perm[cnt[warp * S + key[q]] + rank[q]] = base + q * 32 + lane;
    }
    __syncthreads();  // cnt is reused by the CTA's next tile
  }
  grid_barrier(ctl, 3);
  // the last CTA past the last barrier resets the word for the next launch
  if (tid == 0 && atomicAdd(ctl, 1) == 4 * (int)gridDim.x - 1) atomicExch(ctl, 0);

  // ---- 4. the sums over the order just written
  for (int s0 = blockIdx.x * spc; s0 < S; s0 += gridDim.x * spc) {
    sum_group<T>(val, perm, seg_start, n, s0, min(spc, S - s0), C, accumulate, out, sh);
    __syncthreads();
  }
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

// segments a group: enough groups for `ctas` CTAs twice over, and at most
// TT / C chains (one a thread) unless one segment has more columns
int group_size(int S, int C, int ctas) {
  const int want = (S + 2 * ctas - 1) / (2 * ctas);
  return std::max(1, std::min(want, std::max(1, TT / C)));
}

template <typename T>
size_t sum_smem(int C) {
  return 2 * STAGE * sizeof(T) + (TT + 1) * sizeof(int) + (size_t)std::max(TT, C) * sizeof(T);
}

template <typename T>
int launch_ordered(const T* val, const int* perm, const int* seg_start, int n, int S, int C,
                   int accumulate, T* out, void* stream) {
  if (C < 1 || C > MAX_COLUMNS) return (int)cudaErrorInvalidValue;
  if (S <= 0) return (int)cudaGetLastError();
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int spc = group_size(S, C, sms);
  const int grid = (S + spc - 1) / spc;
  ordered_kernel<T><<<grid, TT, sum_smem<T>(C), (cudaStream_t)stream>>>(
      val, perm, seg_start, n, S, C, spc, accumulate, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_count(const T* val, const int* idx, int n, int S, int C, int accumulate, T* out,
                 int* ws, int ws_words, void* stream) {
  if (C < 1 || C > MAX_COLUMNS || S > MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  if (S <= 0) return (int)cudaGetLastError();
  // no slot: every segment empty (no order to compute)
  if (n == 0) return launch_ordered<T>(val, nullptr, nullptr, 0, S, C, accumulate, out, stream);
  const int ntiles = (n + TILE - 1) / TILE;
  if (ws_words < 4 + 2LL * S + 1 + (long long)ntiles * S + n) return (int)cudaErrorInvalidValue;
  const size_t smem = std::max((size_t)(TW * S + S + 1) * sizeof(int), sum_smem<T>(C));
  static bool smem_set = false;
  cudaError_t e;
  if (!smem_set) {  // whole KB, as the occupancy query below asks
    const size_t most = std::max((size_t)(TW * MAX_SEGMENTS + MAX_SEGMENTS + 1) * sizeof(int),
                                 sum_smem<T>(MAX_COLUMNS));
    e = cudaFuncSetAttribute(count_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)((most + 1023) / 1024 * 1024));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // CTAs a multiprocessor holds at each shared-memory size seen (whole KB)
  static int per_sm_at_kb[232] = {0};
  const size_t kb = (smem + 1023) / 1024;
  if (kb >= 232) return (int)cudaErrorInvalidValue;
  int& per_sm = per_sm_at_kb[kb];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel<T>, TT, kb * 1024);
    if (e != cudaSuccess) return (int)e;
  }
  const int sms = sm_count();
  if (per_sm < 1 || sms == 0) return (int)cudaErrorInvalidConfiguration;
  // a CTA a tile, and no fewer CTAs than segments up to one a
  // multiprocessor, so the sums of many short segments spread out
  const int grid = std::min(std::max(ntiles, std::min(S, sms)), per_sm * sms);
  const int spc = group_size(S, C, grid);
  int nn = n, ss = S, cc = C, sp = spc, acc = accumulate;
  void* args[] = {(void*)&val, (void*)&idx, &nn, &ss, &cc, &sp, &acc, (void*)&out, (void*)&ws};
  e = cudaLaunchCooperativeKernel((const void*)count_kernel<T>, dim3(grid), dim3(TT), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kat_segment_sum_f32(const float* val, const int* perm, const int* seg_start, int n,
                                   int nseg, int C, int accumulate, float* out, void* stream) {
  return launch_ordered<float>(val, perm, seg_start, n, nseg, C, accumulate, out, stream);
}

extern "C" int kat_segment_sum_i32(const int* val, const int* perm, const int* seg_start, int n,
                                   int nseg, int C, int accumulate, int* out, void* stream) {
  return launch_ordered<int>(val, perm, seg_start, n, nseg, C, accumulate, out, stream);
}

extern "C" int kat_segment_sum_count_f32(const float* val, const int* idx, int n, int nseg, int C,
                                         int accumulate, float* out, int* ws, int ws_words,
                                         void* stream) {
  return launch_count<float>(val, idx, n, nseg, C, accumulate, out, ws, ws_words, stream);
}

extern "C" int kat_segment_sum_count_i32(const int* val, const int* idx, int n, int nseg, int C,
                                         int accumulate, int* out, int* ws, int ws_words,
                                         void* stream) {
  return launch_count<int>(val, idx, n, nseg, C, accumulate, out, ws, ws_words, stream);
}
