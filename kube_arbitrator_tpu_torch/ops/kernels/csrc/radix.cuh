// Stable LSD radix sorting on the card, shared by K19 (csrc/stable_sort.cu)
// and K9 (csrc/turn_caps.cu).  Keys are signed int32 sorted by 8-bit digits,
// least significant first; a digit is taken of x ^ 0x80000000, which puts
// the keys in unsigned order (INT_MIN first, INT_MAX last).  Every pass is
// stable, so the sort is.
//
// * block_radix_pass: one digit pass of a one-CTA sort (THREADS threads):
//   per-warp digit histograms, one block scan in (digit, warp) order, then
//   each warp scatters its contiguous chunk 32 * U items at a time, lanes
//   of one digit ranked by __match_any_sync / __popc.  A pass in which
//   every item has one digit moves nothing and is skipped.  The caller's
//   load / store functors say where the keys and their payloads live
//   (K19: global memory, gathered from the caller's keys; K9: shared
//   memory).
// * run_tiles: the tiled variant, one cooperative launch of co-resident
//   CTAs (K19's large n; K9 above its one-CTA limit).  What bounds the
//   one-CTA sort is that one SM of 132 runs every pass; the launch runs
//   the whole sort with a grid barrier between its phases:
//   1. the global digit histograms of every pass, each key read once
//      (warp-aggregated shared-memory counts);
//   2. CTA 0 scans them into each digit's first output slot and decides
//      which passes move an item (a pass whose histogram has one digit
//      holding all n is skipped, at no cost) and which ping-pong buffer
//      each live pass reads and writes: nothing is read back to the host;
//   3. each live pass over tiles of TILE items.  CTA b takes tiles b,
//      b + grid, ... in increasing order; the launch is cooperative, so
//      every CTA is resident and a tile's look-back only ever waits on
//      lower tiles that a running CTA holds.  A tile ranks its
//      items in one walk (lanes of one digit by __match_any_sync /
//      __popc, per-warp counts in shared memory), publishes its per-digit
//      counts, and finds each digit's global base by decoupled look-back
//      over the tiles before it.  Tile order is index order and the rank
//      inside a tile is index order, so the pass is stable.  The last
//      live pass writes the outputs directly.
//   Data another CTA wrote before a barrier is read through L2 (__ldcg).
//
// Everything lies in an anonymous namespace: each kernel library that
// includes this header has its own copy (and the profiler's names of its
// kernels start with "(anonymous namespace)::").
#pragma once
#include "common.cuh"

namespace {
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int ROW = RADIX + 1;  // a warp's counts; +1 spreads the banks
constexpr int MAX_KEYS = 6;     // stable_sort.py's MAX_KEYS
constexpr int MAX_PASSES = 4 * MAX_KEYS;
constexpr int U = 4;            // items in flight per lane

// the tiled variant (stable_sort.py's TILE and workspace_words mirror these)
constexpr int TT = 256;          // threads of a tile CTA
constexpr int TW = TT / 32;      // warps of a tile CTA
constexpr int IPT = 8;           // items per thread
constexpr int TILE = TT * IPT;   // items per tile
constexpr int DPT = 8;           // digits (bins) per thread at most
constexpr int MAX_BINS = TT * DPT;  // stable_sort.py's COUNT_MAX_BINS
constexpr unsigned FLAG_AGG = 1u << 30, FLAG_INC = 2u << 30, COUNT_MASK = FLAG_AGG - 1;

// per-pass info words written by the pass plan
constexpr int LIVE = 1, IN_B = 2, OUT_B = 4, IDENT = 8, GATHER = 16, LAST = 32;

struct Keys {
  const int* k[MAX_KEYS];
};

__device__ __forceinline__ unsigned digit_of(int x, int shift) {
  return (((unsigned)x ^ 0x80000000u) >> shift) & 0xFFu;
}

// One stable digit pass of a one-CTA sort of n items (blockDim.x == THREADS;
// every thread calls it).  Warp w owns the contiguous chunk [lo, hi) of the
// input order.  load(i, x, p) gives item i's key x and payload p; store(pos,
// x, p) puts an item at its output position.  cnt is shared [WARPS * ROW],
// uniform a shared int.  Returns false, having stored nothing, when every
// item has the same digit at ``shift``.
template <class Load, class Store>
__device__ __forceinline__ bool block_radix_pass(int n, int lo, int hi, int shift, int* cnt,
                                                 int* uniform, Load load, Store store) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int e = tid; e < WARPS * ROW; e += THREADS) cnt[e] = 0;
  if (tid == 0) *uniform = 0;
  __syncthreads();
  for (int base = lo; base < hi; base += 32 * U) {
    int x[U], p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 32 * u + lane;
      if (i < hi) load(i, x[u], p[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + 32 * u + lane < hi) atomicAdd(&cnt[warp * ROW + digit_of(x[u], shift)], 1);
    }
  }
  __syncthreads();
  if (tid < RADIX) {
    int tot = 0;
    for (int w = 0; w < WARPS; ++w) tot += cnt[w * ROW + tid];
    if (tot == n) *uniform = 1;
  }
  __syncthreads();
  const bool skip = *uniform;
  __syncthreads();  // every thread has read it before the next pass resets it
  if (skip) return false;
  {
    // thread t scans digit t/4 over warps 8*(t%4) .. 8*(t%4)+7
    const int d = tid >> 2, w0 = (tid & 3) * 8;
    int v[8], s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = cnt[(w0 + j) * ROW + d];
      s += v[j];
    }
    int total;
    int run = kat_block_excl_scan(s, &total);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cnt[(w0 + j) * ROW + d] = run;
      run += v[j];
    }
  }
  __syncthreads();
  for (int base = lo; base < hi; base += 32 * U) {
    int x[U], p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 32 * u + lane;
      if (i < hi) load(i, x[u], p[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + 32 * u + lane < hi;
      const unsigned d = ok ? digit_of(x[u], shift) : RADIX;  // RADIX: no item
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (ok) store(cnt[warp * ROW + d] + __popc(peers & lt), x[u], p[u]);
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) cnt[warp * ROW + d] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();  // the block's writes are visible to it after this
  return true;
}

// ---- the tiled variant: one cooperative launch

// The passes of one sort: pass p sorts by key key_of[p]'s digit at
// shift_of[p] (radix), or, when count_S >= 0, by the key itself clamped to
// [0, S] with out-of-range keys at S (one counting pass, S + 1 bins).
struct Plan {
  Keys keys;
  int nkeys, npass, bins, count_S;
  signed char key_of[MAX_PASSES];
  signed char shift_of[MAX_PASSES];
};

// The device workspace (int32 words, zeroed before the launch).
struct Work {
  int* ctl;          // [0] grid-barrier arrivals, [1] some pass is live
  int* offs;         // [npass][bins] histograms, then their exclusive scans
  int* info;         // [npass] LIVE | IN_B | OUT_B | IDENT | GATHER | LAST
  unsigned* status;  // [npass][ntiles][bins] look-back words: flag | count
};

struct Buffers {
  int *kA, *pA, *kB, *pB;  // ping-pong keys and perm
  int* perm_out;
  int* key_out;            // the primary key sorted, or nullptr
  int* seg_start;          // the counting pass's scanned histogram, or nullptr
};

// A spin that outlasts this many polls means the co-residency the launch
// was granted failed: trap (a launch error) rather than hang the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

__device__ __forceinline__ int bin_of(const Plan& pl, int x, int p) {
  if (pl.count_S >= 0) return (x >= 0 && x < pl.count_S) ? x : pl.count_S;
  return (int)digit_of(x, pl.shift_of[p]);
}

// Every CTA of the grid arrives; the k-th barrier of the launch completes
// when the arrival count reaches k * gridDim.x.  Data written before it by
// other CTAs is read after it through L2 (__ldcg).
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

// Global histograms of every pass: each CTA counts its chunks of TILE
// items in shared memory (lanes of one bin aggregated by
// __match_any_sync) and adds its counts once.
__device__ void histograms(const Plan& pl, int n, int ntiles, const Work& w, int* sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = pl.npass, B = pl.bins, total = P * B;
  for (int e = tid; e < total; e += TT) sh[e] = 0;
  __syncthreads();
  for (int c = blockIdx.x; c < ntiles; c += gridDim.x) {
    const int hi = min(n, (c + 1) * TILE);
    for (int base = c * TILE + warp * 32; base < hi; base += TT) {
      const int i = base + lane;
      const bool ok = i < hi;
      int k_loaded = -1, x = 0;
      for (int p = 0; p < P; ++p) {
        const int k = pl.key_of[p];
        if (k != k_loaded) {
          x = ok ? pl.keys.k[k][i] : 0;
          k_loaded = k;
        }
        const int d = ok ? bin_of(pl, x, p) : B;  // B: no item
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (ok && lane == __ffs(peers) - 1) atomicAdd(&sh[p * B + d], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < total; e += TT) {
    if (sh[e]) atomicAdd(&w.offs[e], sh[e]);
  }
}

// CTA 0, after the histograms: scan each pass's counts into its digits'
// first output slots (the counting pass's scan is seg_start), and decide
// which passes move an item (no digit holds all n) and which buffers each
// live pass reads and writes.
__device__ void plan_passes(const Plan& pl, int n, const Work& w, int* sh, int* seg_start) {
  __shared__ int live_s[MAX_PASSES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = pl.npass, B = pl.bins, total = P * B;
  for (int e = tid; e < total; e += TT) sh[e] = __ldcg(&w.offs[e]);
  __syncthreads();
  for (int p = warp; p < P; p += TW) {
    const int* row = sh + p * B;
    const int per = (B + 31) / 32, b0 = min(B, lane * per), b1 = min(B, b0 + per);
    int s = 0, mx = 0;
    for (int b = b0; b < b1; ++b) {
      s += row[b];
      mx = max(mx, row[b]);
    }
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    int run = incl - s;
    for (int b = b0; b < b1; ++b) {
      const int v = row[b];
      w.offs[p * B + b] = run;
      if (seg_start) seg_start[b] = run;
      run += v;
    }
    if (lane == 0) live_s[p] = mx < n;
  }
  __syncthreads();
  if (tid == 0) {
    int nlive = 0, last = -1;
    bool key_live[MAX_KEYS] = {false, false, false, false, false, false};
    for (int p = 0; p < P; ++p) {
      const int k = pl.key_of[p];
      int info = (nlive == 0 ? IDENT : 0) | (key_live[k] ? 0 : GATHER);
      if (live_s[p]) {
        info |= LIVE | ((nlive & 1) ? OUT_B : 0) | ((nlive > 0 && !(nlive & 1)) ? IN_B : 0);
        ++nlive;
        key_live[k] = true;
        last = p;
      }
      w.info[p] = info;
    }
    if (last >= 0) w.info[last] |= LAST;
    w.ctl[1] = nlive > 0;
  }
}

// One tile of a live pass: rank its items in one walk, publish its per-
// digit counts, find each digit's global base by decoupled look-back over
// the tiles before it, scatter.
__device__ void sort_tile(const Plan& pl, int p, int info, int tile, int n, int ntiles,
                          const Work& w, const Buffers& bf, int* cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = pl.bins;
  for (int e = tid; e < TW * B; e += TT) cnt[e] = 0;
  __syncthreads();
  const int k = pl.key_of[p];
  const int* src = pl.keys.k[k];
  const int* primary = pl.keys.k[pl.nkeys - 1];
  const bool ident = info & IDENT, gather = info & GATHER, last = info & LAST;
  const int* kin = (info & IN_B) ? bf.kB : bf.kA;
  const int* pin = (info & IN_B) ? bf.pB : bf.pA;
  int* kout = (info & OUT_B) ? bf.kB : bf.kA;
  int* pout = (info & OUT_B) ? bf.pB : bf.pA;
  const unsigned lt = (1u << lane) - 1u;
  const int base = tile * TILE + warp * (TILE / TW);
  int x[IPT], pv[IPT], d[IPT], r[IPT], first[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {  // each owned digit's first output slot, loaded early
    const int dg = tid + j * TT;
    first[j] = dg < B ? __ldcg(&w.offs[p * B + dg]) : 0;
  }
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = base + 32 * j + lane;
    x[j] = 0;
    pv[j] = i;
    if (i < n) {
      if (!ident) pv[j] = __ldcg(pin + i);
      x[j] = gather ? src[pv[j]] : __ldcg(kin + i);
    }
  }
  // one walk: each item's rank among its warp's items of its digit
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const bool ok = base + 32 * j + lane < n;
    const int dd = ok ? bin_of(pl, x[j], p) : B;
    const unsigned peers = __match_any_sync(0xffffffffu, dd);
    const int before = ok ? cnt[warp * B + dd] : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[warp * B + dd] = before + __popc(peers);
    __syncwarp();
    d[j] = dd;
    r[j] = before + __popc(peers & lt);
  }
  __syncthreads();
  // thread t owns digits t, t + TT, ...: the warps' exclusive offsets and
  // the tile's count of each, published at once (a tile never waits with
  // a count of its own unpublished)
  unsigned* st = w.status + (size_t)p * ntiles * B;
  int run[DPT], excl[DPT], at[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int dg = tid + j * TT;
    run[j] = 0;
    excl[j] = 0;
    at[j] = tile - 1;  // the tile whose word is read next; -1: done
    if (dg < B) {
      for (int ww = 0; ww < TW; ++ww) {
        const int v = cnt[ww * B + dg];
        cnt[ww * B + dg] = run[j];
        run[j] += v;
      }
      atomicExch(st + (size_t)tile * B + dg, (tile == 0 ? FLAG_INC : FLAG_AGG) | (unsigned)run[j]);
    } else {
      at[j] = -1;
    }
  }
  // decoupled look-back, the owned digits' loads in flight together
  unsigned spin = 0;
  for (bool pending = tile > 0; pending;) {
    pending = false;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      if (at[j] >= 0) {
        const unsigned s = __ldcv(st + (size_t)at[j] * B + tid + j * TT);
        const unsigned flag = s & ~COUNT_MASK;
        if (flag != 0) {
          excl[j] += (int)(s & COUNT_MASK);
          at[j] = flag == FLAG_INC ? -1 : at[j] - 1;
        }
        pending |= at[j] >= 0;
      }
    }
    if (++spin > SPIN_LIMIT) __trap();
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int dg = tid + j * TT;
    if (dg < B) {
      if (tile > 0) atomicExch(st + (size_t)tile * B + dg, FLAG_INC | (unsigned)(excl[j] + run[j]));
      const int gb = first[j] + excl[j];
      for (int ww = 0; ww < TW; ++ww) cnt[ww * B + dg] += gb;
    }
  }
  __syncthreads();
  const bool carried = k == pl.nkeys - 1;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (base + 32 * j + lane < n) {
      const int pos = cnt[warp * B + d[j]] + r[j];
      if (last) {
        bf.perm_out[pos] = pv[j];
        if (bf.key_out) bf.key_out[pos] = carried ? x[j] : primary[pv[j]];
      } else {
        kout[pos] = x[j];
        pout[pos] = pv[j];
      }
    }
  }
  __syncthreads();  // cnt is reused by the CTA's next tile
}

// The whole sort in one launch of co-resident CTAs: histograms, the pass
// plan, then each live pass over the tiles (CTA b: tiles b, b + grid, ...),
// with a grid barrier between phases (a skipped pass costs nothing).
__global__ void __launch_bounds__(TT) tiled_sort_kernel(Plan pl, int n, int ntiles, Work w,
                                                        Buffers bf) {
  extern __shared__ int sh[];  // histograms [npass][bins], then per-warp counts [TW][bins]
  int barriers = 0;
  histograms(pl, n, ntiles, w, sh);
  grid_barrier(w.ctl, ++barriers);
  if (blockIdx.x == 0) plan_passes(pl, n, w, sh, bf.seg_start);
  grid_barrier(w.ctl, ++barriers);
  if (__ldcg(&w.ctl[1]) == 0) {
    // no pass moves an item: the order is the identity
    const int* primary = pl.keys.k[pl.nkeys - 1];
    for (int i = blockIdx.x * TT + threadIdx.x; i < n; i += gridDim.x * TT) {
      bf.perm_out[i] = i;
      if (bf.key_out) bf.key_out[i] = primary[i];
    }
    return;
  }
  for (int p = 0; p < pl.npass; ++p) {
    const int info = __ldcg(&w.info[p]);
    if (!(info & LIVE)) continue;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      sort_tile(pl, p, info, tile, n, ntiles, w, bf, sh);
    }
    if (!(info & LAST)) grid_barrier(w.ctl, ++barriers);
  }
}

// Zero the workspace and run the sort as one cooperative launch.
int run_tiles(const Plan& pl, int n, int* ws, int ws_words, int* scratch, int* perm_out,
              int* key_out, int* seg_start, cudaStream_t stream) {
  const int ntiles = (n + TILE - 1) / TILE;
  const int P = pl.npass, B = pl.bins;
  Work w;
  w.ctl = ws;
  w.offs = ws + 4;
  w.info = w.offs + (size_t)P * B;
  w.status = (unsigned*)(w.info + P);
  const size_t words = 4 + (size_t)P * B + P + (size_t)P * ntiles * B;
  if ((size_t)ws_words < words) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(ws, 0, words * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)max(P, TW) * B * sizeof(int);
  static size_t smem_set = 0;
  static int sms = 0;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(tiled_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  if (sms == 0) {
    int dev;
    cudaGetDevice(&dev);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // CTAs a multiprocessor holds at each shared-memory size seen (sizes are
  // whole 1 KB steps up to 200 KB)
  static int per_sm_at_kb[201] = {0};
  const size_t kb = (smem + 1023) / 1024;
  if (kb > 200) return (int)cudaErrorInvalidValue;
  int& per_sm = per_sm_at_kb[kb];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_sort_kernel, TT, kb * 1024);
    if (e != cudaSuccess) return (int)e;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = min(ntiles, per_sm * sms);
  // (a single pass is the last live one: it needs no ping-pong scratch)
  Buffers bf = {nullptr, nullptr, nullptr, nullptr, perm_out, key_out, seg_start};
  if (scratch) {
    bf.kA = scratch;
    bf.pA = scratch + n;
    bf.kB = scratch + 2 * (size_t)n;
    bf.pB = scratch + 3 * (size_t)n;
  } else if (P > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Plan plc = pl;
  int nn = n, nt = ntiles;
  void* args[] = {&plc, &nn, &nt, &w, &bf};
  e = cudaLaunchCooperativeKernel((const void*)tiled_sort_kernel, dim3(grid), dim3(TT), args,
                                  smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
