// K5 seg_scan: masked segment-local inclusive scan of [mask | mask*vals]
// in a sorted order, written back to the unsorted positions.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:SortLayout.rank_and_cum
// (:129-168) and ops/common.py:seg_cumsum (:74-99).  Sorted position s
// reads mask[order[s]] and vals[s*C..]; the running count and sums reset
// where seg_start[s] is set (and at s = 0).  Outputs at order[s]: the
// exclusive masked count (i32) and the inclusive masked sums (f32).
//
// One order of float adds, the reference native kat_seg_cumsum_f32's
// (ops/native/segsum.cc): serial within a segment, in sorted order, from
// +0.0, over the masked positions only (the others add +0.0, which
// changes no bits).  At any f32 input, not only at integers.
//
// A plan (seg_scan.py's SegScanPlan) is bound once per layout: a first
// launch in BIND mode derives the segment table from seg_start (each
// position's segment, each segment's first position, each position's
// segment base); a SCAN launch then passes only the mask.  One
// cooperative launch, three grid barriers:
//   1. tiles of TILE positions over the whole P axis: the gather
//      mask[order[s]] and each tile's masked count;
//   2. per tile, the exclusive masked count of every position (the
//      tile's offset is the sum of the earlier tiles' counts) and the
//      compacted list of the masked positions, in sorted order;
//   3. per group of segments (the segments whose first position lies in
//      one span of GS positions; GS * C <= TT): the group's masked rows,
//      one contiguous run of the compacted list, are staged into shared
//      memory a chunk at a time (cp.async, double-buffered, the next
//      chunk in flight while this one adds), and per (segment, column)
//      one thread runs the dependent add chain over its masked rows,
//      writing each inclusive sum in place, its loads 16 ahead of its
//      adds; the chunk then goes to the compacted sums;
//   4. every position: rank = its exclusive count minus its segment
//      base's, sum = the compacted sum of its segment's last masked row at
//      or before it (+0.0 before the first), both written at order[s].
// Padding and unmasked runs cost no serial step: the chains walk masked
// rows only, and every other phase is spread over the grid.  The earlier
// design gave each segment one warp that walked all of its positions 32
// a tile, one dependent tile after another, so the victim panel's padding
// tail (one segment of ~26,800 positions at P = 51,200) set the time.
//
// Bound: bytes — mask, order, seg_start and vals read once, rank and cum
// written once: ~2.6 MB at P = 51,200, C = 4 (~0.8 us at 3.35 TB/s).  The
// floor is the chain of the segment with the most masked rows (a queue's
// victims in the by_queue layout) at a few cycles a dependent add, plus
// the launch and its three barriers.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TT = 256;           // threads of a CTA
constexpr int IPT = 4;            // positions a thread a tile
constexpr int TILE = TT * IPT;    // seg_scan.py's TILE
constexpr int MAX_TILES_PER_CTA = 32 / IPT;  // the mask bits a thread keeps
constexpr int STAGE = 4096;       // staged floats (rows * C) a chunk
constexpr int MAXC = 8;           // seg_scan.py's MAX_COLS
constexpr int RPT = STAGE / TT;   // staged rows a thread a chunk, at most (C = 1)
constexpr unsigned SPIN_LIMIT = 1u << 24;

enum { MODE_SCAN = 0, MODE_BIND = 1 };

// seg_scan.py's _Static: the plan's fixed arguments
struct Static {
  const int* order;        // i32[P] or null (identity)
  const float* vals;       // f32[P, C], sorted positions
  int* seg_of;             // i32[P]: position -> its segment (BIND writes)
  int* seg_first;          // i32[P + 1]: segment -> its first position, P after the last
  int* base_pos;           // i32[P]: position -> its segment's first position
  int* excl;               // i32[P + 1]: exclusive masked count, the total last
  int* pos_m;              // i32[P]: the masked positions, in sorted order
  float* comp;             // f32[P, C]: their inclusive sums
  int* tile_tot;           // i32[ntiles]
  int* ctl;                // [0] barrier arrivals (zero between launches)
  int* rank_out;           // i32[P]
  float* cum_out;          // f32[P, C]
  int P, C, ntiles, grid;
};

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

// x + col[a * C] + ... + col[(b - 1) * C], one add after another, each
// partial written back in place of its value.  Two register sets of
// CHAIN_AHEAD alternate, so the next CHAIN_AHEAD loads are in flight while
// these add (a shared-memory load takes longer than eight dependent adds).
constexpr int CHAIN_AHEAD = 16;
__device__ __forceinline__ float chain_incl(float x, float* col, int C, int a, int b) {
  constexpr int W = CHAIN_AHEAD;
  int j = a;
  if (b - j >= 2 * W) {
    float A[W], B[W];
#pragma unroll
    for (int k = 0; k < W; ++k) A[k] = col[(j + k) * C];
    for (; j + 2 * W <= b; j += W) {
#pragma unroll
      for (int k = 0; k < W; ++k) B[k] = col[(j + W + k) * C];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        x = __fadd_rn(x, A[k]);
        col[(j + k) * C] = x;
      }
#pragma unroll
      for (int k = 0; k < W; ++k) A[k] = B[k];
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      x = __fadd_rn(x, A[k]);
      col[(j + k) * C] = x;
    }
    j += W;
  }
  for (; j < b; ++j) {
    x = __fadd_rn(x, col[j * C]);
    col[j * C] = x;
  }
  return x;
}

// Phase 3 for the segments whose first position lies in [p0, p1).
__device__ void scan_group(const Static& s, int p0, int p1, float (*stage)[STAGE], int* bnd) {
  const int tid = threadIdx.x, C = s.C;
  // the segments first..first + ns - 1 start in [p0, p1): ns <= p1 - p0 <= TT / C
  const int at = s.seg_of[p0];
  const int first = at + (p0 > 0 && s.seg_of[p0 - 1] == at);
  const int ns = s.seg_of[p1 - 1] + 1 - first;
  for (int k = tid; k <= ns && ns > 0; k += TT) bnd[k] = __ldcg(s.excl + s.seg_first[first + k]);
  __syncthreads();
  const int lo = ns > 0 ? bnd[0] : 0, hi = ns > 0 ? bnd[ns] : 0;
  const int CH = STAGE / C;
  const int nch = (hi - lo + CH - 1) / CH;
  const int j = tid / C, c = tid - j * C;  // this thread's chain (segment j, column c)
  float x = 0.0f;
  int src[RPT];  // the next chunk's masked positions (-1: none)
  auto rows_of = [&](int ci) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int k = tid + q * TT, r = lo + ci * CH + k;
      src[q] = k < CH && r < hi ? __ldcg(s.pos_m + r) : -1;
    }
  };
  auto issue = [&](int ci) {
    float* dst = stage[ci & 1];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (src[q] >= 0) {
        const float* from = s.vals + (size_t)src[q] * C;
        float* to = dst + (size_t)(tid + q * TT) * C;
        for (int cc = 0; cc < C; ++cc) cp_async4(to + cc, from + cc);
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int clo = lo + i * CH, chi = min(hi, clo + CH);
    float* cur = stage[i & 1];
    if (j < ns) {
      const int a = max(bnd[j], clo), b = min(bnd[j + 1], chi);
      if (a < b) x = chain_incl(x, cur + c, C, a - clo, b - clo);
    }
    __syncthreads();
    for (int e = tid; e < (chi - clo) * C; e += TT) s.comp[(size_t)clo * C + e] = cur[e];
    __syncthreads();  // stage i % 2 is free for chunk i + 2
  }
}

__global__ void __launch_bounds__(TT) seg_scan_kernel(const Static s,
                                                      const uint8_t* __restrict__ mask,
                                                      int mode) {
  __shared__ __align__(16) float stage[2][STAGE];
  __shared__ int bnd[TT + 1];
  const int tid = threadIdx.x, P = s.P;
  const int* order = mode == MODE_BIND ? nullptr : s.order;

  // ---- 1. each tile's masked count (BIND: its segment starts)
  unsigned mb = 0;  // this thread's mask bits, IPT a tile of this CTA
  int it = 0;
  for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x, ++it) {
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int p = tile * TILE + tid * IPT + q;
      if (p < P) {
        const bool m = mode == MODE_BIND ? (p == 0 || mask[p]) : mask[order ? order[p] : p] != 0;
        mb |= (unsigned)m << (it * IPT + q);
        cnt += m;
      }
    }
    int total;
    kat_block_excl_scan(cnt, &total);
    if (tid == 0) s.tile_tot[tile] = total;
  }
  grid_barrier(s.ctl, 1);

  // ---- 2. exclusive counts and the compacted positions
  it = 0;
  for (int tile = blockIdx.x; tile < s.ntiles; tile += gridDim.x, ++it) {
    int before = 0;
    for (int u = tid; u < tile; u += TT) before += __ldcg(s.tile_tot + u);
    int off;
    kat_block_excl_scan(before, &off);
    const unsigned bits = (mb >> (it * IPT)) & ((1u << IPT) - 1u);
    int total;
    int e = off + kat_block_excl_scan(__popc(bits), &total);
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
      const int p = tile * TILE + tid * IPT + q;
      if (p < P) {
        const int m = (bits >> q) & 1;
        if (mode == MODE_BIND) {
          s.seg_of[p] = e + m - 1;
          if (m) s.seg_first[e] = p;
        } else {
          s.excl[p] = e;
          if (m) s.pos_m[e] = p;
        }
        e += m;
      }
    }
    if (tile == s.ntiles - 1 && tid == 0) {
      if (mode == MODE_BIND) {
        s.seg_first[off + total] = P;
      } else {
        s.excl[P] = off + total;
      }
    }
  }
  grid_barrier(s.ctl, 2);

  if (mode == MODE_BIND) {
    // the last CTA past the barrier resets the word for the next launch
    if (tid == 0 && atomicAdd(s.ctl, 1) == 3 * (int)gridDim.x - 1) atomicExch(s.ctl, 0);
    for (int p = blockIdx.x * TT + tid; p < P; p += gridDim.x * TT) {
      s.base_pos[p] = __ldcg(s.seg_first + __ldcg(s.seg_of + p));
    }
    return;
  }

  // ---- 3. the chains, a group of segments a CTA at a time
  const int GS = TT / s.C;
  const int ngroups = (P + GS - 1) / GS;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    scan_group(s, g * GS, min(P, (g + 1) * GS), stage, bnd);
    __syncthreads();  // bnd is reused by the next group
  }
  grid_barrier(s.ctl, 3);
  if (tid == 0 && atomicAdd(s.ctl, 1) == 4 * (int)gridDim.x - 1) atomicExch(s.ctl, 0);

  // ---- 4. every position's rank and sums, at order[p]
  for (int p = blockIdx.x * TT + tid; p < P; p += gridDim.x * TT) {
    const int e = __ldcg(s.excl + p), incl = __ldcg(s.excl + p + 1);
    const int base = __ldcg(s.excl + s.base_pos[p]);
    const int dst = s.order ? s.order[p] : p;
    s.rank_out[dst] = e - base;
    float* out = s.cum_out + (size_t)dst * s.C;
    const float* from = s.comp + (size_t)(incl - 1) * s.C;
    for (int c = 0; c < s.C; ++c) out[c] = incl > base ? __ldcg(from + c) : 0.0f;
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

}  // namespace

// The grid of a plan's launches (0 on error): a CTA a tile and up to two
// a multiprocessor for the groups, within what the card holds at once.
extern "C" int kat_seg_scan_grid(int P, int C) {
  static int per_sm = 0;
  if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, seg_scan_kernel, TT, 0) != cudaSuccess) {
    return 0;
  }
  const int sms = sm_count();
  if (per_sm < 1 || sms == 0 || C < 1 || C > MAXC) return 0;
  const int ntiles = (P + TILE - 1) / TILE;
  const int ngroups = (P + TT / C - 1) / (TT / C);
  const int grid = std::min(std::max(ntiles, std::min(ngroups, 2 * sms)), per_sm * sms);
  return ntiles > grid * MAX_TILES_PER_CTA ? 0 : grid;
}

extern "C" int kat_seg_scan(const void* static_args, const uint8_t* mask, int mode,
                            void* stream) {
  const Static* s = static_cast<const Static*>(static_args);
  if (s->P <= 0) return (int)cudaGetLastError();
  if (s->C < 1 || s->C > MAXC || s->grid < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {const_cast<Static*>(s), (void*)&mask, &mode};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)seg_scan_kernel, dim3(s->grid),
                                                    dim3(TT), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
