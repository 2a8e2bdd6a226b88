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
// Two passes over tiles of TILE elements per row: the first counts each
// tile's set elements; the second sums the counts of the tiles before
// its own, scans its elements' flags across the block (integer adds,
// exact in any order) and writes each set element's index at its rank
// when the rank is below cap; it also writes the pad at the positions of
// its tile's range in [count, cap), and block 0 the row's count.  No
// host read anywhere.
//
// Bound: bytes — the mask (or the predicate inputs) read once, cap
// indices and the count written once: ~0.5 MB at T = 102,400 with cap
// 51,200 (~0.15 us at 3.35 TB/s).  The launches are the floor.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;  // stable_compact.py's TILE

struct Cells {
  const uint8_t* class_fit;   // bool[K, CN]
  int CN;
  const int* node_klass;      // i32[L]
  const uint8_t* node_valid;  // bool[L]
  const uint8_t* node_unsched;
  const float* minreq;        // f32[K, R] or null: predicates only
  const float* basis;         // f32[L, R]
  int R;
  bool preds_on;
};

__device__ __forceinline__ bool cell(const uint8_t* mask, const Cells& c, int k, int L, int i) {
  if (mask != nullptr) return mask[(size_t)k * L + i] != 0;
  bool ok = c.node_valid[i] != 0;
  if (c.preds_on) {
    ok = ok && c.class_fit[(size_t)k * c.CN + c.node_klass[i]] != 0 && c.node_unsched[i] == 0;
  }
  if (ok && c.minreq != nullptr) {
    for (int r = 0; r < c.R; ++r) {
      const float m = c.minreq[(size_t)k * c.R + r];
      if (m > 0.f && m < 1.5e38f && c.basis[(size_t)i * c.R + r] < __fsub_rn(m, KAT_EPS)) {
        ok = false;
      }
    }
  }
  return ok;
}

__global__ void count_tiles(const uint8_t* __restrict__ mask, Cells c, int L, int ntiles,
                            int* __restrict__ tile_counts) {
  const int k = blockIdx.y, t = blockIdx.x;
  const int base = t * TILE + threadIdx.x * PER_THREAD;
  int n = 0;
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = base + e;
    if (i < L && cell(mask, c, k, L, i)) ++n;
  }
  int total;
  kat_block_excl_scan(n, &total);
  if (threadIdx.x == 0) tile_counts[(size_t)k * ntiles + t] = total;
}

__global__ void write_tiles(const uint8_t* __restrict__ mask, Cells c, int L, int ntiles,
                            const int* __restrict__ tile_counts, int cap, int pad,
                            int* __restrict__ idx, int* __restrict__ count) {
  const int k = blockIdx.y, t = blockIdx.x;
  const int* tc = tile_counts + (size_t)k * ntiles;
  int before = 0, all = 0;
  for (int u = threadIdx.x; u < ntiles; u += THREADS) {
    all += tc[u];
    if (u < t) before += tc[u];
  }
  int row_total, tile_base;
  kat_block_excl_scan(all, &row_total);
  kat_block_excl_scan(before, &tile_base);
  const int base = t * TILE + threadIdx.x * PER_THREAD;
  bool flag[PER_THREAD];
  int n = 0;
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = base + e;
    flag[e] = i < L && cell(mask, c, k, L, i);
    n += flag[e] ? 1 : 0;
  }
  int tile_n;
  int pos = tile_base + kat_block_excl_scan(n, &tile_n);
  int* out = idx + (size_t)k * cap;
  for (int e = 0; e < PER_THREAD; ++e) {
    if (!flag[e]) continue;
    if (pos < cap) out[pos] = base + e;
    ++pos;
  }
  // pads: this tile's share of the positions [row_total, cap)
  const int hi = min(cap, (t + 1) * TILE);
  for (int p = max(row_total, t * TILE) + threadIdx.x; p < hi; p += THREADS) out[p] = pad;
  if (t == 0 && threadIdx.x == 0) count[k] = row_total;
}

}  // namespace

extern "C" int kat_stable_compact(
    const uint8_t* mask, const uint8_t* class_fit, int CN, const int* node_klass,
    const uint8_t* node_valid, const uint8_t* node_unsched, const float* minreq,
    const float* basis, int R, int preds_on, int K, int L, int cap, int pad,
    int* tile_counts, int* idx, int* count, void* stream) {
  // tile_counts: i32[K, max(1, ceil(max(L, cap) / TILE))] scratch
  if (K <= 0 || K > 65535 || L < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  Cells c{class_fit, CN, node_klass, node_valid, node_unsched, minreq, basis, R, preds_on != 0};
  const int span = L > cap ? L : cap;
  const int ntiles = span > 0 ? (span + TILE - 1) / TILE : 1;
  const dim3 grid(ntiles, K);
  cudaStream_t s = (cudaStream_t)stream;
  count_tiles<<<grid, THREADS, 0, s>>>(mask, c, L, ntiles, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_tiles<<<grid, THREADS, 0, s>>>(mask, c, L, ntiles, tile_counts, cap, pad, idx, count);
  return (int)cudaGetLastError();
}
