// K13 round_products: the [Vp]-wide products the opt-in reclaim engines
// read at a round (the batched engine) or a speculation window (the
// optimistic engine) from the current carried state.
//
// Replaces kube_arbitrator_tpu/ops/preempt.py:_round_products
// (:2582-2606): the union victim eligibility (_canon_elig, the same
// definition K7 and K8 use, csrc/canon.cuh), the per-node [count |
// resreq] sums of the eligible slots (_canon_per_node) and the
// (node, queue) segmented inclusive scan of the same [count | resreq]
// rows over rv_nq_start (seg_cumsum).
//
// One launch, two kinds of work:
// * node blocks: one warp per canon node block rv_block_start[n]..[n+1],
//   in tiles of 32 slots.  Lane i evaluates slot i's eligibility into a
//   register (no global write and re-read between the passes) and writes
//   the elig byte; the warp stages the tile's [count | resreq] rows in
//   shared memory, the resreq loaded coalesced (the tile's R * 32 floats
//   are contiguous in cres); then lane c < R + 1 runs column c's chain
//   from shared memory in slot order — the node's total from zero (the
//   reference's scatter order, no float atomics) and the running segment
//   sum, reset at each (node, queue) segment start (K5's order); and the
//   warp stores the tile's scan rows coalesced.  A block longer than 32
//   slots carries both sums from tile to tile.  Segments never cross a
//   node block, so a warp needs nothing from another.
// * the padding past the last block, bstart[N]..Vp (a segment of its own
//   with no eligible slot: the plain version's scan rows are zeros there):
//   grid-stride over every thread of the launch, elig from the same
//   definition and zero scan rows, coalesced.  The first design gave the
//   padding (~1-2k slots) to one warp that walked it serially with two
//   dependent global accesses a slot: 76 us of device time against a
//   0.61 us bound on one H100 (PERF.md).
//
// dirty: an optional device flag.  When given and clear, the launch
// returns at once and the products keep their values — the batched
// engine refreshes them at the first turn after each claim without a
// host read per turn.  The plan (round_products.py's RoundProductsPlan)
// binds the fixed pointers once per engine call; a launch passes only
// dirty.
//
// Bound: bytes — the canon arrays the eligibility reads (cand, ranks, F
// cumulatives and deserved, job and queue ordinals), R resreq columns
// and the segment flags, read once; elig, the [N, R+1] sums and the
// [Vp, R+1] scan written once: ~1.9 MB at Vp = 25,600, N = 5,120, R = 4
// (~0.6 us at 3.35 TB/s).  A block's chain (its length in dependent adds
// from shared memory) and the launch are the floor at these sizes.
#include "canon.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// the plan's fixed arguments (round_products.py's _Static mirrors this layout)
struct Static {
  const uint8_t* cand;
  const float* rank_nj;
  const float* cum_nq;
  const int* cj;
  const int* cq;
  const float* deserved_c;
  const int* job_ready_cnt;
  const int* min_avail;
  const float* queue_alloc;
  const int* bstart;
  const uint8_t* nq_start;
  const float* cres;
  uint8_t* elig;
  float* pn;
  float* segcum;
  int R, F, use_gang, use_prop, N, Vp;
};

__global__ void __launch_bounds__(THREADS) round_products_kernel(Static s,
                                                                 const uint8_t* __restrict__ dirty) {
  if (dirty != nullptr && *dirty == 0) return;
  extern __shared__ float stage[];  // per warp: [32][C] rows, then 32 restart flags
  const CanonElig e{s.cand, s.rank_nj, s.cum_nq, s.cj, s.cq, s.deserved_c, s.job_ready_cnt,
                    s.min_avail, s.queue_alloc, s.R, s.F, s.use_gang != 0, s.use_prop != 0};
  const int R = s.R, C = R + 1;
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;

  // ---- the padding: every thread, grid-stride, coalesced
  const int V = s.bstart[s.N];
  const int stride = gridDim.x * THREADS;
  for (int slot = V + tid; slot < s.Vp; slot += stride) s.elig[slot] = kat_canon_elig(e, slot) ? 1 : 0;
  for (size_t f = (size_t)V * C + tid; f < (size_t)s.Vp * C; f += stride) s.segcum[f] = 0.f;

  // ---- node blocks: warp n takes block n
  const int n = tid >> 5;
  if (n >= s.N) return;
  float* rows = stage + (size_t)wib * (32 * C + 32);
  float* restart = rows + 32 * C;  // 1.0 where a segment starts
  const int b0 = s.bstart[n], b1 = s.bstart[n + 1];
  float tot = 0.f, acc = 0.f;
  for (int t0 = b0; t0 < b1; t0 += 32) {
    const int m = min(32, b1 - t0);
    const int slot = t0 + lane;
    const bool el = lane < m && kat_canon_elig(e, slot);
    if (lane < m) {
      s.elig[slot] = el ? 1 : 0;
      rows[lane * C] = el ? 1.f : 0.f;
      restart[lane] = (slot == b0 || s.nq_start[slot]) ? 1.f : 0.f;
    }
    const unsigned elig_bits = __ballot_sync(0xffffffffu, el);
    // the tile's resreq: m * R contiguous floats, lanes on neighbouring floats
    const float* src = s.cres + (size_t)t0 * R;
    for (int k = lane; k < m * R; k += 32) {
      const int i = k / R, c = k - i * R;
      rows[i * C + 1 + c] = (elig_bits >> i) & 1u ? src[k] : 0.f;
    }
    __syncwarp();
    if (lane < C) {
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const float v = rows[i * C + lane];
        if (restart[i] != 0.f) acc = 0.f;
        acc = __fadd_rn(acc, v);
        tot = __fadd_rn(tot, v);
        rows[i * C + lane] = acc;
      }
    }
    __syncwarp();
    float* dst = s.segcum + (size_t)t0 * C;
    for (int k = lane; k < m * C; k += 32) dst[k] = rows[k];
    __syncwarp();
  }
  if (lane < C) s.pn[(size_t)n * C + lane] = tot;
}

}  // namespace

extern "C" int kat_round_products(const void* static_args, const uint8_t* dirty, void* stream) {
  const Static s = *static_cast<const Static*>(static_args);
  if (s.R + 1 > 32) return (int)cudaErrorInvalidValue;
  const int C = s.R + 1;
  const size_t smem = (size_t)WARPS * (32 * C + 32) * sizeof(float);
  // enough CTAs for one warp per node block; the padding rides on them
  const int blocks = max((s.N + WARPS - 1) / WARPS, 1);
  round_products_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(s, dirty);
  return (int)cudaGetLastError();
}
