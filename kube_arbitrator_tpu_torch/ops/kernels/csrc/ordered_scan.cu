// K20 ordered_scan: the inclusive f32 prefix sum along axis 0 of a [V, C]
// array, added in the order of XLA:CPU's cumsum; optionally of the rows
// masked first (where(mask, x, 0)).
//
// Replaces mm_cumsum (kube_arbitrator_tpu/ops/common.py:102-137), which on
// the CPU is jnp.cumsum; XLA computes that as a recursive scan of 16-wide
// blocks, and the port's plain version (ordered_scan.py's
// ordered_scan_plain) adds in exactly that order:
//   scan(v[n]): n <= 16: v[0], then one add per element, left to right;
//   otherwise, over ceil(n / 16) blocks padded with +0.0:
//     inner[b][i] = inner[b][i-1] + v[16b+i]  (inner[b][0] = v[16b], no add)
//     outer       = scan(the blocks' totals inner[b][15])
//     out[16b+i]  = inner[b][i] + (b == 0 ? +0.0 : outer[b-1]).
// The padded zeros are added too (x + 0.0 turns -0.0 into +0.0), and so is
// block 0's zero offset.  Plain f32 adds (__fadd_rn; the build passes
// -fmad=false, which this file needs: no add may fuse), so the card gives
// the CPU's bits.
//
// The adds form a fixed tree, so a tile of TILE = 16^3 rows (one block of
// level 2) computes its inner sums through levels 0-2 alone: rows past V
// are the padding zeros, and a block made only of them totals +0.0, which
// is the padding of the level above.  A CTA a tile (all C <= COLS columns
// of it, or one column of a wider array; the kernel is compiled for each
// width, so a staged index's row and column cost no division):
// * one coalesced pass stages the tile's [TILE, cc] rows in shared memory
//   (a column a stride, a pad word every 16 rows, so a thread's block is
//   16 consecutive words and a warp's 32 blocks hit 32 banks), masking
//   them and writing the masked rows out when the plan asks for them;
// * levels 0, 1, 2 are 16-add chains in place, a thread a block;
// * past the tiles: a tile publishes its level-2 total, its level-2 value
//   14 and its level-1 value 255 (each one 64-bit word, this launch's
//   number above the f32 bits, so the value travels with its flag), and
//   a warp a column reads its left neighbours' words (a decoupled
//   look-back over inner sums only, so no tile waits on another's
//   offsets): the top scan's exclusive offsets of this tile and the one
//   before are left-to-right chains of the totals (at most 16 tiles), or
//   at most 256 tiles: chains of 16 plus a chain of their group totals —
//   the plain version's order either way (tile 0 adds +0.0); the previous
//   tile's last level-2 and level-1 scans, which offset this tile's first
//   level-1 and level-0 blocks, follow from its words and its offset.
//   CTAs take their tiles from a ticket, so a tile waits only on tiles
//   already running;
// * the offsets go down the levels, and the output is written once,
//   coalesced, as level 0 plus its block's offset.
// V <= 4,096 is one tile whose top level (<= 16 values at level 0, 1 or
// 2) is one unpadded chain; V <= 16 is that chain alone.  V is at most
// 16^5 (1,048,576): the top level's two chains.
//
// The plan (ordered_scan.py's OrderedScanPlan) binds the output, the
// masked rows, the workspace and the shapes once; a launch passes its
// input (or mask), its number and the ticket's value at its start.
//
// Bound: bytes — V*C floats read and written once (and the mask and the
// masked rows when asked): 1.2 MB at V = 51,200, C = 3, 0.37 us at
// 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int BLOCK = 16;                      // ordered_scan.py's SCAN_BLOCK
constexpr int TILE = BLOCK * BLOCK * BLOCK;    // 4,096 rows: levels 0-2
constexpr int TILE_PAD = TILE + TILE / BLOCK;  // a pad word every 16 rows
constexpr int L1_STRIDE = BLOCK * BLOCK + BLOCK + 1;  // a column of level 1, padded
constexpr int L2_STRIDE = BLOCK + 1;
constexpr int COLS = 4;                        // columns a CTA stages, at most
constexpr int MAX_TILES = BLOCK * BLOCK;
// A spin that outlasts this many polls means a tile never published:
// trap (a launch error) rather than hang the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

// the plan's fixed arguments (ordered_scan.py's _Static mirrors this layout)
struct Static {
  float* out;                 // f32[V, C]
  float* masked;              // f32[V, C] where(mask, x, 0), or null
  unsigned long long* words;  // [tiles][3][C] a tile's total, level-2 value 14 and level-1
                              // value 255: launch number << 32 | f32 bits
  unsigned* ticket;           // CTAs started, over every launch of the plan
  int V, C, tiles, chunks, levels;
};

// a launch's own arguments (ordered_scan.py's _Call mirrors this layout)
struct Call {
  const float* x;        // f32[V, C]
  const uint8_t* mask;   // bool[V], or null
  unsigned seq;          // this launch's number, never 0
  unsigned base;         // the ticket at this launch's start
};

__device__ __forceinline__ int pad16(int r) { return r + (r >> 4); }

// stride of a staged column: padded so that a warp's staging store of
// cc interleaved columns spreads over the banks
__host__ __device__ constexpr int col_stride(int cc) {
  return TILE_PAD + (32 + cc - 1) / cc;
}

// 16 values in place: p[0] stays, p[i] = p[i-1] + p[i]; returns p[15]
__device__ __forceinline__ float block_chain(float* p) {
  float v[BLOCK];
#pragma unroll
  for (int i = 0; i < BLOCK; ++i) v[i] = p[i];
  float acc = v[0];
#pragma unroll
  for (int i = 1; i < BLOCK; ++i) {
    acc = __fadd_rn(acc, v[i]);
    p[i] = acc;
  }
  return acc;
}

// the top level's unpadded chain over p[0..n), n <= 16, in place
__device__ __forceinline__ void top_chain(float* p, int n) {
  float acc = p[0];
  for (int i = 1; i < n; ++i) {
    acc = __fadd_rn(acc, p[i]);
    p[i] = acc;
  }
}

__device__ __forceinline__ unsigned long long await_word(const unsigned long long* w,
                                                         unsigned seq) {
  unsigned long long x = __ldcv(w);
  for (unsigned spin = 0; (unsigned)(x >> 32) != seq; ++spin) {
    if (spin > SPIN_LIMIT) __trap();
    __nanosleep(32);
    x = __ldcv(w);
  }
  return x;
}

__device__ __forceinline__ float total_of(unsigned long long x) {
  return __uint_as_float((unsigned)x);
}

// the chain over tiles a, a+1, ..., b (inclusive) of column words w
// (stride C): w[a], then one add per tile
__device__ float tile_chain(const unsigned long long* w, int C, int a, int b, unsigned seq) {
  constexpr int AHEAD = 4;  // words read at once
  float acc = 0.f;
  for (int i0 = a; i0 <= b; i0 += AHEAD) {
    unsigned long long x[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (i0 + i <= b) x[i] = __ldcv(w + (size_t)(i0 + i) * C);
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (i0 + i > b) break;
      if ((unsigned)(x[i] >> 32) != seq) x[i] = await_word(w + (size_t)(i0 + i) * C, seq);
      acc = i0 + i == a ? total_of(x[i]) : __fadd_rn(acc, total_of(x[i]));
    }
  }
  return acc;
}

// outer[m] of the plain version's scan over more than 16 tile totals
// (w: the column's totals, stride apart), by one warp: m's block chain
// plus the chain of the earlier (full) blocks' totals; lane g < b totals
// block g, lane 16 chains m's
__device__ float top_scan_at(const unsigned long long* w, int stride, int m, unsigned seq,
                             int lane) {
  const int b = m / BLOCK;
  float part = 0.f;
  if (lane < b) part = tile_chain(w, stride, lane * BLOCK, lane * BLOCK + BLOCK - 1, seq);
  if (lane == BLOCK) part = tile_chain(w, stride, b * BLOCK, m, seq);
  const float inner = __shfl_sync(0xffffffffu, part, BLOCK);
  float outer = __shfl_sync(0xffffffffu, part, 0);
  for (int g = 1; g < b; ++g) outer = __fadd_rn(outer, __shfl_sync(0xffffffffu, part, g));
  return __fadd_rn(inner, b == 0 ? 0.f : outer);
}

// The top scan's exclusive offsets of tile `tile` (> 0) and of tile
// `tile - 1` (+0.0 for tile 0) in one column, by one warp: outer[tile - 1]
// and outer[tile - 2] of the plain version's scan over the `tiles` totals.
__device__ float2 tile_offsets(const unsigned long long* w, int stride, int tile, int tiles,
                               unsigned seq, int lane) {
  const int m = tile - 1;
  if (tiles <= BLOCK) {  // one chain: lanes read, lane order adds
    const float a = lane <= m ? total_of(await_word(w + (size_t)lane * stride, seq)) : 0.f;
    float acc = __shfl_sync(0xffffffffu, a, 0), prev = 0.f;
    for (int i = 1; i <= m; ++i) {
      prev = acc;
      acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, a, i));
    }
    return make_float2(acc, prev);
  }
  const float prev = m == 0 ? 0.f : top_scan_at(w, stride, m - 1, seq, lane);
  return make_float2(top_scan_at(w, stride, m, seq, lane), prev);
}

// CC: the columns a CTA stages (compile time, so that a staged index's
// row and column cost no division): C when C <= COLS, else 1
template <int CC>
__global__ void __launch_bounds__(THREADS) ordered_scan_kernel(Static s, Call c) {
  constexpr int cc = CC, CS = col_stride(CC), PER_THREAD = TILE * CC / THREADS;
  extern __shared__ float sm[];
  __shared__ int ids[2];
  __shared__ float carry[2 * CC];  // the previous tile's last level-2 and level-1 scans
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = s.C;
  if (tid == 0) {
    // a tile's CTA starts only after every tile on its left has started
    const int t = s.tiles > 1 ? (int)(atomicAdd(s.ticket, 1u) - c.base) : (int)blockIdx.x;
    ids[0] = t / s.chunks;
    ids[1] = t - ids[0] * s.chunks;
  }
  __syncthreads();
  const int tile = ids[0], c0 = ids[1] * CC;
  float* sv = sm;                     // [cc][CS] the rows, then level 0 in place
  float* l1 = sv + cc * CS;           // [cc][L1_STRIDE] level 1
  float* l2 = l1 + cc * L1_STRIDE;    // [cc][L2_STRIDE] level 2
  const int r0 = tile * TILE;
  const int nrows = min(TILE, s.V - r0);
  const float* __restrict__ x = c.x;
  const uint8_t* __restrict__ mask = c.mask;
  float* __restrict__ out = s.out;
  float* __restrict__ masked = s.masked;

  // ---- stage the tile (zeros past V), masked: every load of a thread
  // issued before the first store
  float v[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int k = tid + u * THREADS, row = k / cc, col = k - row * cc;
    v[u] = 0.f;
    if (k < TILE * cc && row < nrows) {
      v[u] = x[(size_t)(r0 + row) * C + c0 + col];
      if (mask != nullptr && mask[r0 + row] == 0) v[u] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int k = tid + u * THREADS, row = k / cc, col = k - row * cc;
    if (k >= TILE * cc) break;
    sv[col * CS + pad16(row)] = v[u];
    if (masked != nullptr && row < nrows) masked[(size_t)(r0 + row) * C + c0 + col] = v[u];
  }
  __syncthreads();

  if (s.levels == 0) {  // V <= 16: one chain a column
    if (tid < cc) {
      float acc = 0.f;
      for (int r = 0; r < nrows; ++r) {
        const float v = sv[tid * CS + r];
        acc = r == 0 ? v : __fadd_rn(acc, v);
        out[(size_t)r * C + c0 + tid] = acc;
      }
    }
    return;
  }
  // ---- level 0: 256 blocks a column
  for (int i = tid; i < cc * BLOCK * BLOCK; i += THREADS) {
    const int col = i >> 8, b = i & 255;
    l1[col * L1_STRIDE + pad16(b)] = block_chain(sv + col * CS + (BLOCK + 1) * b);
  }
  __syncthreads();
  const int n1 = (s.V + BLOCK - 1) / BLOCK;  // level-1 values (single tile)
  if (s.levels == 1) {
    // the top: one chain over the n1 <= 16 level-1 values
    if (tid < cc) top_chain(l1 + tid * L1_STRIDE, n1);
    __syncthreads();
  } else {
    // ---- level 1: 16 blocks a column
    if (tid < cc * BLOCK) {
      const int col = tid >> 4, b = tid & 15;
      l2[col * L2_STRIDE + b] = block_chain(l1 + col * L1_STRIDE + (BLOCK + 1) * b);
    }
    __syncthreads();
    if (s.levels == 2) {
      // the top: one chain over the n2 <= 16 level-2 values
      if (tid < cc) top_chain(l2 + tid * L2_STRIDE, (n1 + BLOCK - 1) / BLOCK);
    } else {
      // ---- level 2: the tile's one block.  The tiles on its right read
      // its total, and the next tile its level-2 value 14 and level-1
      // value 255 (the inner sums under its own first blocks' offsets)
      if (tid < cc) {
        const float total = block_chain(l2 + tid * L2_STRIDE);
        if (tile + 1 < s.tiles) {
          const float v[3] = {total, l2[tid * L2_STRIDE + BLOCK - 2],
                              l1[tid * L1_STRIDE + pad16(BLOCK * BLOCK - 1)]};
          const unsigned long long seq = (unsigned long long)c.seq << 32;
          for (int kind = 0; kind < 3; ++kind)
            atomicExch(s.words + ((size_t)tile * 3 + kind) * C + c0 + tid,
                       seq | (unsigned long long)__float_as_uint(v[kind]));
        }
      }
      __syncthreads();
      // the top scan's offsets (tile 0: +0.0, added all the same), and
      // the previous tile's last level-2 and level-1 scans, which offset
      // this tile's first level-1 and level-0 blocks
      if (warp < cc) {
        float off = 0.f;
        if (tile > 0) {
          const unsigned long long* w = s.words + c0 + warp;
          // lanes 29-31 read the previous tile's three words while the
          // others read the totals
          const unsigned long long* pw = w + ((size_t)(tile - 1) * 3 + max(lane - 29, 0)) * C;
          unsigned long long prev = lane >= 29 ? __ldcv(pw) : 0ull;
          const float2 e = tile_offsets(w, 3 * C, tile, s.tiles, c.seq, lane);
          if (lane >= 29 && (unsigned)(prev >> 32) != c.seq) prev = await_word(pw, c.seq);
          const float t15 = __shfl_sync(0xffffffffu, total_of(prev), 29);
          const float i14 = __shfl_sync(0xffffffffu, total_of(prev), 30);
          const float i255 = __shfl_sync(0xffffffffu, total_of(prev), 31);
          off = e.x;
          if (lane == 0) {
            // level 2's scan at 16 tile - 1, level 1's at 256 tile - 1
            carry[2 * warp] = __fadd_rn(t15, e.y);
            carry[2 * warp + 1] = __fadd_rn(i255, __fadd_rn(i14, e.y));
          }
        }
        if (lane < BLOCK) l2[warp * L2_STRIDE + lane] = __fadd_rn(l2[warp * L2_STRIDE + lane], off);
      }
    }
    __syncthreads();
    // ---- level 1 plus level 2's exclusive offsets
    for (int i = tid; i < cc * BLOCK * BLOCK; i += THREADS) {
      const int col = i >> 8, m = i & 255, b = m >> 4;
      float* p = l1 + col * L1_STRIDE + pad16(m);
      *p = __fadd_rn(*p, b > 0 ? l2[col * L2_STRIDE + b - 1] : tile > 0 ? carry[2 * col] : 0.f);
    }
    __syncthreads();
  }
  // ---- the output: level 0 plus level 1's exclusive offsets, coalesced
  for (int k = tid; k < nrows * cc; k += THREADS) {
    const int row = k / cc, col = k - row * cc, b = row >> 4;
    const float off =
        b > 0 ? l1[col * L1_STRIDE + pad16(b - 1)] : tile > 0 ? carry[2 * col + 1] : 0.f;
    out[(size_t)(r0 + row) * C + c0 + col] = __fadd_rn(sv[col * CS + pad16(row)], off);
  }
}

// shared memory of one CTA staging cc columns, in bytes
size_t smem_bytes(int cc) {
  return (size_t)cc * (col_stride(cc) + L1_STRIDE + L2_STRIDE) * sizeof(float);
}

template <int CC>
cudaError_t launch(const Static& s, const Call& c, cudaStream_t stream) {
  static bool raised = false;  // the shared-memory attribute, set once a process
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(ordered_scan_kernel<CC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(CC));
    if (e != cudaSuccess) return e;
    raised = true;
  }
  ordered_scan_kernel<CC><<<s.tiles * s.chunks, THREADS, smem_bytes(CC), stream>>>(s, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kat_ordered_scan(const void* static_args, const void* call_args, void* stream) {
  const Static& s = *static_cast<const Static*>(static_args);
  const Call& c = *static_cast<const Call*>(call_args);
  if (s.V <= 0 || s.C <= 0) return (int)cudaSuccess;
  const int cc = s.C <= COLS ? s.C : 1;
  if (s.tiles < 1 || s.tiles > MAX_TILES || s.levels < 0 || s.levels > 3 ||
      (s.tiles > 1) != (s.levels == 3) || s.chunks != s.C / cc || c.seq == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cc) {
    case 1: return (int)launch<1>(s, c, st);
    case 2: return (int)launch<2>(s, c, st);
    case 3: return (int)launch<3>(s, c, st);
    default: return (int)launch<4>(s, c, st);
  }
}
