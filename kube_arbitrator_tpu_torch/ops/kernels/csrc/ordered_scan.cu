// K20 ordered_scan: the inclusive f32 prefix sum along axis 0 of a [V, C]
// array, added in the order of XLA:CPU's cumsum.
//
// Replaces mm_cumsum (kube_arbitrator_tpu/ops/common.py:102-137), which on
// the CPU is jnp.cumsum; XLA computes that as a two-level scan of 16-wide
// blocks, and the port's plain version (ordered_scan.py's
// ordered_scan_plain) adds in exactly that order:
//   scan(v[n]): n <= 16: v[0], then one add per element, left to right;
//   otherwise, over ceil(n / 16) blocks padded with +0.0:
//     inner[b][i] = inner[b][i-1] + v[16b+i]  (inner[b][0] = v[16b])
//     outer       = scan(the blocks' totals inner[b][15])
//     out[16b+i]  = inner[b][i] + (b == 0 ? +0.0 : outer[b-1]).
// The padded zeros are added too (x + 0.0 turns -0.0 into +0.0), and so is
// block 0's zero offset.  Plain f32 adds (__fadd_rn; the build passes
// -fmad=false), so the card gives the CPU's bits.
//
// One CTA per column.  Level 0's inner sums go to the output; the block
// totals of every recursion depth live in shared memory (V = 51,200:
// 3,200 + 200 + 13 floats); one thread scans the last level (<= 16), then
// each level from the top down adds its exclusive offset, and the output
// last.
//
// Bound: bytes — V*C floats read and written once: 1.2 MB at V = 51,200,
// C = 3, 0.37 us at 3.35 TB/s.  The dependent adds (16 a block per level)
// and the level barriers are the floor of one CTA.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int BLOCK = 16;  // ordered_scan.py's SCAN_BLOCK
constexpr int MAX_LEVELS = 8;

__global__ void __launch_bounds__(THREADS) ordered_scan_kernel(const float* __restrict__ x,
                                                               int V, int C,
                                                               float* __restrict__ out) {
  extern __shared__ float lev[];
  const int c = blockIdx.x, tid = threadIdx.x;
  if (V <= BLOCK) {
    if (tid == 0) {
      float acc = x[c];
      out[c] = acc;
      for (int i = 1; i < V; ++i) {
        acc = __fadd_rn(acc, x[(size_t)i * C + c]);
        out[(size_t)i * C + c] = acc;
      }
    }
    return;
  }
  // level 0: inner sums into out, block totals into level 1
  int off[MAX_LEVELS + 1], len[MAX_LEVELS + 1];
  int nb = (V + BLOCK - 1) / BLOCK;
  for (int b = tid; b < nb; b += THREADS) {
    float acc = 0.0f;
    for (int i = 0; i < BLOCK; ++i) {
      const int r = b * BLOCK + i;
      const float v = r < V ? x[(size_t)r * C + c] : 0.0f;
      acc = i == 0 ? v : __fadd_rn(acc, v);
      if (r < V) out[(size_t)r * C + c] = acc;
    }
    lev[b] = acc;
  }
  __syncthreads();
  int depth = 1;
  off[1] = 0;
  len[1] = nb;
  // the levels above, in place, while a level is longer than a block
  while (len[depth] > BLOCK) {
    const int n = len[depth];
    float* cur = lev + off[depth];
    float* next = cur + n;
    nb = (n + BLOCK - 1) / BLOCK;
    for (int b = tid; b < nb; b += THREADS) {
      float acc = 0.0f;
      for (int i = 0; i < BLOCK; ++i) {
        const int r = b * BLOCK + i;
        const float v = r < n ? cur[r] : 0.0f;
        acc = i == 0 ? v : __fadd_rn(acc, v);
        if (r < n) cur[r] = acc;
      }
      next[b] = acc;
    }
    __syncthreads();
    off[depth + 1] = off[depth] + n;
    len[depth + 1] = nb;
    ++depth;
  }
  // the top level (<= BLOCK): the base case, serially
  if (tid == 0) {
    float* top = lev + off[depth];
    for (int i = 1; i < len[depth]; ++i) top[i] = __fadd_rn(top[i - 1], top[i]);
  }
  __syncthreads();
  // walk down: level d's inner sums plus level d+1's exclusive offsets
  for (int d = depth - 1; d >= 1; --d) {
    float* cur = lev + off[d];
    const float* up = lev + off[d + 1];
    for (int r = tid; r < len[d]; r += THREADS) {
      const int b = r / BLOCK;
      cur[r] = __fadd_rn(cur[r], b == 0 ? 0.0f : up[b - 1]);
    }
    __syncthreads();
  }
  for (int r = tid; r < V; r += THREADS) {
    const int b = r / BLOCK;
    const size_t o = (size_t)r * C + c;
    out[o] = __fadd_rn(out[o], b == 0 ? 0.0f : lev[b - 1]);
  }
}

// Shared memory the levels above level 0 need, in bytes (0 when V <= 16);
// -1 when the recursion is deeper than MAX_LEVELS.
long long smem_bytes(int V) {
  if (V <= BLOCK) return 0;
  long long total = 0;
  int n = (V + BLOCK - 1) / BLOCK, depth = 1;
  total += n;
  while (n > BLOCK) {
    n = (n + BLOCK - 1) / BLOCK;
    total += n;
    if (++depth >= MAX_LEVELS) return -1;
  }
  return total * (long long)sizeof(float);
}

}  // namespace

extern "C" int kat_ordered_scan(const float* x, int V, int C, float* out, void* stream) {
  if (V <= 0 || C <= 0) return (int)cudaGetLastError();
  const long long smem = smem_bytes(V);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ordered_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ordered_scan_kernel<<<C, THREADS, (size_t)smem, (cudaStream_t)stream>>>(x, V, C, out);
  return (int)cudaGetLastError();
}
