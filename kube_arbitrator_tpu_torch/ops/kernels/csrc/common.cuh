// Block-wide helpers shared by the kernels.  Every helper must be called
// by all threads of the block (they synchronise), with blockDim.x a
// multiple of 32.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KAT_BIG 3.0e38f  // the reference's BIG: +inf for f32 mins
#define KAT_EPS 10.0f    // the reference's device-unit epsilon
#define KAT_FLT_MIN 1.17549435e-38f  // the least normal f32

// The optimistic reclaim window's control words, i32[KAT_CTL_LEN]
// (window_gate.py's ctl layout): K15 writes them, K14 reads START and
// TRIP, K8 sets PROGRESS when its turn pops.
enum {
  KAT_CTL_START = 0, KAT_CTL_TRIP, KAT_CTL_ROUNDS, KAT_CTL_GATED, KAT_CTL_CONFLICTS,
  KAT_CTL_ROUND_DONE, KAT_CTL_WINDOWS, KAT_CTL_PROGRESS, KAT_CTL_LEN
};

// Entry r of an ordinal tensor read as i32 (wide 0) or i64 (wide 1).
__device__ __forceinline__ int kat_read_index(const void* p, int wide, int r = 0) {
  return wide ? (int)static_cast<const long long*>(p)[r] : static_cast<const int*>(p)[r];
}

// x with a subnormal flushed to a zero of its sign, as XLA computes on
// the CPU and the TPU everywhere; NaN, +-inf and normal values pass.
// The port's kernels keep subnormals elsewhere (no -ftz in build.py).
__device__ __forceinline__ float kat_ftz(float x) {
  return fabsf(x) < KAT_FLT_MIN ? copysignf(0.0f, x) : x;
}

// ops/common.py:safe_share — alloc / total with the zero-total convention
// (0, or 1 if alloc > 0), flushed as the JAX package's share is: a
// subnormal input reads as a zero of its sign, a subnormal quotient is a
// zero of its sign.  IEEE division (no fast math).
__device__ __forceinline__ float kat_safe_share(float alloc, float total) {
  const float a = kat_ftz(alloc), t = kat_ftz(total);
  return t > 0.0f ? kat_ftz(__fdiv_rn(a, fmaxf(t, 1e-30f))) : (a > 0.0f ? 1.0f : 0.0f);
}

// Exclusive prefix of v over the block in thread order; *total gets the
// block sum.  Integer adds, so the result is exact in any order.
__device__ __forceinline__ int kat_block_excl_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return base + x - v;
}

__device__ __forceinline__ float kat_block_min_f32(float v) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = fminf(w, __shfl_xor_sync(0xffffffffu, w, o));
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int kat_block_min_i32(int v) {
  __shared__ int red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? red[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = min(w, __shfl_xor_sync(0xffffffffu, w, o));
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const int r = red[0];
  __syncthreads();
  return r;
}
