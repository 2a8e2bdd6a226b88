// K4 segment_sum: out[idx[i]] += val[i] in SLOT ORDER, f32 and i32,
// out-of-range indices dropped.
//
// Replaces the segment sums of kube_arbitrator_tpu/ops/cycle.py:
// open_session (:233-239, :265-266) and ops/fairness.py (:178), keeping
// the contract of the reference's host kernels kat_scatter_add_f32/_i32
// (ops/native/segsum.cc via segsum.py:108-201): sums in slot order, no
// float atomics, so the result equals the sequential scatter bit for bit.
// The wrapper orders the slots with a stable sort of the indices (glue);
// here one thread per (segment, column) adds its contiguous run in order,
// from zero or (accumulate != 0) from out's own value, in place.
//
// Bound: bytes — val read once (T*C*4), the permutation and segment
// starts read once, out written once: ~2 MB at T = 100k, C = 4, ~0.6 us
// at 3.35 TB/s.  The serial per-segment chain (up to the longest
// segment's length in dependent adds, ~4 cycles each) is the floor for
// long segments.
#include "common.cuh"

namespace {

__device__ __forceinline__ float kat_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int kat_add(int a, int b) { return a + b; }

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ val,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ seg_start, int nseg,
                                   int C, int accumulate, T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)nseg * C) return;
  const int s = (int)(i / C), c = (int)(i % C);
  T acc = accumulate ? out[i] : (T)0;
  const int end = seg_start[s + 1];
  for (int j = seg_start[s]; j < end; ++j) acc = kat_add(acc, val[(size_t)perm[j] * C + c]);
  out[i] = acc;
}

template <typename T>
int launch(const T* val, const int* perm, const int* seg_start, int nseg, int C,
           int accumulate, T* out, void* stream) {
  const size_t n = (size_t)nseg * C;
  if (n > 0) {
    segment_sum_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        val, perm, seg_start, nseg, C, accumulate, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kat_segment_sum_f32(const float* val, const int* perm,
                                   const int* seg_start, int nseg, int C,
                                   int accumulate, float* out, void* stream) {
  return launch<float>(val, perm, seg_start, nseg, C, accumulate, out, stream);
}

extern "C" int kat_segment_sum_i32(const int* val, const int* perm,
                                   const int* seg_start, int nseg, int C,
                                   int accumulate, int* out, void* stream) {
  return launch<int>(val, perm, seg_start, nseg, C, accumulate, out, stream);
}
