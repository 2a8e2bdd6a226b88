// K2 lex_argmin: masked lexicographic argmin over shared f32 key columns,
// one row per selected queue turn.
//
// Replaces kube_arbitrator_tpu/ops/common.py:lex_argmin (:49-66) as
// vmapped by ops/allocate.py:select_turns/_select_turn (:505-550): the
// job pick over the queue's jobs and the group pick within the job.
// Semantics are the reference's filter, key by key:
//   kmin = min_m where(cand, key, BIG);  cand &= where(cand, key, BIG) <= kmin
// then the first surviving index (0 when the mask is empty) and any(mask).
//
// Bound: bytes — K*M key floats (shared by every row) plus S*M mask bytes
// read once, S*(4+1) bytes written; at K = 6, M = 1k, S = 8 that is ~30 KB,
// ~10 ns at 3.35 TB/s, so the launch (~5 us) is the floor.  One block per
// row; the candidate set lives in a per-row byte scratch in device memory
// (L2-resident at these sizes) so any M is taken.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024) lex_argmin_kernel(
    const float* __restrict__ keys, int K, int M,
    const uint8_t* __restrict__ mask, uint8_t* __restrict__ cand,
    int* __restrict__ idx_out, uint8_t* __restrict__ any_out) {
  const size_t row = blockIdx.x;
  const uint8_t* mrow = mask + row * M;
  uint8_t* crow = cand + row * M;
  int any_local = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const uint8_t c = mrow[m] != 0;
    crow[m] = c;
    any_local |= c;
  }
  for (int k = 0; k < K; ++k) {
    const float* kr = keys + (size_t)k * M;
    float lmin = INFINITY;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      lmin = fminf(lmin, crow[m] ? kr[m] : KAT_BIG);
    }
    const float kmin = kat_block_min_f32(lmin);
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      if (crow[m]) crow[m] = kr[m] <= kmin;
    }
  }
  int first = M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (crow[m]) {
      first = m;
      break;
    }
  }
  first = kat_block_min_i32(first);
  const int any = -kat_block_min_i32(-any_local);
  if (threadIdx.x == 0) {
    idx_out[row] = first < M ? first : 0;
    any_out[row] = any ? 1 : 0;
  }
}

}  // namespace

extern "C" int kat_lex_argmin(const float* keys, int K, int M,
                              const uint8_t* mask, int S, uint8_t* cand,
                              int* idx_out, uint8_t* any_out, void* stream) {
  if (S > 0) {
    lex_argmin_kernel<<<S, 256, 0, (cudaStream_t)stream>>>(keys, K, M, mask, cand,
                                                           idx_out, any_out);
  }
  return (int)cudaGetLastError();
}
