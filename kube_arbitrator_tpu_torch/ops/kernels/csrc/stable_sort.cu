// K19 stable_sort: the stable lexicographic sort of one to six int32 keys,
// and the two searches over a sorted key that the sort's callers need.
//
// Replaces the sort chains of the victim layouts and the claim-log join:
// kube_arbitrator_tpu/ops/preempt.py SortLayout.build (:106, jnp.lexsort
// :118) and _replay_claim_log (:1544-1563, jnp.argsort + jnp.searchsorted),
// and the port's own segment order for K4 (a stable sort of the segment
// ids plus the searchsorted of 0..S; the reference adds with .at[].add,
// ops/cycle.py:233-239).
//
// kat_stable_sort: perm of jnp.lexsort(keys) — the LAST key primary, ties
// by index.  LSD radix sort in one CTA of 1024 threads: 8-bit digits of
// the least significant key first, each pass stable, so the whole sort
// is stable.  Keys are signed: a digit is taken of x ^ 0x80000000, which
// puts the keys in unsigned order (INT_MIN first, INT_MAX last).  A pass:
//   1. per-warp digit histograms in shared memory (each warp owns one
//      contiguous chunk of the input);
//   2. an exclusive scan of the counts in (digit, warp) order, which
//      gives each warp the first output slot of each digit;
//   3. a scatter in index order: each warp walks its chunk 32 items at a
//      time, ranks lanes of one digit with __match_any_sync and __popc,
//      and its leader lane advances the warp's slot for that digit.
// Keys and perm ping-pong through global scratch; a key's first pass
// gathers it through the current perm.  A pass in which every item has
// the same digit keeps the order and is skipped (found on the device
// from the histogram; nothing is read back).  The caller may also give a
// key fewer digit passes when it knows the key's range (bytes_packed).
//
// kat_run_starts: seg_start[s] for s in [0, S] = the first position of a
// sorted key in [0, S] that is >= s (torch.searchsorted(key, arange(S+1))).
//
// kat_sorted_lookup: pos[i] = the first position of sorted[] that is
// >= q[i] (searchsorted, side left) and found[i] = sorted[pos] == q[i].
//
// Bound: bytes — each key and the perm read once and perm written once:
// ~0.4-1.4 MB at 51,200 items and 1-6 keys, ~0.1-0.4 us at 3.35 TB/s.
// One CTA of one SM runs every pass, reading its chunk twice (histogram,
// scatter) from L2, so a pass costs tens of microseconds; a multi-CTA
// (onesweep) sort is later speed work.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int ROW = RADIX + 1;  // a warp's counts; +1 spreads the banks
constexpr int MAX_KEYS = 6;     // stable_sort.py's MAX_KEYS
constexpr int U = 4;            // items in flight per lane

struct Keys {
  const int* k[MAX_KEYS];
};

__device__ __forceinline__ unsigned digit_of(int x, int shift) {
  return (((unsigned)x ^ 0x80000000u) >> shift) & 0xFFu;
}

__global__ void __launch_bounds__(THREADS) stable_sort_kernel(
    Keys keys, int nkeys, int n, unsigned bytes_packed, int* kA, int* pA, int* kB, int* pB,
    int* __restrict__ perm_out, int* __restrict__ key_out) {
  // (no __restrict__ on the scratch: every pass reads what the last one wrote)
  __shared__ int cnt[WARPS * ROW];  // [warp][digit]
  __shared__ int uniform;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + WARPS - 1) / WARPS;
  const int lo = min(n, warp * per), hi = min(n, lo + per);
  const unsigned lt = (1u << lane) - 1u;
  const int* kin = nullptr;  // current keys in sorted order (after a pass)
  const int* pin = nullptr;  // current perm; nullptr: the identity
  int* kout = kA;
  int* pout = pA;
  for (int k = 0; k < nkeys; ++k) {
    const int* src = keys.k[k];
    bool gather = true;  // the key is not carried in kin yet
    const int nb = (bytes_packed >> (3 * k)) & 7;
    for (int b = 0; b < nb; ++b) {
      const int shift = 8 * b;
      for (int e = tid; e < WARPS * ROW; e += THREADS) cnt[e] = 0;
      if (tid == 0) uniform = 0;
      __syncthreads();
      for (int base = lo; base < hi; base += 32 * U) {
        int x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + 32 * u + lane;
          if (i < hi) x[u] = gather ? src[pin ? pin[i] : i] : kin[i];
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
        if (tot == n) uniform = 1;
      }
      __syncthreads();
      const bool skip = uniform;
      __syncthreads();  // every thread has read it before the next pass resets it
      if (skip) continue;
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
          if (i < hi) {
            p[u] = pin ? pin[i] : i;
            x[u] = gather ? src[p[u]] : kin[i];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool ok = base + 32 * u + lane < hi;
          const unsigned d = ok ? digit_of(x[u], shift) : RADIX;  // RADIX: no item
          const unsigned peers = __match_any_sync(0xffffffffu, d);
          if (ok) {
            const int pos = cnt[warp * ROW + d] + __popc(peers & lt);
            kout[pos] = x[u];
            pout[pos] = p[u];
          }
          __syncwarp();
          if (ok && lane == __ffs(peers) - 1) cnt[warp * ROW + d] += __popc(peers);
          __syncwarp();
        }
      }
      __syncthreads();  // the block's global writes are visible to it after this
      gather = false;
      kin = kout;
      pin = pout;
      kout = kout == kA ? kB : kA;
      pout = pout == pA ? pB : pA;
    }
  }
  const int* primary = keys.k[nkeys - 1];
  for (int i = tid; i < n; i += THREADS) {
    const int p = pin ? pin[i] : i;
    perm_out[i] = p;
    if (key_out) key_out[i] = primary[p];
  }
}

__global__ void run_starts_kernel(const int* __restrict__ key, int n, int S,
                                  int* __restrict__ seg_start) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // boundary i in [0, n]
  if (i > n) return;
  const int prev = i == 0 ? -1 : key[i - 1];
  const int cur = i == n ? S : min(key[i], S);
  for (int s = prev + 1; s <= cur; ++s) seg_start[s] = i;
}

__global__ void sorted_lookup_kernel(const int* __restrict__ sorted, int n,
                                     const int* __restrict__ q, int m,
                                     long long* __restrict__ pos,
                                     uint8_t* __restrict__ found) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int x = q[i];
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  pos[i] = lo;
  found[i] = lo < n && sorted[lo] == x;
}

}  // namespace

extern "C" int kat_stable_sort(const int* k0, const int* k1, const int* k2, const int* k3,
                               const int* k4, const int* k5, int nkeys, int n,
                               int bytes_packed, int* perm_out, int* key_out, int* scratch,
                               void* stream) {
  if (nkeys < 1 || nkeys > MAX_KEYS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    Keys keys = {{k0, k1, k2, k3, k4, k5}};
    stable_sort_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        keys, nkeys, n, (unsigned)bytes_packed, scratch, scratch + n, scratch + 2 * (size_t)n,
        scratch + 3 * (size_t)n, perm_out, key_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int kat_run_starts(const int* key, int n, int S, int* seg_start, void* stream) {
  const int threads = 256;
  run_starts_kernel<<<(n + 1 + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      key, n, S, seg_start);
  return (int)cudaGetLastError();
}

extern "C" int kat_sorted_lookup(const int* sorted, int n, const int* q, int m,
                                 long long* pos, uint8_t* found, void* stream) {
  if (m > 0) {
    const int threads = 256;
    sorted_lookup_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        sorted, n, q, m, pos, found);
  }
  return (int)cudaGetLastError();
}
