// K19 stable_sort: the stable lexicographic sort of one to six int32 keys,
// the segment order of K4 as one counting sort, and the two searches over
// a sorted key that the sort's callers need.
//
// Replaces the sort chains of the victim layouts and the claim-log join:
// kube_arbitrator_tpu/ops/preempt.py SortLayout.build (:106, jnp.lexsort
// :118) and _replay_claim_log (:1544-1563, jnp.argsort + jnp.searchsorted),
// the claimant decode and the canon slot -> node map (jnp.searchsorted,
// side right), and the port's own segment order for K4 (the reference
// adds with .at[].add, ops/cycle.py:233-239).
//
// kat_stable_sort / kat_stable_sort_tiles: perm of jnp.lexsort(keys) — the
// LAST key primary, ties by index.  LSD radix sort with 8-bit digits of the
// least significant key first, each pass stable, so the whole sort is
// stable.  Keys are signed: a digit is taken of x ^ 0x80000000, which puts
// the keys in unsigned order (INT_MIN first, INT_MAX last).  The caller may
// give a key fewer digit passes when it knows the key's range
// (bytes_packed).  Two variants, picked by n in stable_sort.py:
//
// * one CTA (small n: queue-sized keys, the J = 512 claim sort): each pass
//   is radix.cuh's block_radix_pass over global scratch, the first pass of
//   a key gathering it through the current perm.
// * tiles across CTAs (large n): radix.cuh's run_tiles, one cooperative
//   launch.  One launch in place of one per pass: the first design of
//   this variant (a histogram launch and one launch per digit pass) spent
//   more time on the host launching than on the device (PERF.md).
//
// kat_segment_order: (perm, seg_start) of K4's segment ids in [0, S] (out
// of range -> S) as ONE counting-sort pass of the tiled kernel with S + 1
// bins: the histogram phase's scan of the S + 1 counts IS seg_start, so
// no run-starts launch follows.
//
// kat_run_starts: seg_start[s] for s in [0, S] = the first position of a
// sorted key in [0, S] that is >= s (torch.searchsorted(key, arange(S+1))).
//
// kat_sorted_lookup: pos[i] = searchsorted(sorted, q[i]) on side left (the
// first position >= q) or right (the first position > q), and found[i] =
// whether q[i] occurs in sorted.
#include "radix.cuh"

namespace {

__global__ void __launch_bounds__(THREADS) stable_sort_kernel(
    Keys keys, int nkeys, int n, unsigned bytes_packed, int* kA, int* pA, int* kB, int* pB,
    int* __restrict__ perm_out, int* __restrict__ key_out) {
  // (no __restrict__ on the scratch: every pass reads what the last one wrote)
  __shared__ int cnt[WARPS * ROW];  // [warp][digit]
  __shared__ int uniform;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int per = (n + WARPS - 1) / WARPS;
  const int lo = min(n, warp * per), hi = min(n, lo + per);
  const int* kin = nullptr;  // current keys in sorted order (after a pass)
  const int* pin = nullptr;  // current perm; nullptr: the identity
  int* kout = kA;
  int* pout = pA;
  for (int k = 0; k < nkeys; ++k) {
    const int* src = keys.k[k];
    bool gather = true;  // the key is not carried in kin yet
    const int nb = (bytes_packed >> (3 * k)) & 7;
    for (int b = 0; b < nb; ++b) {
      const bool moved = block_radix_pass(
          n, lo, hi, 8 * b, cnt, &uniform,
          [&](int i, int& x, int& p) {
            p = pin ? pin[i] : i;
            x = gather ? src[p] : kin[i];
          },
          [&](int pos, int x, int p) {
            kout[pos] = x;
            pout[pos] = p;
          });
      if (!moved) continue;
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
                                     const int* __restrict__ q, int m, int right,
                                     long long* __restrict__ pos, int* __restrict__ pos32,
                                     uint8_t* __restrict__ found) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int x = q[i];
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (right ? sorted[mid] <= x : sorted[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  if (pos) pos[i] = lo;
  if (pos32) pos32[i] = lo;
  if (found) {
    const int at = right ? lo - 1 : lo;
    found[i] = at >= 0 && at < n && sorted[at] == x;
  }
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

extern "C" int kat_stable_sort_tiles(const int* k0, const int* k1, const int* k2, const int* k3,
                                     const int* k4, const int* k5, int nkeys, int n,
                                     int bytes_packed, int* perm_out, int* key_out, int* scratch,
                                     int* ws, int ws_words, void* stream) {
  if (nkeys < 1 || nkeys > MAX_KEYS || n >= (int)FLAG_AGG) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Plan pl;
  pl.keys = {{k0, k1, k2, k3, k4, k5}};
  pl.nkeys = nkeys;
  pl.bins = RADIX;
  pl.count_S = -1;
  pl.npass = 0;
  for (int k = 0; k < nkeys; ++k) {
    const int nb = (bytes_packed >> (3 * k)) & 7;
    for (int b = 0; b < nb; ++b) {
      pl.key_of[pl.npass] = (signed char)k;
      pl.shift_of[pl.npass] = (signed char)(8 * b);
      ++pl.npass;
    }
  }
  if (pl.npass == 0) {  // every key constant by its bounds: one identity pass
    pl.key_of[0] = (signed char)(nkeys - 1);
    pl.shift_of[0] = 0;
    pl.npass = 1;
  }
  return run_tiles(pl, n, ws, ws_words, scratch, perm_out, key_out, nullptr,
                   (cudaStream_t)stream);
}

extern "C" int kat_segment_order(const int* idx, int n, int S, int* perm_out, int* seg_start,
                                 int* scratch, int* ws, int ws_words, void* stream) {
  if (S < 0 || S + 1 > MAX_BINS || n >= (int)FLAG_AGG) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(seg_start, 0, (S + 1) * sizeof(int), (cudaStream_t)stream);
  Plan pl;
  pl.keys = {{idx, nullptr, nullptr, nullptr, nullptr, nullptr}};
  pl.nkeys = 1;
  pl.npass = 1;
  pl.bins = S + 1;
  pl.count_S = S;
  pl.key_of[0] = 0;
  pl.shift_of[0] = 0;
  return run_tiles(pl, n, ws, ws_words, scratch, perm_out, nullptr, seg_start,
                   (cudaStream_t)stream);
}

extern "C" int kat_run_starts(const int* key, int n, int S, int* seg_start, void* stream) {
  const int threads = 256;
  run_starts_kernel<<<(n + 1 + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      key, n, S, seg_start);
  return (int)cudaGetLastError();
}

extern "C" int kat_sorted_lookup(const int* sorted, int n, const int* q, int m, int right,
                                 long long* pos, int* pos32, uint8_t* found, void* stream) {
  if (m > 0) {
    const int threads = 256;
    sorted_lookup_kernel<<<(m + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        sorted, n, q, m, right, pos, pos32, found);
  }
  return (int)cudaGetLastError();
}
