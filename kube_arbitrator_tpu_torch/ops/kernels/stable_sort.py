"""K19 ``stable_sort``: the stable lexicographic sort of one to six int32
keys, the segment order of K4, and the two searches over a sorted key
that its callers need.

Replaces the sort chains of the victim layouts and the claim-log join
(kube_arbitrator_tpu/ops/preempt.py ``SortLayout.build`` :106-126, its
``jnp.lexsort`` :118; ``_replay_claim_log`` :1544-1563, ``jnp.argsort``
and ``jnp.searchsorted``), the claimant decode's and the canon pack's
``searchsorted`` (side right) and the port's segment order for K4:

* :func:`stable_sort` — perm i32[n] of ``jnp.lexsort(keys)`` (the LAST
  key primary, ties by index), and the primary key in sorted order;
* :func:`segment_order` — (perm, seg_start) of segment ids in [0, S]:
  the slots stably sorted by segment and each segment's first slot;
* :func:`run_starts` — the run starts of a sorted key in [0, S]
  (``searchsorted(key, arange(S + 1))``);
* :func:`sorted_lookup` — each query's ``searchsorted`` (side left or
  right) in a sorted key and whether it is there.

The sorts have two variants on the card (csrc/stable_sort.cu): one CTA
for small n, and for larger n one cooperative launch whose CTAs sort
tiles of ``TILE`` items pass by pass (a segment order whose S + 1 bins
fit ``COUNT_MAX_BINS`` is one counting pass).  :func:`sort_variant` and
:func:`segment_order_variant` pick by n.

Keys are signed (negative priorities, INT_MAX padding).  ``bounds`` names
a key's range [0, bound] where the caller knows it as a Python int, so
the kernel runs only the digit passes that range needs; on the CPU the
plain version checks every bound.  CPU tensors take the plain versions
(stable torch sorts, ``torch.searchsorted``); CUDA tensors launch the
kernels.  One launch counter, ``stable_sort.launches``, counts the
launches of every entry; ``stable_sort.variants`` counts them by variant.
CUDA source: csrc/stable_sort.cu.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import build
from .build import I, P

MAX_KEYS = 6  # csrc/stable_sort.cu's MAX_KEYS
TILE = 2048  # csrc/stable_sort.cu's TILE: items per tile of the tiled variant
COUNT_MAX_BINS = 2048  # csrc/stable_sort.cu's MAX_BINS: a counting pass's bins at most
# n at most this sorts in one CTA; above it, the tiled variant.  Measured
# on one H100 (chip_smoke.py phase 1, one wrapper call; PERF.md):
# one CTA / tiles at 4,096 items 0.067 / 0.101 ms (one key) and 0.201 /
# 0.274 ms (four keys), at 8,192 0.122 / 0.100 and 0.323 / 0.307, at
# 16,384 0.175 / 0.104 and 0.624 / 0.307.
ONE_CTA_MAX_N = 8192

# C signatures of csrc/stable_sort.cu
SIGNATURES = {
    # (k0..k5, nkeys, n, bytes_packed, perm_out, key_out, scratch, stream)
    "kat_stable_sort": (P, P, P, P, P, P, I, I, I, P, P, P, P),
    # (k0..k5, nkeys, n, bytes_packed, perm_out, key_out, scratch, ws, ws_words, stream)
    "kat_stable_sort_tiles": (P, P, P, P, P, P, I, I, I, P, P, P, P, I, P),
    # (idx, n, S, perm_out, seg_start, scratch, ws, ws_words, stream)
    "kat_segment_order": (P, I, I, P, P, P, P, I, P),
    # (sorted_key, n, S, seg_start, stream)
    "kat_run_starts": (P, I, I, P, P),
    # (sorted, n, queries, m, right, pos i64, pos i32, found, stream)
    "kat_sorted_lookup": (P, I, P, I, I, P, P, P, P),
}
VARIANTS = ("one_cta", "tiles", "count", "run_starts", "lookup")


def digit_passes(bound: Optional[int]) -> int:
    """8-bit digit passes that keys in [0, ``bound``] need (4 for any
    int32 key when ``bound`` is None): the higher digits are equal."""
    if bound is None:
        return 4
    if not 0 <= bound < 2**31:
        raise ValueError(f"stable_sort: bound {bound} outside [0, 2**31)")
    return (bound.bit_length() + 7) // 8


def sort_variant(n: int) -> str:
    """The card's sort for n items: ``one_cta`` or ``tiles``."""
    return "one_cta" if n <= ONE_CTA_MAX_N else "tiles"


def segment_order_variant(n: int, num_segments: int) -> str:
    """The card's segment order for n slots and S segments: ``one_cta``
    (the one-CTA sort, then run starts), ``count`` (one counting pass
    whose scanned histogram is seg_start) or ``tiles`` (the tiled radix
    sort, then run starts: more bins than a counting pass holds)."""
    if n <= ONE_CTA_MAX_N:
        return "one_cta"
    return "count" if num_segments + 1 <= COUNT_MAX_BINS else "tiles"


def workspace_words(n: int, npass: int, bins: int) -> int:
    """int32 words of the tiled variant's device workspace: control
    words, the per-pass histograms and info words, and the look-back
    words of every (pass, tile, bin)."""
    ntiles = -(-n // TILE)
    return 4 + npass * bins + npass + npass * ntiles * bins


def _count(variant: str) -> None:
    build.launched(stable_sort)
    stable_sort.variants[variant] += 1


def _check_keys(keys: Sequence[torch.Tensor], bounds) -> None:
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"stable_sort: {len(keys)} keys, want 1 to {MAX_KEYS}")
    n, dev = keys[0].shape, keys[0].device
    for k in keys:
        if k.dtype != torch.int32 or k.dim() != 1 or k.shape != n or k.device != dev:
            raise ValueError("stable_sort: keys must be i32[n] of one length on one device")
    if bounds is not None and len(bounds) != len(keys):
        raise ValueError("stable_sort: one bound (or None) per key")


def stable_sort_plain(keys: Sequence[torch.Tensor], bounds=None, want_sorted: bool = False):
    """Stable sorts, least significant key first; every bound is checked."""
    for k, b in zip(keys, bounds or ()):
        if b is not None and k.numel() and not bool(((k >= 0) & (k <= b)).all()):
            raise ValueError(f"stable_sort: a key leaves its bound [0, {b}]")
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm.to(torch.int32), (keys[-1][perm] if want_sorted else None)


def stable_sort(keys: Sequence[torch.Tensor], bounds: Optional[Sequence[Optional[int]]] = None,
                want_sorted: bool = False, variant: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """i32 keys [n] (the last primary) -> (perm i32[n], the primary key
    sorted i32[n] when ``want_sorted``, else None).  ``bounds``: per key
    a Python int ``b`` for keys known to lie in [0, b], or None.
    ``variant`` forces the card's ``one_cta`` or ``tiles`` sort (default:
    :func:`sort_variant`)."""
    _check_keys(keys, bounds)
    if keys[0].device.type == "cpu":
        return stable_sort_plain(keys, bounds, want_sorted)
    if keys[0].device.type != "cuda":
        raise ValueError(f"stable_sort: tensors on {keys[0].device}")
    keys = [k.contiguous() for k in keys]
    n, dev = keys[0].shape[0], keys[0].device
    variant = variant or sort_variant(n)
    passes = [digit_passes(None if bounds is None else bounds[i]) for i in range(len(keys))]
    packed = 0
    for i, nb in enumerate(passes):
        packed |= nb << (3 * i)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    sorted_key = torch.empty(n, dtype=torch.int32, device=dev) if want_sorted else None
    scratch = torch.empty(4 * n, dtype=torch.int32, device=dev)
    ptrs = [build.ptr(k) for k in keys] + [0] * (MAX_KEYS - len(keys))
    if variant == "one_cta":
        fn = build.bind("stable_sort", "kat_stable_sort", SIGNATURES)
        rc = fn(*ptrs, len(keys), n, packed, build.ptr(perm), build.ptr(sorted_key),
                build.ptr(scratch), build.stream())
    elif variant == "tiles":
        words = workspace_words(n, max(sum(passes), 1), 256)
        ws = torch.empty(words, dtype=torch.int32, device=dev)
        fn = build.bind("stable_sort", "kat_stable_sort_tiles", SIGNATURES)
        rc = fn(*ptrs, len(keys), n, packed, build.ptr(perm), build.ptr(sorted_key),
                build.ptr(scratch), build.ptr(ws), words, build.stream())
    else:
        raise ValueError(f"stable_sort: variant {variant!r}")
    build.check(rc, "stable_sort")
    _count(variant)
    return perm, sorted_key


stable_sort.launches = 0
stable_sort.variants = dict.fromkeys(VARIANTS, 0)


def segment_order_plain(idx: torch.Tensor, num_segments: int):
    """A stable sort of the clamped key, then the run starts."""
    valid = (idx >= 0) & (idx < num_segments)
    key = torch.where(valid, idx, num_segments).to(torch.int32)
    perm, sorted_key = stable_sort_plain((key,), bounds=(num_segments,), want_sorted=True)
    return perm, run_starts_plain(sorted_key, num_segments)


def segment_order(idx: torch.Tensor, num_segments: int, variant: Optional[str] = None):
    """(perm i32[T], seg_start i32[S+1]): slots stably sorted by segment,
    and the start of every segment's contiguous run (out-of-range slots
    sort last and fall outside every run).  A caller that sums over the
    same ``idx`` many times computes this once and passes it as
    ``order=`` to segment_sum.  ``variant`` forces the card's
    ``one_cta``, ``count`` or ``tiles`` route (default:
    :func:`segment_order_variant`)."""
    if idx.dim() != 1 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError("segment_order: idx must be an integer [T]")
    if idx.dtype != torch.int32:  # out-of-range ids clamp before the cast
        idx = torch.where((idx >= 0) & (idx < num_segments), idx, num_segments).to(torch.int32)
    if idx.device.type == "cpu":
        return segment_order_plain(idx, num_segments)
    if idx.device.type != "cuda":
        raise ValueError(f"segment_order: tensor on {idx.device}")
    n, S, dev = idx.shape[0], num_segments, idx.device
    variant = variant or segment_order_variant(n, S)
    if variant != "count":
        key = torch.where((idx >= 0) & (idx < S), idx, S).to(torch.int32)
        perm, sorted_key = stable_sort((key,), bounds=(S,), want_sorted=True, variant=variant)
        return perm, run_starts(sorted_key, S)
    if S + 1 > COUNT_MAX_BINS:
        raise ValueError(f"segment_order: {S + 1} bins, a counting pass holds {COUNT_MAX_BINS}")
    idx = idx.contiguous()
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    seg_start = torch.empty(S + 1, dtype=torch.int32, device=dev)
    words = workspace_words(n, 1, S + 1)
    ws = torch.empty(words, dtype=torch.int32, device=dev)
    fn = build.bind("stable_sort", "kat_segment_order", SIGNATURES)
    # one pass writes perm directly: no ping-pong scratch
    build.check(fn(build.ptr(idx), n, S, build.ptr(perm), build.ptr(seg_start), 0,
                   build.ptr(ws), words, build.stream()), "stable_sort")
    _count("count")
    return perm, seg_start


def run_starts_plain(sorted_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    bounds = torch.arange(num_segments + 1, dtype=torch.int32, device=sorted_key.device)
    return torch.searchsorted(sorted_key, bounds, right=False, out_int32=True)


def run_starts(sorted_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """i32[S+1]: the first position of each s in [0, S] in an ascending
    i32 key whose values lie in [0, S]."""
    if sorted_key.dtype != torch.int32 or sorted_key.dim() != 1:
        raise ValueError("run_starts: the key must be i32[n]")
    if sorted_key.device.type == "cpu":
        return run_starts_plain(sorted_key, num_segments)
    if sorted_key.device.type != "cuda":
        raise ValueError(f"run_starts: tensor on {sorted_key.device}")
    sorted_key = sorted_key.contiguous()
    out = torch.empty(num_segments + 1, dtype=torch.int32, device=sorted_key.device)
    fn = build.bind("stable_sort", "kat_run_starts", SIGNATURES)
    build.check(fn(build.ptr(sorted_key), sorted_key.shape[0], num_segments, build.ptr(out),
                   build.stream()), "stable_sort")
    _count("run_starts")
    return out


def sorted_lookup_plain(sorted_keys: torch.Tensor, queries: torch.Tensor, side: str = "left",
                        out_int32: bool = False):
    pos = torch.searchsorted(sorted_keys, queries, side=side, out_int32=out_int32)
    n = sorted_keys.shape[0]
    at = pos - 1 if side == "right" else pos
    hit = (at >= 0) & (at < n)
    if n == 0:
        return pos, hit
    return pos, hit & (sorted_keys[at.clamp(0, n - 1)] == queries)


def sorted_lookup(sorted_keys: torch.Tensor, queries: torch.Tensor, side: str = "left",
                  out_int32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending i32 ``sorted_keys`` [n], i32 ``queries`` [m] -> (pos
    i64[m] (i32 with ``out_int32``), the ``searchsorted`` of each query on
    ``side`` "left" (the first position >= query) or "right" (the first
    position > query); found bool[m], whether the query occurs in
    ``sorted_keys``)."""
    if side not in ("left", "right"):
        raise ValueError(f"sorted_lookup: side {side!r}")
    for t in (sorted_keys, queries):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != sorted_keys.device:
            raise ValueError("sorted_lookup: want i32[n] keys and i32[m] queries on one device")
    if sorted_keys.device.type == "cpu":
        return sorted_lookup_plain(sorted_keys, queries, side, out_int32)
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"sorted_lookup: tensors on {sorted_keys.device}")
    sorted_keys, queries = sorted_keys.contiguous(), queries.contiguous()
    m = queries.shape[0]
    pos = torch.empty(m, dtype=torch.int32 if out_int32 else torch.int64, device=queries.device)
    found = torch.empty(m, dtype=torch.bool, device=queries.device)
    fn = build.bind("stable_sort", "kat_sorted_lookup", SIGNATURES)
    build.check(fn(build.ptr(sorted_keys), sorted_keys.shape[0], build.ptr(queries), m,
                   int(side == "right"), 0 if out_int32 else build.ptr(pos),
                   build.ptr(pos) if out_int32 else 0, build.ptr(found), build.stream()),
                "stable_sort")
    _count("lookup")
    return pos, found
