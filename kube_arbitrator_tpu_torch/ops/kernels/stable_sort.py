"""K19 ``stable_sort``: the stable lexicographic sort of one to six int32
keys, and the two searches over a sorted key that its callers need.

Replaces the sort chains of the victim layouts and the claim-log join
(kube_arbitrator_tpu/ops/preempt.py ``SortLayout.build`` :106-126, its
``jnp.lexsort`` :118; ``_replay_claim_log`` :1544-1563, ``jnp.argsort``
and ``jnp.searchsorted``) and the port's segment order for K4
(segment_sum.segment_order):

* :func:`stable_sort` — perm i32[n] of ``jnp.lexsort(keys)`` (the LAST
  key primary, ties by index), and the primary key in sorted order;
* :func:`run_starts` — the run starts of a sorted key in [0, S]
  (``searchsorted(key, arange(S + 1))``);
* :func:`sorted_lookup` — each query's ``searchsorted`` (side left) in a
  sorted key and whether it is there.

Keys are signed (negative priorities, INT_MAX padding).  ``bounds`` names
a key's range [0, bound] where the caller knows it as a Python int, so
the kernel runs only the digit passes that range needs; on the CPU the
plain version checks every bound.  CPU tensors take the plain versions
(stable torch sorts, ``torch.searchsorted``); CUDA tensors launch the
kernels.  One launch counter, ``stable_sort.launches``, counts the
launches of all three.  CUDA source: csrc/stable_sort.cu.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import build
from .build import I, P

MAX_KEYS = 6  # csrc/stable_sort.cu's MAX_KEYS

# C signatures of csrc/stable_sort.cu
SIGNATURES = {
    # (k0..k5, nkeys, n, bytes_packed, perm_out, key_out, scratch, stream)
    "kat_stable_sort": (P, P, P, P, P, P, I, I, I, P, P, P, P),
    # (sorted_key, n, S, seg_start, stream)
    "kat_run_starts": (P, I, I, P, P),
    # (sorted, n, queries, m, pos, found, stream)
    "kat_sorted_lookup": (P, I, P, I, P, P, P),
}


def digit_passes(bound: Optional[int]) -> int:
    """8-bit digit passes that keys in [0, ``bound``] need (4 for any
    int32 key when ``bound`` is None): the higher digits are equal."""
    if bound is None:
        return 4
    if not 0 <= bound < 2**31:
        raise ValueError(f"stable_sort: bound {bound} outside [0, 2**31)")
    return (bound.bit_length() + 7) // 8


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
                want_sorted: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """i32 keys [n] (the last primary) -> (perm i32[n], the primary key
    sorted i32[n] when ``want_sorted``, else None).  ``bounds``: per key
    a Python int ``b`` for keys known to lie in [0, b], or None."""
    _check_keys(keys, bounds)
    if keys[0].device.type == "cpu":
        return stable_sort_plain(keys, bounds, want_sorted)
    if keys[0].device.type != "cuda":
        raise ValueError(f"stable_sort: tensors on {keys[0].device}")
    keys = [k.contiguous() for k in keys]
    n, dev = keys[0].shape[0], keys[0].device
    packed = 0
    for i in range(len(keys)):
        packed |= digit_passes(None if bounds is None else bounds[i]) << (3 * i)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    sorted_key = torch.empty(n, dtype=torch.int32, device=dev) if want_sorted else None
    scratch = torch.empty(4 * n, dtype=torch.int32, device=dev)
    ptrs = [build.ptr(k) for k in keys] + [0] * (MAX_KEYS - len(keys))
    fn = build.bind("stable_sort", "kat_stable_sort", SIGNATURES)
    build.check(fn(*ptrs, len(keys), n, packed, build.ptr(perm), build.ptr(sorted_key),
                   build.ptr(scratch), build.stream()), "stable_sort")
    stable_sort.launches += 1
    return perm, sorted_key


stable_sort.launches = 0


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
    stable_sort.launches += 1
    return out


def sorted_lookup_plain(sorted_keys: torch.Tensor, queries: torch.Tensor):
    pos = torch.searchsorted(sorted_keys, queries)
    n = sorted_keys.shape[0]
    if n == 0:
        return pos, torch.zeros_like(queries, dtype=torch.bool)
    return pos, (pos < n) & (sorted_keys[pos.clamp(max=n - 1)] == queries)


def sorted_lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending i32 ``sorted_keys`` [n], i32 ``queries`` [m] -> (pos
    i64[m], the ``searchsorted`` of each query, side left; found bool[m],
    ``sorted_keys[pos] == query``)."""
    for t in (sorted_keys, queries):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != sorted_keys.device:
            raise ValueError("sorted_lookup: want i32[n] keys and i32[m] queries on one device")
    if sorted_keys.device.type == "cpu":
        return sorted_lookup_plain(sorted_keys, queries)
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"sorted_lookup: tensors on {sorted_keys.device}")
    sorted_keys, queries = sorted_keys.contiguous(), queries.contiguous()
    m = queries.shape[0]
    pos = torch.empty(m, dtype=torch.int64, device=queries.device)
    found = torch.empty(m, dtype=torch.bool, device=queries.device)
    fn = build.bind("stable_sort", "kat_sorted_lookup", SIGNATURES)
    build.check(fn(build.ptr(sorted_keys), sorted_keys.shape[0], build.ptr(queries), m,
                   build.ptr(pos), build.ptr(found), build.stream()), "stable_sort")
    stable_sort.launches += 1
    return pos, found
