"""K16 ``stable_compact``: a row-wise stable stream compaction with a
cap, a pad value and the full count.

One function behind three chains of the reference:

* ops/cycle.py:_compact_indices (:181-208): the commit's bind / evict
  lists (one row of T, cap from ``decode_caps``, pad -1; the count is
  the full population, past cap too);
* ops/allocate.py:_compact_rows (:455-471) over the mask of
  ``_feasible_cells`` (:400-430): allocate's pruned node panel (K
  request classes x N nodes, pad N).  Given :class:`FeasCells`, the
  kernel evaluates the predicate itself, so mask and compaction are one
  launch;
* ops/preempt.py:_build_view (:233): preempt's victim panel (one row of
  T, cap P, pad T).

``stable_compact(mask, cap, pad)`` -> (idx i32[K, cap], count i32[K]):
row k's set positions in ascending order, then ``pad``.  ``mask`` is a
bool[K, L] or a :class:`FeasCells`.  :func:`stable_compact_pair` gives
the commit's two lists, each with its own mask, cap and pad, from one
launch.  Either takes ``out=``, its preallocated outputs (the caller
owns them: the lists outlive the call); without it, one buffer is
allocated for them.  On the card each row shape has a
:class:`StableCompactPlan` (bound at its first use, the last
``MAX_PLANS`` kept) and one launch a call; its count words are a
per-device workspace zeroed once, each launch stamping its own number,
and every launch on them takes the stream of the first (a launch from
another stream raises).
CUDA source: csrc/stable_compact.cu.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .build import P

EPS = DEVICE_EPSILON
BIG = 3.0e38
CHUNK = 2048  # csrc/stable_compact.cu's CHUNK (THREADS x PER_THREAD)

# C signatures of csrc/stable_compact.cu: (static, call, stream); the capacity
SIGNATURES = {"kat_stable_compact": (P, P, P), "kat_stable_compact_capacity": ()}


class _Static(ctypes.Structure):
    """csrc/stable_compact.cu's Static: the fixed arguments of a plan."""

    _fields_ = [("words", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("K", "L", "tiles", "span")]


class _Call(ctypes.Structure):
    """csrc/stable_compact.cu's Call: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "mask", "mask1", "class_fit", "node_klass", "node_valid", "node_unsched", "minreq",
        "basis", "idx", "idx1", "count", "count1",
    )] + [(n, ctypes.c_int) for n in ("CN", "R", "preds_on", "cap", "cap1", "pad", "pad1")] + [
        ("seq", ctypes.c_uint)]


@dataclasses.dataclass(frozen=True)
class FeasCells:
    """The inputs of allocate's feasibility cells (the reference's
    ``_feasible_cells``): cell (k, n) is set when node n is valid and, with
    the predicates plugin on, schedulable and of a predicate class that
    request class k fits; and, given ``minreq`` f32[K, R], no resource
    that class k requests lies above ``basis[n]`` + EPS."""

    class_fit: torch.Tensor     # bool[K, CN]
    node_klass: torch.Tensor    # i32[N]
    node_valid: torch.Tensor    # bool[N]
    node_unsched: torch.Tensor  # bool[N]
    preds_on: bool
    minreq: Optional[torch.Tensor]  # f32[K, R], None: predicates only
    basis: Optional[torch.Tensor]   # f32[N, R] max(idle, releasing)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.class_fit.shape[0], self.node_klass.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_valid.device

    def mask(self) -> torch.Tensor:
        """bool[K, N]: the cells, evaluated with torch."""
        K, n = self.shape
        if self.preds_on:
            feas = (self.class_fit[:, self.node_klass.to(torch.int64)]
                    & self.node_valid[None, :] & ~self.node_unsched[None, :])
        else:
            feas = self.node_valid[None, :].expand(K, n)
        if self.minreq is not None:
            m = self.minreq[:, None, :]
            never = ((m > 0) & (m < BIG / 2) & (self.basis[None, :, :] < m - EPS)).any(dim=-1)
            feas = feas & ~never
        return feas


def stable_compact_plain(mask: Union[torch.Tensor, FeasCells], cap: int, pad: int):
    """The plain version: an integer cumsum for the ranks, one scatter."""
    if isinstance(mask, FeasCells):
        mask = mask.mask()
    K, L = mask.shape
    mi = mask.to(torch.int32)
    pos = torch.cumsum(mi, dim=1, dtype=torch.int32) - 1
    count = mi.sum(dim=1, dtype=torch.int32)
    slot = torch.where(mask & (pos < cap), pos, cap).to(torch.int64)
    idx = torch.full((K, cap + 1), pad, dtype=torch.int32, device=mask.device)
    # only column cap (dropped below) can receive more than one write
    idx.scatter_(1, slot, torch.arange(L, dtype=torch.int32, device=mask.device).expand(K, L))
    return idx[:, :cap].contiguous(), count


def launch_shape(K: int, L: int, capacity: int) -> Tuple[int, int]:
    """(tiles, span) of a [K, L] launch: each row cut into ``tiles`` spans
    of ``span`` elements (a multiple of CHUNK), a CTA a span; with more
    than one span a row, K x tiles stays within ``capacity`` (the CTAs the
    card holds at once), since a row's spans wait on each other."""
    per_row = capacity // K if capacity > 0 else 1
    tiles = max(1, min(-(-L // CHUNK), per_row))
    per_tile = -(-max(L, 1) // tiles)
    span = -(-per_tile // CHUNK) * CHUNK
    return max(1, -(-L // span)), span


class _Words:
    """A device's count words (one a CTA the card holds at once), zeroed
    once, the number of its last launch, and the stream every launch on
    them takes: a span reads only words stamped with its launch's number,
    which holds while launches run one after another on one stream."""

    def __init__(self, device, capacity: int):
        self.t = torch.zeros(max(capacity, 1), dtype=torch.int64, device=device)
        self.seq = 0
        self.stream = build.stream()


MAX_PLANS = 64  # row shapes whose plans are kept; the oldest is dropped past it
_CAPACITY = [0]
_WORDS: Dict[torch.device, _Words] = {}
_PLANS: Dict[tuple, "StableCompactPlan"] = {}


class StableCompactPlan:
    """K16's launches for one row shape [K, L] on one device, bound once
    a process (:func:`plan_for`).  It holds the launch shape
    (:func:`launch_shape`) and the device's count words; a launch passes
    its rows (a bool[K, L] mask, :class:`FeasCells`, or the commit's two
    rows given apart), caps, pads and outputs, and takes the next launch
    number.  Every plan of a device shares its count words, so all its
    launches go to the stream of the device's first launch; a launch from
    another stream raises.  Nothing else is checked or allocated at a
    launch: :func:`stable_compact` and :func:`stable_compact_pair` check
    what they pass."""

    def __init__(self, K: int, L: int, device):
        if not _CAPACITY[0]:
            _CAPACITY[0] = build.bind("stable_compact", "kat_stable_compact_capacity",
                                      SIGNATURES)()
            if _CAPACITY[0] <= 0:
                raise RuntimeError("stable_compact: the card's CTA capacity is unknown")
        self.K, self.L = K, L
        self.tiles, self.span = launch_shape(K, L, _CAPACITY[0])
        words = _WORDS.get(device)
        if words is None:
            words = _WORDS[device] = _Words(device, _CAPACITY[0])
        self.words = words
        self.static = _Static(words.t.data_ptr(), K, L, self.tiles, self.span)
        self.static_ptr = ctypes.addressof(self.static)
        self.call = _Call()
        self.call_ptr = ctypes.addressof(self.call)
        self.fn = build.bind("stable_compact", "kat_stable_compact", SIGNATURES)

    def __call__(self, mask, cap: int, pad: int, idx, count, cells: Optional[FeasCells] = None,
                 second=None) -> None:
        """One launch: rows ``mask`` (or ``cells``) into ``idx`` i32[K,
        cap] / ``count`` i32[K]; ``second`` = (mask1, cap1, pad1, idx1,
        count1) is row 1 given apart (a plan of K = 2)."""
        c = self.call
        c.mask = 0 if mask is None else mask.data_ptr()
        c.cap, c.pad, c.idx, c.count = cap, pad, idx.data_ptr(), count.data_ptr()
        if cells is not None:
            c.class_fit, c.node_klass = cells.class_fit.data_ptr(), cells.node_klass.data_ptr()
            c.node_valid, c.node_unsched = cells.node_valid.data_ptr(), cells.node_unsched.data_ptr()
            c.minreq, c.basis = build.ptr(cells.minreq), build.ptr(cells.basis)
            c.CN, c.preds_on = cells.class_fit.shape[1], int(cells.preds_on)
            c.R = 0 if cells.minreq is None else cells.minreq.shape[1]
        if second is not None:
            m1, c.cap1, c.pad1, idx1, count1 = second
            c.mask1, c.idx1, c.count1 = m1.data_ptr(), idx1.data_ptr(), count1.data_ptr()
        elif c.mask1:
            c.mask1 = c.idx1 = c.count1 = None
            c.cap1 = c.pad1 = 0
        w = self.words
        if build.stream() != w.stream:
            raise RuntimeError("stable_compact: a launch from another stream than the device's "
                               "first; its count words serve one stream")
        w.seq = w.seq % 0xFFFFFFFF + 1  # 1, 2, ..., never 0 (the zeroed words' number)
        c.seq = w.seq
        build.check(self.fn(self.static_ptr, self.call_ptr, w.stream), "stable_compact")
        build.launched(stable_compact)


def plan_for(index: int, K: int, L: int) -> StableCompactPlan:
    """The plan of row shape [K, L] on CUDA device ``index``, built at its
    first use; past ``MAX_PLANS`` shapes the oldest plan is dropped."""
    key = (index, K, L)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= MAX_PLANS:
            del _PLANS[next(iter(_PLANS))]
        plan = _PLANS[key] = StableCompactPlan(K, L, torch.device("cuda", index))
    return plan


def _outputs(rows, dev):
    """New outputs (idx i32[K, cap], count i32[K]) for each (K, cap) of
    ``rows``: views of one i32 buffer."""
    out = torch.empty(sum(K * cap + K for K, cap in rows), dtype=torch.int32, device=dev)
    views, at = [], 0
    for K, cap in rows:
        views.append((out[at:at + K * cap].view(K, cap), out[at + K * cap:at + K * cap + K]))
        at += K * cap + K
    return views


def _check(m, K: int, L: int, idx, count, cap: int) -> None:
    """A launch's mask row(s) and outputs, as the kernel reads them."""
    if m is not None and (m.dtype is not torch.bool or m.shape != (K, L) or not m.is_cuda
                          or not m.is_contiguous()):
        raise ValueError(f"stable_compact: mask must be a contiguous bool[{K}, {L}] on the card")
    if idx.dtype is not torch.int32 or idx.shape != (K, cap) or not idx.is_contiguous() \
            or count.dtype is not torch.int32 or count.shape != (K,):
        raise ValueError(f"stable_compact: out must be (i32[{K}, {cap}], i32[{K}]), contiguous")


def stable_compact(mask: Union[torch.Tensor, FeasCells], cap: int, pad: int, out=None):
    """-> (idx i32[K, cap], count i32[K]) for ``mask`` bool[K, L] or a
    :class:`FeasCells`, into ``out`` = (idx, count) when given (else new
    views of one buffer).  CPU tensors take the plain version; CUDA
    tensors launch the kernel once."""
    K, L = mask.shape
    if cap < 0 or K == 0:
        raise ValueError(f"stable_compact: cap {cap}, {K} rows")
    if isinstance(mask, torch.Tensor) and mask.is_cuda and out is not None:  # the lean path
        _check(mask, K, L, *out, cap)
        plan_for(mask.get_device(), K, L)(mask, cap, pad, *out)
        return out
    dev = mask.device
    if dev.type == "cpu":
        got = stable_compact_plain(mask, cap, pad)
        if out is None:
            return got
        out[0].copy_(got[0])
        out[1].copy_(got[1])
        return out
    if dev.type != "cuda":
        raise ValueError(f"stable_compact: tensors on {dev}")
    cells = mask if isinstance(mask, FeasCells) else None
    if cells is not None:
        checks = [(cells.class_fit, torch.bool), (cells.node_klass, torch.int32),
                  (cells.node_valid, torch.bool), (cells.node_unsched, torch.bool)]
        if cells.minreq is not None:
            checks += [(cells.minreq, torch.float32), (cells.basis, torch.float32)]
        for i, (t, dt) in enumerate(checks):
            build.require(t, dt, f"stable_compact.cells{i}", dev)
        R = 0 if cells.minreq is None else cells.minreq.shape[1]
        if cells.minreq is not None and (cells.minreq.shape[0] != K or cells.basis.shape != (L, R)):
            raise ValueError("stable_compact: minreq must be f32[K, R], basis f32[N, R]")
        mask = None
    idx, count = _outputs(((K, cap),), dev)[0] if out is None else out
    _check(mask, K, L, idx, count, cap)
    plan_for(dev.index, K, L)(mask, cap, pad, idx, count, cells=cells)
    return idx, count


def stable_compact_pair(m0: torch.Tensor, cap0: int, pad0: int, m1: torch.Tensor, cap1: int,
                        pad1: int, out=None):
    """Two lists from one launch: -> ((idx0 i32[cap0], count0 i32[]),
    (idx1 i32[cap1], count1 i32[])) for masks ``m0`` / ``m1`` bool[L],
    into ``out`` = (idx0 i32[1, cap0], count0 i32[1], idx1 i32[1, cap1],
    count1 i32[1]) when given (else new views of one buffer).  CPU tensors
    take the plain version."""
    dev = m0.device
    L = m0.shape[0]
    if cap0 < 0 or cap1 < 0:
        raise ValueError(f"stable_compact: caps {cap0}, {cap1}")
    if out is None:
        (idx0, count0), (idx1, count1) = _outputs(((1, cap0), (1, cap1)), dev)
    else:
        idx0, count0, idx1, count1 = out
    if dev.type == "cpu":
        for m, cap, pad, idx, count in ((m0, cap0, pad0, idx0, count0),
                                        (m1, cap1, pad1, idx1, count1)):
            got = stable_compact_plain(m[None, :], cap, pad)
            idx.copy_(got[0])
            count.copy_(got[1])
    else:
        if dev.type != "cuda":
            raise ValueError(f"stable_compact: tensors on {dev}")
        _check(m0.view(1, L), 1, L, idx0, count0, cap0)
        _check(m1.view(1, L), 1, L, idx1, count1, cap1)
        plan_for(dev.index, 2, L)(m0, cap0, pad0, idx0, count0,
                                  second=(m1, cap1, pad1, idx1, count1))
    return (idx0[0], count0[0]), (idx1[0], count1[0])


stable_compact.launches = 0
