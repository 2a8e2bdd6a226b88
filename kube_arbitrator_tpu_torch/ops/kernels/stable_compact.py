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
bool[K, L] or a :class:`FeasCells`.  CUDA source: csrc/stable_compact.cu
(two passes, no host read).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .build import I, P

EPS = DEVICE_EPSILON
BIG = 3.0e38
TILE = 2048  # csrc/stable_compact.cu's TILE (THREADS x PER_THREAD)

# C signature of csrc/stable_compact.cu
SIGNATURES = {
    "kat_stable_compact": (P, P, I, P, P, P, P, P, I, I, I, I, I, I, P, P, P, P),
}


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


def stable_compact(mask: Union[torch.Tensor, FeasCells], cap: int, pad: int):
    """-> (idx i32[K, cap], count i32[K]) for ``mask`` bool[K, L] or a
    :class:`FeasCells`.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    cells = mask if isinstance(mask, FeasCells) else None
    dev = mask.device
    if dev.type == "cpu":
        return stable_compact_plain(mask, cap, pad)
    if dev.type != "cuda":
        raise ValueError(f"stable_compact: tensors on {dev}")
    K, L = mask.shape
    if cap < 0 or K == 0:
        raise ValueError(f"stable_compact: cap {cap}, {K} rows")
    if cells is None:
        build.require(mask, torch.bool, "stable_compact.mask", dev)
        preds = (None, 0, None, None, None, None, None, 0, 0)
    else:
        checks = [(cells.class_fit, torch.bool), (cells.node_klass, torch.int32),
                  (cells.node_valid, torch.bool), (cells.node_unsched, torch.bool)]
        if cells.minreq is not None:
            checks += [(cells.minreq, torch.float32), (cells.basis, torch.float32)]
        for i, (t, dt) in enumerate(checks):
            build.require(t, dt, f"stable_compact.cells{i}", dev)
        R = 0 if cells.minreq is None else cells.minreq.shape[1]
        if cells.minreq is not None and (cells.minreq.shape[0] != K or cells.basis.shape != (L, R)):
            raise ValueError("stable_compact: minreq must be f32[K, R], basis f32[N, R]")
        preds = (cells.class_fit, cells.class_fit.shape[1], cells.node_klass, cells.node_valid,
                 cells.node_unsched, cells.minreq, cells.basis, R, int(cells.preds_on))
        mask = None
    ntiles = max(1, -(-max(L, cap) // TILE))
    tiles = torch.empty((K, ntiles), dtype=torch.int32, device=dev)
    idx = torch.empty((K, cap), dtype=torch.int32, device=dev)
    count = torch.empty(K, dtype=torch.int32, device=dev)
    fn = build.bind("stable_compact", "kat_stable_compact", SIGNATURES)
    class_fit, cn, klass, valid, unsched, minreq, basis, R, preds_on = preds
    build.check(fn(
        build.ptr(mask), build.ptr(class_fit), cn, build.ptr(klass), build.ptr(valid),
        build.ptr(unsched), build.ptr(minreq), build.ptr(basis), R, preds_on, K, L, cap, pad,
        build.ptr(tiles), build.ptr(idx), build.ptr(count), build.stream(),
    ), "stable_compact")
    stable_compact.launches += 1
    return idx, count


stable_compact.launches = 0
