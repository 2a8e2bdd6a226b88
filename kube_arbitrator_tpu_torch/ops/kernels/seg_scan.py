"""K5 ``seg_scan``: the masked segment-local inclusive scan of
``[mask | mask * vals]`` in a sorted order, scattered back to the
unsorted positions.

Replaces the reference's ``SortLayout.rank_and_cum`` (ops/preempt.py:
129-168) and ``seg_cumsum`` (ops/common.py:74-99).  Position ``s`` of the
sorted order reads ``mask[order[s]]`` and ``vals[s]`` (``vals`` is already
in sorted order); the running count and sums reset where ``seg_start[s]``
is set (and at position 0).  Outputs, at ``order[s]``: the EXCLUSIVE
masked count as i32 and the INCLUSIVE masked sums as f32.

One order of float adds: serial within a segment, in sorted order, from
+0.0, over the masked positions — the order of the reference's native
``kat_seg_cumsum_f32`` (ops/native/segsum.cc).  The jnp path of the
reference associates the same adds as a log-depth tree; at integer-valued
inputs below 2^24 both give the same bits.

:class:`SegScanPlan` binds one layout (``order``, ``seg_start``,
``vals``) once; a call passes only the mask.  :func:`seg_scan` is the same
through a plan of its own.  CUDA source: csrc/seg_scan.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .build import I, P

MAX_COLS = 8  # value columns (csrc/seg_scan.cu's MAXC)
TILE = 1024   # positions a tile (csrc/seg_scan.cu)
MODES = ("scan", "bind")  # csrc/seg_scan.cu's MODE_* values, in order

# C signatures of csrc/seg_scan.cu: (static, mask, mode, stream); (P, C) -> grid
SIGNATURES = {"kat_seg_scan": (P, P, I, P), "kat_seg_scan_grid": (I, I)}


class _Static(ctypes.Structure):
    """csrc/seg_scan.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "order", "vals", "seg_of", "seg_first", "base_pos", "excl", "pos_m", "comp", "tile_tot",
        "ctl", "rank_out", "cum_out")] + [(n, ctypes.c_int) for n in ("P", "C", "ntiles", "grid")]


def _serial_runs(x: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """Inclusive sums of ``x`` [K, C] within runs (``run_start`` marks
    each run's first row), added one row after another in row order:
    step r advances every run by its r-th row."""
    K = x.shape[0]
    starts = torch.nonzero(run_start).reshape(-1)
    lens = torch.diff(starts, append=torch.tensor([K], device=x.device))
    by_len = torch.sort(lens, descending=True, stable=True).indices
    starts, lens = starts[by_len], lens[by_len].tolist()
    out = torch.empty_like(x)
    acc = torch.zeros((len(lens), x.shape[1]), dtype=x.dtype, device=x.device)
    n_act = len(lens)
    for r in range(lens[0] if lens else 0):
        while n_act and lens[n_act - 1] <= r:
            n_act -= 1
        pos = starts[:n_act] + r
        acc[:n_act] = acc[:n_act] + x[pos]
        out[pos] = acc[:n_act]
    return out


def seg_scan_plain(mask, order, seg_start, vals) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version.  The count is an integer scan (exact in any
    order).  The sums add only the masked positions, serially within a
    segment in sorted order — the positions left out would add +0.0,
    which changes no bits — and every position takes the running sum of
    its segment's last masked position at or before it."""
    Pn, C = vals.shape
    dev = vals.device
    out_rank = torch.empty(Pn, dtype=torch.int32, device=dev)
    out_cum = torch.empty((Pn, C), dtype=torch.float32, device=dev)
    if Pn == 0:
        return out_rank, out_cum
    m_s = mask if order is None else mask[order.to(torch.int64)]
    start = seg_start.clone()
    start[0] = True
    seg_id = torch.cumsum(start.to(torch.int64), 0) - 1
    mi = m_s.to(torch.int64)
    incl = torch.cumsum(mi, 0)
    first = torch.nonzero(start).reshape(-1)
    base = (incl - mi)[first][seg_id]  # masked count before the segment
    rank_s = (incl - mi - base).to(torch.int32)
    pos_m = torch.nonzero(m_s).reshape(-1)
    sid = seg_id[pos_m]
    run_start = torch.ones_like(sid, dtype=torch.bool)
    run_start[1:] = sid[1:] != sid[:-1]
    comp = _serial_runs(vals[pos_m].to(torch.float32), run_start)
    if comp.shape[0]:
        last = (incl - 1).clamp(0, comp.shape[0] - 1)  # last masked position so far
        cum_s = torch.where((incl - base > 0)[:, None], comp[last], 0.0)
    else:
        cum_s = torch.zeros((Pn, C), dtype=torch.float32, device=dev)
    if order is None:
        return rank_s, cum_s
    dst = order.to(torch.int64)
    out_rank[dst] = rank_s
    out_cum[dst] = cum_s
    return out_rank, out_cum


def segment_table_plain(seg_start: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seg_of i32[P]: each position's segment, base_pos i32[P]: its
    segment's first position) of ``seg_start`` (position 0 starts a
    segment whatever it holds)."""
    start = seg_start.clone()
    if start.shape[0]:
        start[0] = True
    seg_of = torch.cumsum(start.to(torch.int64), 0) - 1
    first = torch.nonzero(start).reshape(-1)
    return seg_of.to(torch.int32), first[seg_of].to(torch.int32)


class SegScanPlan:
    """K5's launches over one layout: the sorted order ``order`` (i32[P]
    sorted position -> unsorted, None: the identity), ``seg_start``
    bool[P] and ``vals`` f32[P, C], all fixed for the plan's life.

    Built once (``SortLayout.plan``, at a layout's first scan): it checks
    those tensors once, allocates the segment table, the workspace and the
    outputs, and derives the table in one launch (the kernel's bind mode:
    each position's segment, each segment's first position, each
    position's segment base ``base_pos``).  A call passes the mask
    bool[P] (unsorted positions) and launches once: one device event, no
    allocation, no torch op.  Its (rank, cum) are the plan's own tensors,
    OVERWRITTEN by the next call: a caller consumes them first (two
    results alive at once come from two layouts, hence two plans).  CPU
    tensors take the plain version, into the same owned outputs."""

    def __init__(self, order: Optional[torch.Tensor], seg_start: torch.Tensor,
                 vals: torch.Tensor):
        Pn = seg_start.shape[0]
        if vals.dim() != 2 or vals.shape[0] != Pn or seg_start.shape != (Pn,):
            raise ValueError("seg_scan: seg_start bool[P], vals f32[P, C]")
        if order is not None and (order.shape != (Pn,) or order.dtype != torch.int32):
            raise ValueError("seg_scan: order must be i32[P]")
        C = vals.shape[1]
        dev = seg_start.device
        self.order, self.seg_start, self.vals, self.dev = order, seg_start, vals, dev
        self.first = True
        self.rank = torch.empty(Pn, dtype=torch.int32, device=dev)
        self.cum = torch.empty((Pn, C), dtype=torch.float32, device=dev)
        if dev.type == "cpu":
            self.seg_of, self.base_pos = segment_table_plain(seg_start)
            return
        if dev.type != "cuda":
            raise ValueError(f"seg_scan: tensors on {dev}")
        if not 1 <= C <= MAX_COLS:
            raise ValueError(f"seg_scan: {C} value columns, 1 to {MAX_COLS}")
        build.require(seg_start, torch.bool, "seg_scan.seg_start", dev)
        build.require(vals, torch.float32, "seg_scan.vals", dev)
        if order is not None:
            build.require(order, torch.int32, "seg_scan.order", dev)
        self.fn = build.bind("seg_scan", "kat_seg_scan", SIGNATURES)
        grid = build.bind("seg_scan", "kat_seg_scan_grid", SIGNATURES)(Pn, C)
        if Pn and grid < 1:
            raise ValueError(f"seg_scan: P = {Pn}, C = {C}: no cooperative grid holds it")
        ntiles = (Pn + TILE - 1) // TILE
        i32 = torch.int32
        ws = torch.empty(4 * Pn + 2 + ntiles + 1, dtype=i32, device=dev)
        ws[-1:].zero_()  # the barrier word: each launch leaves it zero
        self.seg_of, self.base_pos = ws[:Pn], ws[Pn:2 * Pn]
        seg_first, excl = ws[2 * Pn:3 * Pn + 1], ws[3 * Pn + 1:4 * Pn + 2]
        tile_tot, ctl = ws[4 * Pn + 2:4 * Pn + 2 + ntiles], ws[-1:]
        pos_m = torch.empty(Pn, dtype=i32, device=dev)
        comp = torch.empty((Pn, C), dtype=torch.float32, device=dev)
        self.ws = (ws, pos_m, comp)
        p = build.ptr
        self.static = _Static(p(order), p(vals), p(self.seg_of), p(seg_first), p(self.base_pos),
                              p(excl), p(pos_m), p(comp), p(tile_tot), p(ctl), p(self.rank),
                              p(self.cum), Pn, C, ntiles, grid)
        self.static_ptr = ctypes.addressof(self.static)
        self.stream = build.stream()
        build.check(self.fn(self.static_ptr, seg_start.data_ptr(), MODES.index("bind"),
                            self.stream), "seg_scan")
        _count("bind")

    def __call__(self, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (exclusive masked count i32[P], inclusive masked sums
        f32[P, C]) at the unsorted positions, for ``mask`` bool[P]."""
        if self.dev.type == "cpu":
            rank, cum = seg_scan_plain(mask, self.order, self.seg_start, self.vals)
            self.rank.copy_(rank)
            self.cum.copy_(cum)
            return self.rank, self.cum
        if self.first:
            build.require(mask, torch.bool, "seg_scan.mask", self.dev)
            if mask.shape != self.seg_start.shape:
                raise ValueError(f"seg_scan: mask {tuple(mask.shape)}, want "
                                 f"{tuple(self.seg_start.shape)}")
            self.first = False
        build.check(self.fn(self.static_ptr, mask.data_ptr(), 0, self.stream), "seg_scan")
        _count("scan")
        return self.rank, self.cum


def _count(variant: str) -> None:
    build.launched(seg_scan)
    seg_scan.variants[variant] += 1


def seg_scan(
    mask: torch.Tensor,               # bool[P], in unsorted positions
    order: Optional[torch.Tensor],    # i32[P] sorted position -> unsorted (None: identity)
    seg_start: torch.Tensor,          # bool[P], sorted positions
    vals: torch.Tensor,               # f32[P, C], sorted positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (exclusive masked count i32[P], inclusive masked sums f32[P, C]),
    both at unsorted positions, through a plan of its own (fresh
    outputs; two launches: the bind and the scan).  CPU tensors take the
    plain version."""
    if mask.shape != seg_start.shape:
        raise ValueError("seg_scan: mask bool[P] with seg_start's P")
    return SegScanPlan(order, seg_start, vals)(mask)


seg_scan.launches = 0
seg_scan.variants = dict.fromkeys(MODES, 0)
