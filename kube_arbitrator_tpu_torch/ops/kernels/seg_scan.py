"""K5 ``seg_scan``: the masked segment-local inclusive scan of
``[mask | mask * vals]`` in a sorted order, scattered back to the
unsorted positions.

Replaces the reference's ``SortLayout.rank_and_cum`` (ops/preempt.py:
129-168) and ``seg_cumsum`` (ops/common.py:74-99) as the reclaim canon
seed calls it (:2222-2243).  Position ``s`` of the sorted order reads
``mask[order[s]]`` and ``vals[s]`` (``vals`` is already in sorted order);
the running count and sums reset where ``seg_start[s]`` is set (and at
position 0).  Outputs, at ``order[s]``: the EXCLUSIVE masked count as
i32 and the INCLUSIVE masked sums as f32.

One order of float adds: serial within a segment, in sorted order, from
zero — the order of the reference's native ``kat_seg_cumsum_f32``
(ops/native/segsum.cc).  The jnp path of the reference associates the
same adds as a log-depth tree; at integer-valued inputs below 2^24 both
give the same bits.  CUDA source: csrc/seg_scan.cu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .build import I, P

MAX_COLS = 8  # value columns a thread keeps in registers

# C signature of csrc/seg_scan.cu
SIGNATURES = {"kat_seg_scan": (P, P, P, P, I, I, P, P, P)}


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


def seg_scan(
    mask: torch.Tensor,               # bool[P], in unsorted positions
    order: Optional[torch.Tensor],    # i32[P] sorted position -> unsorted (None: identity)
    seg_start: torch.Tensor,          # bool[P], sorted positions
    vals: torch.Tensor,               # f32[P, C], sorted positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (exclusive masked count i32[P], inclusive masked sums f32[P, C]),
    both at unsorted positions.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    Pn = mask.shape[0]
    if vals.dim() != 2 or vals.shape[0] != Pn or seg_start.shape != (Pn,):
        raise ValueError("seg_scan: mask bool[P], seg_start bool[P], vals f32[P, C]")
    if order is not None and (order.shape != (Pn,) or order.dtype != torch.int32):
        raise ValueError("seg_scan: order must be i32[P]")
    if mask.device.type == "cpu":
        return seg_scan_plain(mask, order, seg_start, vals)
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError(f"seg_scan: tensors on {dev}")
    C = vals.shape[1]
    if C > MAX_COLS:
        raise ValueError(f"seg_scan: {C} value columns, at most {MAX_COLS}")
    for t, dt, name in ((mask, torch.bool, "mask"), (seg_start, torch.bool, "seg_start"),
                        (vals, torch.float32, "vals")):
        build.require(t, dt, f"seg_scan.{name}", dev)
    if order is not None:
        build.require(order, torch.int32, "seg_scan.order", dev)
    rank = torch.empty(Pn, dtype=torch.int32, device=dev)
    cum = torch.empty((Pn, C), dtype=torch.float32, device=dev)
    fn = build.bind("seg_scan", "kat_seg_scan", SIGNATURES)
    build.check(fn(build.ptr(mask), build.ptr(order), build.ptr(seg_start), build.ptr(vals),
                   Pn, C, build.ptr(rank), build.ptr(cum), build.stream()), "seg_scan")
    seg_scan.launches += 1
    return rank, cum


seg_scan.launches = 0
