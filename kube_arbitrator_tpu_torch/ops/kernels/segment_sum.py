"""K4 ``segment_sum``: ``out[idx[i]] += val[i]`` in slot order.

Replaces the reference's segment sums (ops/cycle.py:233-239, :265-266;
ops/fairness.py:178), keeping the slot-order contract of its host
kernels (ops/native/segsum.cc): per segment, the values are added one
after another in slot order from zero, with no float atomics, so a f32
result equals the sequential scatter bit for bit on every device.
Out-of-range indices are dropped.  With ``out=`` the adds continue from
``out``'s own rows in place (the reference's ``base.at[idx].add(val)``),
so a base plus several slot-order updates rounds exactly as the
sequential scatter does.

Three forms on the card, one launch each (csrc/segment_sum.cu):

* :func:`segment_sum` with ``order=`` (K19's :func:`segment_order` of
  ``idx``, held by callers that sum over one order many times:
  ``open_session``'s job and queue sums, preempt's victim panel,
  ``_reclaim_fast``'s per-node sums): the staged sums over that order;
* :func:`segment_sum` without ``order``: one cooperative launch that
  counts the segments, writes the order and sums over it (up to
  ``COUNT_MAX_SEGMENTS`` segments; past that K19's order, then the sums);
* :func:`ordered_sum`: one segment in row order, no order tensor at all.

:func:`count_order_plain` mirrors the order the cooperative launch
builds (tile counts, their prefixes, the per-warp ranks) for the CPU
tests.  CPU tensors take the plain versions.  The wrapper's workspace
(per device, grown as needed) is zeroed once: every launch leaves its
barrier word zero, and the port launches on one stream.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import build
from .build import I, P
from .stable_sort import segment_order  # K19: the slots sorted by segment

_T = {torch.float32: "f32", torch.int32: "i32"}
COUNT_TILE = 1024  # csrc/segment_sum.cu's TILE: slots a tile of the count route
COUNT_WARPS = 8  # csrc/segment_sum.cu's TW: warps of a tile, each ranking contiguous slots
COUNT_MAX_SEGMENTS = 6144  # csrc/segment_sum.cu's MAX_SEGMENTS
MAX_COLUMNS = 1024  # csrc/segment_sum.cu's MAX_COLUMNS
# C signatures of csrc/segment_sum.cu
SIGNATURES = {}
for _t in _T.values():
    # (val, perm, seg_start, n, nseg, C, accumulate, out, stream)
    SIGNATURES[f"kat_segment_sum_{_t}"] = (P, P, P, I, I, I, I, P, P)
    # (val, idx, n, nseg, C, accumulate, out, ws, ws_words, stream)
    SIGNATURES[f"kat_segment_sum_count_{_t}"] = (P, P, I, I, I, I, P, P, I, P)

_WORKSPACE: Dict[int, torch.Tensor] = {}


def count_workspace_words(n: int, num_segments: int) -> int:
    """int32 words of the count route's workspace: the barrier word, the
    segment starts and totals, the per-tile counts and perm."""
    ntiles = -(-n // COUNT_TILE)
    return 4 + 2 * num_segments + 1 + ntiles * num_segments + n


def _workspace(dev: torch.device, words: int) -> torch.Tensor:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < words:
        # zeroed once: every launch leaves its barrier word zero
        ws = torch.zeros(max(words, 2 * (0 if ws is None else ws.numel())), dtype=torch.int32,
                         device=dev)
        _WORKSPACE[key] = ws
    return ws


def _as_rows(val, idx, num_segments, out):
    if val.dtype not in _T:
        raise TypeError(f"segment_sum: dtype {val.dtype}, want float32 or int32")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] != val.shape[0]:
        raise ValueError("segment_sum: idx must be i32[T] matching val's rows")
    if out is not None and (out.dtype != val.dtype or out.shape[0] != num_segments
                            or out.shape[1:] != val.shape[1:] or not out.is_contiguous()):
        raise ValueError("segment_sum: out must be a contiguous [S, ...] of val's dtype")


def segment_sum_plain(val, idx, num_segments, out=None, order=None):
    """The plain version: the same runs, added rank by rank — step r adds
    every segment's r-th slot, and each segment appears once per step, so
    each segment's adds happen one after another in slot order."""
    squeeze = val.dim() == 1
    v = val[:, None] if squeeze else val
    perm, seg_start = segment_order(idx, num_segments) if order is None else order
    counts = (seg_start[1:] - seg_start[:-1])
    # segments by descending length: the ones active at step r are a prefix
    by_len = torch.sort(counts, descending=True, stable=True).indices
    lens = counts[by_len].tolist()
    starts = seg_start[:-1][by_len]
    if out is None:
        acc = torch.zeros((num_segments, v.shape[1]), dtype=v.dtype, device=v.device)
    else:
        acc = out[:, None] if squeeze else out
    n_act = len(lens)
    for r in range(lens[0] if lens else 0):
        while n_act and lens[n_act - 1] <= r:
            n_act -= 1
        segs = by_len[:n_act]
        acc[segs] = acc[segs] + v[perm[starts[:n_act] + r]]
    if out is not None:
        return out
    return acc[:, 0] if squeeze else acc


def count_order_plain(idx: torch.Tensor, num_segments: int):
    """The slot order the count route writes, built its way: per tile of
    ``COUNT_TILE`` slots each segment's count, the prefix of those counts
    over the tiles, the segment starts from the totals, and each slot's
    rank among its warp's slots of its segment plus the earlier warps'
    counts.  (perm i32[M] of the M in-range slots, seg_start i32[S+1]);
    it equals :func:`segment_order`'s for the in-range slots."""
    S, n = num_segments, idx.shape[0]
    keep = (idx >= 0) & (idx < S)
    key = torch.where(keep, idx, S).to(torch.int64)
    ntiles = -(-n // COUNT_TILE)
    tile = torch.arange(n, device=idx.device) // COUNT_TILE
    counts = torch.zeros((max(ntiles, 1), S + 1), dtype=torch.int64, device=idx.device)
    counts.index_put_((tile, key), torch.ones_like(key), accumulate=True)
    counts = counts[:ntiles, :S]
    prefix = torch.cumsum(counts, 0) - counts  # exclusive over the tiles
    totals = counts.sum(0)
    seg_start = torch.zeros(S + 1, dtype=torch.int64, device=idx.device)
    seg_start[1:] = torch.cumsum(totals, 0)
    # within a tile: warp w ranks its contiguous slots; earlier warps first
    sub = COUNT_TILE // COUNT_WARPS
    warp = torch.arange(n, device=idx.device) // sub  # global warp-chunk id
    nw = max(-(-n // sub), 1)
    wcount = torch.zeros((nw, S + 1), dtype=torch.int64, device=idx.device)
    wcount.index_put_((warp, key), torch.ones_like(key), accumulate=True)
    wcount = wcount[:, :S]
    # exclusive over the warps of the same tile
    wtile = torch.arange(nw, device=idx.device) // COUNT_WARPS
    wincl = torch.cumsum(wcount, 0)
    first = wtile * COUNT_WARPS  # the tile's first warp chunk
    before = torch.zeros_like(wcount)
    before[1:] = wincl[:-1]
    wexcl = before - torch.where(first[:, None] > 0, wincl[(first - 1).clamp(min=0)], 0)
    perm = torch.empty(int(keep.sum()), dtype=torch.int64, device=idx.device)
    for w in range(nw):  # the rank inside a warp chunk: slot order among equal keys
        lo, hi = w * sub, min(n, (w + 1) * sub)
        k = key[lo:hi]
        ok = k < S
        kk = k[ok]
        slots = torch.arange(lo, hi, device=idx.device)[ok]
        if kk.numel() == 0:
            continue
        order = torch.sort(kk, stable=True)
        ranks = torch.empty_like(kk)
        pos_sorted = torch.arange(kk.numel(), device=idx.device)
        run_first = torch.searchsorted(order.values, order.values, right=False)
        ranks[order.indices] = pos_sorted - run_first
        t = w // COUNT_WARPS
        pos = seg_start[kk] + prefix[t, kk] + wexcl[w, kk] + ranks
        perm[pos] = slots
    return perm.to(torch.int32), seg_start.to(torch.int32)


def _launch_ordered(v, perm, seg_start, n, num_segments, out, dst):
    build.check(build.bind("segment_sum", f"kat_segment_sum_{_T[v.dtype]}", SIGNATURES)(
        v.data_ptr(), build.ptr(perm), build.ptr(seg_start), n, num_segments, v.shape[1],
        int(out is not None), dst.data_ptr(), build.stream()), "segment_sum")
    build.launched(segment_sum)


def segment_sum(val: torch.Tensor, idx: torch.Tensor, num_segments: int,
                out: Optional[torch.Tensor] = None, order=None) -> torch.Tensor:
    """f32 or i32 ``val`` [T] or [T, C], i32 ``idx`` [T] -> [S] or [S, C]
    sums; with ``out`` the sums continue from ``out`` in place.  ``order``
    is :func:`segment_order` of ``idx``, when the caller holds it.  CPU
    tensors take the plain version; CUDA tensors launch the kernel once
    (twice past ``COUNT_MAX_SEGMENTS`` segments with no ``order``: K19's
    order first)."""
    _as_rows(val, idx, num_segments, out)
    if val.device.type == "cpu":
        return segment_sum_plain(val, idx, num_segments, out, order)
    dev = val.device
    if dev.type != "cuda" or idx.device != dev or (out is not None and out.device != dev):
        raise ValueError(f"segment_sum: tensors on {dev} / {idx.device}"
                         f" / {None if out is None else out.device}")
    squeeze = val.dim() == 1
    v = (val[:, None] if squeeze else val).contiguous()
    n, C = v.shape
    if C > MAX_COLUMNS:
        raise ValueError(f"segment_sum: {C} columns, at most {MAX_COLUMNS}")
    dst = torch.empty((num_segments, C), dtype=v.dtype, device=dev) if out is None else out
    if num_segments > 0:
        if order is None and num_segments <= COUNT_MAX_SEGMENTS:
            words = count_workspace_words(n, num_segments)
            ws = _workspace(dev, words)
            fn = build.bind("segment_sum", f"kat_segment_sum_count_{_T[v.dtype]}", SIGNATURES)
            build.check(fn(v.data_ptr(), idx.contiguous().data_ptr(), n, num_segments, C,
                           int(out is not None), dst.data_ptr(), ws.data_ptr(), words,
                           build.stream()), "segment_sum")
            build.launched(segment_sum)
        else:
            perm, seg_start = segment_order(idx, num_segments) if order is None else order
            if perm.dtype != torch.int32 or seg_start.dtype != torch.int32:
                perm, seg_start = perm.to(torch.int32), seg_start.to(torch.int32)
            _launch_ordered(v, perm.contiguous(), seg_start.contiguous(), n, num_segments, out,
                            dst)
    if out is not None:
        return out
    return dst[:, 0] if squeeze else dst


segment_sum.launches = 0


def ordered_sum(val: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in row order (one segment) — the order the port
    owns for every f32 reduction that feeds a decision.  On the card one
    launch over the identity order: no index, order or start tensor."""
    if val.device.type == "cpu":
        n = val.shape[0]
        idx = torch.zeros(n, dtype=torch.int32)
        order = (torch.arange(n, dtype=torch.int32), torch.tensor([0, n], dtype=torch.int32))
        return segment_sum_plain(val, idx, 1, order=order)[0]
    if val.dtype not in _T:
        raise TypeError(f"segment_sum: dtype {val.dtype}, want float32 or int32")
    squeeze = val.dim() == 1
    v = (val[:, None] if squeeze else val).contiguous()
    dst = torch.empty((1, v.shape[1]), dtype=v.dtype, device=v.device)
    _launch_ordered(v, None, None, v.shape[0], 1, None, dst)
    return dst[0, 0] if squeeze else dst[0]
