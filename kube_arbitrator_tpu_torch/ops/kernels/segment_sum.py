"""K4 ``segment_sum``: ``out[idx[i]] += val[i]`` in slot order.

Replaces the reference's segment sums (ops/cycle.py:233-239, :265-266;
ops/fairness.py:178), keeping the slot-order contract of its host
kernels (ops/native/segsum.cc): per segment, the values are added one
after another in slot order from zero, with no float atomics, so a f32
result equals the sequential scatter bit for bit on every device.
Out-of-range indices are dropped.  With ``out=`` the adds continue from
``out``'s own rows in place (the reference's ``base.at[idx].add(val)``),
so a base plus several slot-order updates rounds exactly as the
sequential scatter does.  CUDA source: csrc/segment_sum.cu.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .build import I, P
from .stable_sort import segment_order  # K19: the slots sorted by segment

_F = {torch.float32: "kat_segment_sum_f32", torch.int32: "kat_segment_sum_i32"}
# C signatures of csrc/segment_sum.cu
# (val, perm, seg_start, nseg, C, accumulate, out, stream)
SIGNATURES = {name: (P, P, P, I, I, I, P, P) for name in _F.values()}


def _as_rows(val, idx, num_segments, out):
    if val.dtype not in _F:
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


def segment_sum(val: torch.Tensor, idx: torch.Tensor, num_segments: int,
                out: Optional[torch.Tensor] = None, order=None) -> torch.Tensor:
    """f32 or i32 ``val`` [T] or [T, C], i32 ``idx`` [T] -> [S] or [S, C]
    sums; with ``out`` the sums continue from ``out`` in place.  ``order``
    is :func:`segment_order` of ``idx``, when the caller holds it.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _as_rows(val, idx, num_segments, out)
    if val.device.type == "cpu":
        return segment_sum_plain(val, idx, num_segments, out, order)
    if val.device.type != "cuda" or idx.device != val.device:
        raise ValueError(f"segment_sum: tensors on {val.device} / {idx.device}")
    squeeze = val.dim() == 1
    v = (val[:, None] if squeeze else val).contiguous()
    C = v.shape[1]
    perm, seg_start = segment_order(idx, num_segments) if order is None else order
    perm = perm.to(torch.int32)
    seg_start = seg_start.to(torch.int32)
    dst = torch.empty((num_segments, C), dtype=v.dtype, device=v.device) if out is None else out
    fn = build.bind("segment_sum", _F[v.dtype], SIGNATURES)
    build.check(fn(build.ptr(v), build.ptr(perm), build.ptr(seg_start),
                   num_segments, C, int(out is not None), build.ptr(dst),
                   build.stream()), "segment_sum")
    segment_sum.launches += 1
    if out is not None:
        return out
    return dst[:, 0] if squeeze else dst


segment_sum.launches = 0


def ordered_sum(val: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in row order (one segment) — the order the port
    owns for every f32 reduction that feeds a decision.  Every slot is in
    the one segment, so its order is the identity (no sort)."""
    n, dev = val.shape[0], val.device
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    order = (torch.arange(n, dtype=torch.int32, device=dev),
             torch.arange(2, dtype=torch.int32, device=dev) * n)
    return segment_sum(val, idx, 1, order=order)[0]
