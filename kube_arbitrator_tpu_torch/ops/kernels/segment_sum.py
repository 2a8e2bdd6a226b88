"""K4 ``segment_sum``: ``out[idx[i]] += val[i]`` in slot order.

Replaces the reference's segment sums (ops/cycle.py:233-239, :265-266;
ops/fairness.py:178), keeping the slot-order contract of its host
kernels (ops/native/segsum.cc): per segment, the values are added one
after another in slot order from zero, with no float atomics, so a f32
result equals the sequential scatter bit for bit on every device.
Out-of-range indices are dropped.  CUDA source: csrc/segment_sum.cu.
"""
from __future__ import annotations

import torch

from . import build
from .build import I, P

_F = {torch.float32: "kat_segment_sum_f32", torch.int32: "kat_segment_sum_i32"}
# C signatures of csrc/segment_sum.cu (val, perm, seg_start, nseg, C, out, stream)
SIGNATURES = {name: (P, P, P, I, I, P, P) for name in _F.values()}


def _order(idx: torch.Tensor, num_segments: int):
    """(perm, seg_start): slots stably sorted by segment, and the start of
    every segment's contiguous run (out-of-range slots sort last and fall
    outside every run)."""
    valid = (idx >= 0) & (idx < num_segments)
    key = torch.where(valid, idx.to(torch.int64), num_segments)
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=idx.device)
    seg_start = torch.searchsorted(sorted_key, bounds, right=False)
    return perm, seg_start


def segment_sum_plain(val: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The plain version: the same runs, added rank by rank — step r adds
    every segment's r-th slot, and each segment appears once per step, so
    each segment's adds happen one after another in slot order."""
    squeeze = val.dim() == 1
    v = val[:, None] if squeeze else val
    perm, seg_start = _order(idx, num_segments)
    counts = (seg_start[1:] - seg_start[:-1])
    # segments by descending length: the ones active at step r are a prefix
    by_len = torch.sort(counts, descending=True, stable=True).indices
    lens = counts[by_len].tolist()
    starts = seg_start[:-1][by_len]
    out = torch.zeros((num_segments, v.shape[1]), dtype=v.dtype, device=v.device)
    n_act = len(lens)
    for r in range(lens[0] if lens else 0):
        while n_act and lens[n_act - 1] <= r:
            n_act -= 1
        segs = by_len[:n_act]
        out[segs] = out[segs] + v[perm[starts[:n_act] + r]]
    return out[:, 0] if squeeze else out


def segment_sum(val: torch.Tensor, idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    """f32 or i32 ``val`` [T] or [T, C], i32 ``idx`` [T] -> [S] or [S, C]
    sums.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if val.dtype not in _F:
        raise TypeError(f"segment_sum: dtype {val.dtype}, want float32 or int32")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] != val.shape[0]:
        raise ValueError("segment_sum: idx must be i32[T] matching val's rows")
    if val.device.type == "cpu":
        return segment_sum_plain(val, idx, num_segments)
    if val.device.type != "cuda" or idx.device != val.device:
        raise ValueError(f"segment_sum: tensors on {val.device} / {idx.device}")
    squeeze = val.dim() == 1
    v = (val[:, None] if squeeze else val).contiguous()
    C = v.shape[1]
    perm, seg_start = _order(idx, num_segments)
    perm = perm.to(torch.int32)
    seg_start = seg_start.to(torch.int32)
    out = torch.empty((num_segments, C), dtype=v.dtype, device=v.device)
    fn = build.bind("segment_sum", _F[v.dtype], SIGNATURES)
    build.check(fn(build.ptr(v), build.ptr(perm), build.ptr(seg_start),
                   num_segments, C, build.ptr(out), build.stream()), "segment_sum")
    segment_sum.launches += 1
    return out[:, 0] if squeeze else out


segment_sum.launches = 0


def ordered_sum(val: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in row order (one segment) — the order the port
    owns for every f32 reduction that feeds a decision."""
    idx = torch.zeros(val.shape[0], dtype=torch.int32, device=val.device)
    return segment_sum(val, idx, 1)[0]
