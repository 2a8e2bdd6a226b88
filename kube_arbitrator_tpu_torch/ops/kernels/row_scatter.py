"""K18 ``row_scatter``: an epoch's changed rows written in place into
resident buffers, ``dst[idx] = rows`` for every changed field at once.

Replaces the reference's ``_scatter_donated`` (cache/arena.py:156-159)
as ``_DeviceResident.update`` (:182-250) calls it, one field at a time.
Fields are bool, i32 or f32 tensors of rank 1 or 2; axis 0 is the row
axis.  On the card the rows and indices of every field and a descriptor
table are packed into one pinned staging buffer, copied to the card in
one host-to-device copy and scattered by one launch.  Duplicate indices
must carry identical rows.  CUDA source: csrc/row_scatter.cu.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import build
from .build import I, P

THREADS = 256      # csrc/row_scatter.cu's THREADS
MAX_GRID_X = 4096  # blocks per field; each strides over the rest
ALIGN = 16

# C signature of csrc/row_scatter.cu
SIGNATURES = {"kat_row_scatter": (P, I, I, P)}

# csrc/row_scatter.cu's Desc
DESC = np.dtype([("dst", "<u8"), ("rows_off", "<u8"), ("idx_off", "<u8"),
                 ("nrows", "<i4"), ("row_bytes", "<i4")])
_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32,
             np.dtype(np.float32): torch.float32}

# (event, pinned staging, device staging) of launches whose copy may still
# be in flight: each staging pair is kept alive until its event completes
_INFLIGHT: List[tuple] = []


def _check(dsts, idx, rows) -> None:
    if not len(dsts) == len(idx) == len(rows):
        raise ValueError("row_scatter: dsts, idx and rows differ in length")
    for d, i, r in zip(dsts, idx, rows):
        if d.dim() not in (1, 2) or not d.is_contiguous():
            raise ValueError("row_scatter: a destination must be a contiguous rank-1 or rank-2 tensor")
        if _TORCH_OF.get(r.dtype) != d.dtype:
            raise TypeError(f"row_scatter: rows of {r.dtype} into a {d.dtype} buffer")
        if i.ndim != 1 or r.shape != (len(i),) + tuple(d.shape[1:]):
            raise ValueError(f"row_scatter: rows {r.shape} for {len(i)} indices into {tuple(d.shape)}")
        if len(i) and (int(i.min()) < 0 or int(i.max()) >= d.shape[0]):
            raise IndexError(f"row_scatter: an index outside [0, {d.shape[0]})")


def row_scatter_plain(dsts: Sequence[torch.Tensor], idx: Sequence[np.ndarray],
                      rows: Sequence[np.ndarray]) -> None:
    """``dst[idx] = rows`` per field."""
    for d, i, r in zip(dsts, idx, rows):
        if len(i):
            d[torch.from_numpy(np.asarray(i, np.int64)).to(d.device)] = torch.from_numpy(
                np.ascontiguousarray(r)).to(d.device)


def row_scatter(dsts: Sequence[torch.Tensor], idx: Sequence[np.ndarray],
                rows: Sequence[np.ndarray]) -> None:
    """Write host ``rows[f]`` (numpy, ``len(idx[f])`` rows of ``dsts[f]``'s
    row shape and dtype) at host row indices ``idx[f]`` of ``dsts[f]``, in
    place.  CPU destinations take the plain version; CUDA destinations
    one staging copy and one launch (none when no field has a row)."""
    _check(dsts, idx, rows)
    if not dsts:
        return
    dev = dsts[0].device
    if any(d.device != dev for d in dsts):
        raise ValueError("row_scatter: destinations on more than one device")
    if dev.type == "cpu":
        row_scatter_plain(dsts, idx, rows)
        return
    if dev.type != "cuda":
        raise ValueError(f"row_scatter: destinations on {dev}")
    fields = [(d, np.asarray(i, np.int32), np.ascontiguousarray(r))
              for d, i, r in zip(dsts, idx, rows) if len(i) and r.nbytes]
    if not fields:
        return

    def aligned(n: int) -> int:
        return -(-n // ALIGN) * ALIGN

    desc = np.zeros(len(fields), DESC)
    off = aligned(desc.nbytes)
    parts = []
    grid_x = 1
    for f, (d, i, r) in enumerate(fields):
        row_bytes = r.nbytes // len(i)
        desc[f] = (d.data_ptr(), off, aligned(off + r.nbytes), len(i), row_bytes)
        parts.append((off, r))
        off = aligned(off + r.nbytes)
        parts.append((off, i))
        off = aligned(off + i.nbytes)
        words = r.nbytes // 4 if row_bytes % 4 == 0 else r.nbytes
        grid_x = max(grid_x, min(MAX_GRID_X, -(-words // THREADS)))
    pinned = torch.empty(off, dtype=torch.uint8, pin_memory=True)
    host = pinned.numpy()
    host[:desc.nbytes] = desc.view(np.uint8)
    for o, a in parts:
        host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    staging = torch.empty(off, dtype=torch.uint8, device=dev)
    staging.copy_(pinned, non_blocking=True)
    fn = build.bind("row_scatter", "kat_row_scatter", SIGNATURES)
    build.check(fn(build.ptr(staging), len(fields), grid_x, build.stream()), "row_scatter")
    row_scatter.launches += 1
    done = torch.cuda.Event()
    done.record()
    _INFLIGHT[:] = [x for x in _INFLIGHT if not x[0].query()] + [(done, pinned, staging)]


row_scatter.launches = 0
