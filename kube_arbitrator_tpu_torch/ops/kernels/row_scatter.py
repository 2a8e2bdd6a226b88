"""K18 ``row_scatter``: an epoch's changed rows written in place into
resident buffers, ``dst[idx] = host[idx]`` for every changed field at
once.

Replaces the reference's ``_scatter_donated`` (cache/arena.py:156-159)
as ``_DeviceResident.update`` (:182-250) calls it, one field at a time.
Fields are bool, i32 or f32 tensors of rank 1 or 2; axis 0 is the row
axis.

:class:`RowScatterPlan` is owned by a ``DeviceResident`` for its device:
each field's resident buffer is bound once (:meth:`RowScatterPlan.place`,
again when the field is re-placed whole), and an epoch's call passes one
request per changed field to one C call, which checks the indices,
gathers the rows and i32 indices straight from the host arrays into the
plan's pinned staging buffer behind a descriptor table, copies it to the
card once and launches once.  The kernel stamps its epoch into a pinned
flag word as it starts, and the next call waits for that stamp before it
rewrites the pinned buffer.  The staging buffers grow by doubling and
are reused.  A plan's launches go to the stream current at its
construction; a call from another stream raises.  CUDA source:
csrc/row_scatter.cu.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import build
from .build import I, P

# C signatures of csrc/row_scatter.cu: (requests, request count, pinned,
# staging, capacity, flag, the flag's device pointer, last epoch, need,
# stream); (flag, out: its device pointer)
SIGNATURES = {"kat_row_scatter": (P, I, P, P, I, P, P, P, P, P),
              "kat_row_scatter_flag": (P, P)}
INDEX_ERROR = -1  # csrc/row_scatter.cu's KAT_INDEX_ERROR
NEED_BYTES = -2   # csrc/row_scatter.cu's KAT_NEED_BYTES

_NUMPY_OF = {torch.bool: np.dtype(np.bool_), torch.int32: np.dtype(np.int32),
             torch.float32: np.dtype(np.float32)}
_WIDE = {np.dtype(np.int32): 0, np.dtype(np.int64): 1}

# (name, host array, row indices) of one changed field
Change = Tuple[str, np.ndarray, np.ndarray]


class _Req(ctypes.Structure):
    """csrc/row_scatter.cu's Req: a placed field's request slot."""

    _fields_ = [("host", ctypes.c_void_p), ("rows", ctypes.c_void_p), ("dst", ctypes.c_ulonglong),
                ("n", ctypes.c_int), ("row_bytes", ctypes.c_int), ("rows_total", ctypes.c_int),
                ("rows_wide", ctypes.c_int)]


def _addr(a: np.ndarray) -> int:
    """The data pointer of a C-contiguous array (a writable one through
    ctypes' buffer view, the cheaper way)."""
    if a.flags.writeable:
        return ctypes.addressof(ctypes.c_byte.from_buffer(a))
    return a.ctypes.data


def grown(cap: int, need: int) -> int:
    """The staging capacity for an epoch of ``need`` bytes: kept while it
    fits, else doubled (or ``need``, if more)."""
    return cap if need <= cap else max(need, 2 * cap)


def row_scatter_plain(dsts: Sequence[torch.Tensor], idx: Sequence[np.ndarray],
                      rows: Sequence[np.ndarray]) -> None:
    """``dst[idx] = rows`` per field."""
    for d, i, r in zip(dsts, idx, rows):
        if len(i):
            d[torch.from_numpy(np.asarray(i, np.int64)).to(d.device)] = torch.from_numpy(
                np.ascontiguousarray(r)).to(d.device)


class RowScatterPlan:
    """K18's launches for one device's resident pack.

    :meth:`place` binds (or, after a field is re-placed whole, rebinds)
    a field's resident buffer: a contiguous rank-1 or rank-2 bool / i32 /
    f32 tensor on the plan's device; each placed field keeps a request
    slot (csrc/row_scatter.cu's Req) holding its buffer's pointer.  A
    call takes an epoch's changes, ``(name, host array, row indices)``
    per field (the host array of the buffer's shape and dtype, i32 or
    i64 indices in ``[0, rows)``), and writes ``buffer[rows] =
    host[rows]`` in place: on the card one C call (the gather into the
    pinned staging buffer, one host-to-device copy, one launch; none
    when no field has a row) with no allocation once the staging buffers
    fit; on the CPU the plain version.  Returns the bytes sent: each
    field's rows plus their i32 indices.  The call returns after
    enqueueing; the next one waits until this one's kernel has started
    (its copy out of the pinned buffer is then done) before it rewrites
    the pinned buffer.  That wait is for callers that do not synchronise
    between calls, as chip_smoke.py's timing loops: ``DeviceResident.update``
    synchronises after each epoch and so never waits there.  Every launch
    goes to the stream current at construction; a call from another
    stream raises, since the staging buffer serves one stream.
    ``launches`` counts the kernel's launches over every plan."""

    launches = 0

    def __init__(self, device):
        self.dev = torch.device(device)
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        # name -> (buffer, numpy dtype, shape, row bytes, request slot)
        self.fields: Dict[str, tuple] = {}
        self.cap = 0
        self.pinned = self.staging = None
        if self.dev.type == "cpu":
            return
        if self.dev.type != "cuda":
            raise ValueError(f"row_scatter: destinations on {self.dev}")
        self.fn = build.bind("row_scatter", "kat_row_scatter", SIGNATURES)
        self.stream = torch._C._cuda_getCurrentRawStream(self.dev.index)
        self.reqs = (_Req * 64)()
        self.flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)  # the started kernel's epoch
        self.flag_dev = ctypes.c_void_p()
        build.check(build.bind("row_scatter", "kat_row_scatter_flag", SIGNATURES)(
            self.flag.data_ptr(), ctypes.byref(self.flag_dev)), "row_scatter")
        self.last = ctypes.c_int(0)  # the last enqueued kernel's epoch (the C call advances it)
        self.need = ctypes.c_int(0)

    def place(self, name: str, buf: torch.Tensor) -> None:
        """Bind field ``name`` to its resident buffer ``buf``."""
        if buf.device != self.dev:
            raise ValueError(f"row_scatter: {name} on {buf.device}, want {self.dev}")
        if buf.dim() not in (1, 2) or not buf.is_contiguous():
            raise ValueError("row_scatter: a destination must be a contiguous rank-1 or rank-2 tensor")
        dt = _NUMPY_OF.get(buf.dtype)
        if dt is None:
            raise TypeError(f"row_scatter: a {buf.dtype} buffer")
        row_bytes = dt.itemsize * (buf.shape[1] if buf.dim() == 2 else 1)
        slot = self.fields[name][4] if name in self.fields else len(self.fields)
        self.fields[name] = (buf, dt, tuple(buf.shape), row_bytes, slot)
        if self.dev.type == "cpu":
            return
        if slot == len(self.reqs):
            reqs = (_Req * (2 * slot))()
            ctypes.memmove(reqs, self.reqs, ctypes.sizeof(self.reqs))
            self.reqs = reqs
        q = self.reqs[slot]
        q.dst, q.n, q.row_bytes, q.rows_total = buf.data_ptr(), 0, row_bytes, buf.shape[0]

    def __call__(self, changes: Sequence[Change]) -> int:
        todo, sent = [], 0
        for name, host, rows in changes:
            buf, dt, shape, rb, slot = self.fields[name]
            if host.dtype != dt:
                raise TypeError(f"row_scatter: {name}: rows of {host.dtype} into a {buf.dtype} buffer")
            if host.shape != shape or rows.ndim != 1 or rows.dtype not in _WIDE:
                raise ValueError(f"row_scatter: {name}: a host array of {host.shape} and "
                                 f"{rows.dtype} indices of {rows.shape} for a buffer of {shape}")
            sent += len(rows) * (rb + 4)
            if len(rows) and rb:
                todo.append((buf, host, rows, slot))
        if self.dev.type == "cpu":
            for buf, host, rows, _ in todo:
                if (rows < 0).any() or (rows >= len(host)).any():
                    raise IndexError(f"row_scatter: an index outside [0, {len(host)})")
            row_scatter_plain([t[0] for t in todo], [t[2] for t in todo],
                              [np.take(t[1], t[2], axis=0) for t in todo])
            return sent
        if not todo:
            return sent
        if torch._C._cuda_getCurrentRawStream(self.dev.index) != self.stream:
            raise RuntimeError("row_scatter: a call from another stream than the plan's; its "
                               "staging buffer serves one stream")
        for f, (_, host, rows, slot) in enumerate(todo):
            if not host.flags.c_contiguous:
                host = np.ascontiguousarray(host)
            if not rows.flags.c_contiguous:
                rows = np.ascontiguousarray(rows)
            todo[f] = (host, rows)  # alive through the C call
            q = self.reqs[slot]
            q.host, q.rows, q.n, q.rows_wide = _addr(host), _addr(rows), len(rows), _WIDE[rows.dtype]
        while True:
            rc = self.fn(self.reqs, len(self.fields),
                         self.pinned.data_ptr() if self.cap else 0,
                         self.staging.data_ptr() if self.cap else 0, self.cap,
                         self.flag.data_ptr(), self.flag_dev, ctypes.byref(self.last),
                         ctypes.byref(self.need), self.stream)
            if rc != NEED_BYTES:
                break
            # the C call waited for the last launch's copy: the old buffers are free
            self.cap = grown(self.cap, self.need.value)
            self.pinned = torch.empty(self.cap, dtype=torch.uint8, pin_memory=True)
            self.staging = torch.empty(self.cap, dtype=torch.uint8, device=self.dev)
        if rc == INDEX_ERROR:
            raise IndexError("row_scatter: an index outside its field's rows")
        build.check(rc, "row_scatter")
        build.launched(RowScatterPlan)
        return sent
