"""K20 ``ordered_scan``: the inclusive f32 prefix sum along axis 0 of a
[V, C] array in XLA:CPU's add order, in one launch; optionally of the
rows masked first.

Replaces ``mm_cumsum`` (kube_arbitrator_tpu/ops/common.py:102-137; on the
CPU ``jnp.cumsum``, which XLA computes as a recursive scan of 16-wide
blocks): blocks of SCAN_BLOCK summed left to right, the blocks' totals
scanned by the same recursion, then each element plus its block's
exclusive offset; n <= SCAN_BLOCK is one left-to-right chain.  Plain f32
adds only, so the card gives the CPU's bits.

:class:`OrderedScanPlan` binds one call site's launches once (its
output, the shapes, the stream and the look-back workspace): a launch
passes only its input, or, for a plan bound to fixed rows, the mask that
selects them (``where(mask, rows, 0)`` scanned, the masked rows kept in
``plan.masked``).  :func:`ordered_scan` (``ops/common.mm_cumsum``) is the
unmasked scan through a throwaway plan.  CPU tensors take the plain
version; CUDA tensors launch the kernel.  CUDA source:
csrc/ordered_scan.cu (a CTA a tile of 4,096 rows, the tiles joined by a
decoupled look-back).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .build import P

SCAN_BLOCK = 16  # csrc/ordered_scan.cu's BLOCK
TILE = SCAN_BLOCK ** 3  # rows a CTA scans through levels 0-2
COLS = 4  # columns a CTA stages, at most (csrc's COLS): C up to COLS, else one
MAX_ROWS = TILE * SCAN_BLOCK ** 2  # 1,048,576: the top level's two chains over the tiles

# C signature of csrc/ordered_scan.cu: (static, call, stream)
SIGNATURES = {"kat_ordered_scan": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/ordered_scan.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("out", "masked", "words", "ticket")] + [
        (n, ctypes.c_int) for n in ("V", "C", "tiles", "chunks", "levels")]


class _Call(ctypes.Structure):
    """csrc/ordered_scan.cu's Call: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "mask")] + [
        (n, ctypes.c_uint) for n in ("seq", "base")]


def ordered_scan_plain(v: torch.Tensor) -> torch.Tensor:
    """The same adds as elementwise torch ops, level by level."""
    n, c = v.shape
    B = SCAN_BLOCK
    if n == 0:
        return v
    if n <= B:
        cols = [v[0]]
        for i in range(1, n):
            cols.append(cols[-1] + v[i])
        return torch.stack(cols)
    nb = -(-n // B)
    vp = torch.cat([v, v.new_zeros((nb * B - n, c))]) if nb * B != n else v
    blocks = vp.reshape(nb, B, c)
    cols = [blocks[:, 0]]
    for i in range(1, B):
        cols.append(cols[-1] + blocks[:, i])
    inner = torch.stack(cols, dim=1)                           # [nb, B, c]
    outer = ordered_scan_plain(inner[:, -1].contiguous())      # inclusive over blocks
    excl = torch.cat([v.new_zeros((1, c)), outer[:-1]])
    return (inner + excl[:, None, :]).reshape(nb * B, c)[:n]


def masked_rows_plain(mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``where(mask, rows, 0)`` row by row: the masked plan's input."""
    return torch.where(mask[:, None], rows, 0.0)


def layout(V: int, C: int) -> dict:
    """The launch shape of a [V, C] scan: ``levels`` (0: V <= 16, one
    chain; 1 and 2: one tile whose top is a chain over its level-1 or
    level-2 values; 3: tiles of TILE rows joined by the look-back),
    ``tiles``, ``chunks`` (a CTA stages all C <= COLS columns, else one)
    and ``ctas``.  Raises past MAX_ROWS."""
    if V > MAX_ROWS:
        raise ValueError(f"ordered_scan: {V} rows, at most {MAX_ROWS} (16^5)")
    levels = 0 if V <= SCAN_BLOCK else 1 if V <= SCAN_BLOCK ** 2 else 2 if V <= TILE else 3
    tiles = -(-V // TILE) if levels == 3 else 1
    cc = C if C <= COLS else 1
    chunks = C // cc if C else 0
    return dict(levels=levels, tiles=tiles, chunks=chunks, ctas=tiles * chunks)


class OrderedScanPlan:
    """K20's launches at one call site, [V, C] f32.

    Built where the caller's loop starts (``_reclaim_fast`` binds one a
    call site per action: both scans of a turn are live together).  It
    checks the shapes once, owns its output ``out`` f32[V, C] (and, bound
    to fixed ``rows``, the masked rows ``masked``), a zeroed workspace of
    tile totals and the CTA ticket, and the stream current when it was
    built.  ``plan(x)`` scans ``x``; a plan bound to ``rows`` takes
    ``plan(mask=m)`` and scans ``where(m, rows, 0)``.  Either returns
    ``out``, OVERWRITTEN by the plan's next launch, as ``masked`` is: a
    caller that keeps one past it clones it.  Launches of one plan run in
    its stream's order (each takes the next launch number and the ticket
    from where the last one left it).  CPU tensors take the plain
    version, into the same owned tensors."""

    def __init__(self, V: int, C: int, device, rows: Optional[torch.Tensor] = None):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.V, self.C, self.dev = int(V), int(C), dev
        self.rows = rows
        if rows is not None:
            if rows.dtype != torch.float32 or tuple(rows.shape) != (V, C):
                raise TypeError(f"ordered_scan: rows must be f32[{V}, {C}]")
            if rows.device != dev:
                raise ValueError(f"ordered_scan: rows on {rows.device}, want {dev}")
        self.out = torch.empty((V, C), dtype=torch.float32, device=dev)
        self.masked = None if rows is None else torch.empty_like(self.out)
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"ordered_scan: tensors on {dev}")
        if rows is not None:
            build.require(rows, torch.float32, "ordered_scan.rows", dev)
        self.shape = layout(self.V, self.C)
        # three words a tile and column (its total, its level-2 value 14 and
        # level-1 value 255) and, last, the ticket: zeroed once, never reset
        ws = torch.zeros(self.shape["tiles"] * 3 * self.C + 1, dtype=torch.int64, device=dev)
        self.ws = ws
        self.static = _Static(
            self.out.data_ptr(), build.ptr(self.masked), ws.data_ptr(),
            ws.data_ptr() + 8 * (ws.numel() - 1),
            self.V, self.C, self.shape["tiles"], self.shape["chunks"], self.shape["levels"],
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.call = _Call(build.ptr(rows), 0, 0, 0)
        self.call_ptr = ctypes.addressof(self.call)
        self.fn = build.bind("ordered_scan", "kat_ordered_scan", SIGNATURES)
        self.stream = build.stream()
        self.first = True

    def __call__(self, x: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> ``out``: the scan of ``x`` f32[V, C], or of ``where(mask,
        rows, 0)`` for a plan bound to rows (``mask`` bool[V])."""
        if (self.rows is None) != (x is not None) or (self.rows is None) == (mask is not None):
            raise TypeError("ordered_scan: pass x to a plan without rows, mask to one with rows")
        if self.dev.type == "cpu":
            if self.rows is not None:
                self.masked.copy_(masked_rows_plain(mask, self.rows))
                x = self.masked
            self.out.copy_(ordered_scan_plain(x))
            return self.out
        c = self.call
        if self.first:  # the input keeps its type and shape at a call site
            t, dt, shape = (x, torch.float32, (self.V, self.C)) if x is not None else \
                (mask, torch.bool, (self.V,))
            build.require(t, dt, "ordered_scan.input", self.dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"ordered_scan: input {tuple(t.shape)}, want {shape}")
            self.first = False
        if x is not None:
            c.x = x.data_ptr()
        else:
            c.mask = mask.data_ptr()
        if self.V == 0 or self.C == 0:
            return self.out
        c.seq = c.seq % 0xFFFFFFFF + 1  # 1, 2, ..., never 0 (the zeroed words' number)
        build.check(self.fn(self.static_ptr, self.call_ptr, self.stream), "ordered_scan")
        c.base = (c.base + self.shape["ctas"]) & 0xFFFFFFFF
        build.launched(ordered_scan)
        return self.out


def ordered_scan(v: torch.Tensor) -> torch.Tensor:
    """f32 [V, C] -> its inclusive prefix sum along axis 0, [V, C] (a new
    tensor: through a throwaway plan on the card)."""
    if v.dtype != torch.float32 or v.dim() != 2:
        raise TypeError("ordered_scan: v must be f32[V, C]")
    if v.device.type == "cpu":
        return ordered_scan_plain(v)
    V, C = v.shape
    return OrderedScanPlan(V, C, v.device)(v.contiguous())


ordered_scan.launches = 0
