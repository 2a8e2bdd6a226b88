"""K3 ``decode_deferred``: per-(group, node) counts -> task placements.

Replaces ops/allocate.py:_decode_deferred (:1059-1131) and its gate
(:1254-1257).  The task of rank r in its group (uid order, less what
earlier actions placed) goes to the first node whose inclusive count
along the group's ``gn_a`` row exceeds r; tasks that miss take rank
``r - total_a`` into ``gn_p`` and become PIPELINED.  Nothing is decoded
unless ``any_a | any_p``; the pipelined lookup runs only when ``any_p``
is set and there is a ``gn_p`` (backfill has none).  Integer-exact.

:class:`DecodePlan` binds one batched allocate action's decode once and
writes status and node in place; a launch passes only the two device
flags, so the caller reads nothing on the host.  CUDA source:
csrc/decode_deferred.cu (one cooperative launch: a warp a block of
BLOCK chunks of a row writes their sums, then a thread a task finds its
block, its chunk and its node; :func:`decode_two_level_plain` mirrors
that lookup at the chunk level).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...api.types import TaskStatus
from . import build
from .build import P

ALLOCATED = int(TaskStatus.ALLOCATED)
PIPELINED = int(TaskStatus.PIPELINED)
CHUNK = 32  # cells a chunk of the kernel's lookup (csrc's CHUNK)
BLOCK = 32  # chunks a block, one warp's item in the kernel's first phase (csrc's BLOCK)

# C signature of csrc/decode_deferred.cu: (static, call, stream)
SIGNATURES = {"kat_decode_deferred": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/decode_deferred.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "gn_a", "gn_p", "csum", "bsum", "ticket", "task_group", "task_group_rank", "task_valid",
        "entry_placed", "status", "node",
    )] + [(n, ctypes.c_int) for n in ("G", "N", "NB", "T", "vec", "allocated", "pipelined")]


class _Call(ctypes.Structure):
    """csrc/decode_deferred.cu's Call: a launch's own arguments, set in place."""

    _fields_ = [("any_a", ctypes.c_void_p), ("any_p", ctypes.c_void_p)]


def decode_deferred_plain(
    gn_a: torch.Tensor,
    gn_p: Optional[torch.Tensor],
    task_group: torch.Tensor,
    task_group_rank: torch.Tensor,
    task_valid: torch.Tensor,
    entry_placed: torch.Tensor,
    task_status: torch.Tensor,
    task_node: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lookup ungated (``gn_p`` None: no pipelined pass), as one
    searchsorted into the flattened inclusive cumsum of the count matrix
    (rows are contiguous in it)."""
    N = gn_a.shape[1]
    gq = task_group.clamp(min=0).to(torch.int64)
    in_group = (task_group >= 0) & task_valid
    r0 = task_group_rank - entry_placed[gq]

    def lookup(gn, rank, base_mask):
        flat = torch.cumsum(gn.reshape(-1).to(torch.int64), 0)
        row_end = flat[gq * N + N - 1]
        base = torch.where(gq > 0, flat[(gq * N - 1).clamp(min=0)], 0)
        total = (row_end - base).to(torch.int32)
        hit = base_mask & (rank >= 0) & (rank < total)
        pos = torch.searchsorted(flat, base + rank.to(torch.int64), right=True)
        node = (pos.clamp(max=flat.shape[0] - 1) - gq * N).to(torch.int32)
        return hit, node, total

    in_a, node_a, total_a = lookup(gn_a, r0, in_group)
    status = torch.where(in_a, ALLOCATED, task_status)
    node = torch.where(in_a, node_a, task_node)
    if gn_p is not None:
        in_p, node_p, _ = lookup(gn_p, r0 - total_a, in_group & ~in_a)
        status = torch.where(in_p, PIPELINED, status)
        node = torch.where(in_p, node_p, node)
    return status.to(torch.int32), node.to(torch.int32)


def decode_two_level_plain(gn_a, gn_p, task_group, task_group_rank, task_valid, entry_placed,
                           task_status, task_node, chunk: int = CHUNK, block: int = BLOCK):
    """The kernel's lookup op for op, ungated like
    :func:`decode_deferred_plain`: each row cut into ``chunk``-cell
    chunks and ``block``-chunk blocks (padded with zeros), the block sums
    giving the row's total and the block holding the rank, that block's
    chunk sums the chunk, and the walk inside the chunk the node."""
    G, N = gn_a.shape
    NB = -(-N // (chunk * block))
    gq = task_group.clamp(min=0, max=max(G - 1, 0)).to(torch.int64)
    in_group = (task_group >= 0) & task_valid
    r0 = (task_group_rank - entry_placed[gq]).to(torch.int64)

    def lookup(gn, rank, base_mask):
        cells = torch.nn.functional.pad(gn.to(torch.int64), (0, NB * block * chunk - N))
        cells = cells.reshape(G, NB, block, chunk)
        csum = cells.sum(dim=3)                                   # [G, NB, block]
        bpre = csum.sum(dim=2).cumsum(dim=1)                      # [G, NB] inclusive
        total = bpre[:, -1][gq] if NB else torch.zeros_like(rank)
        hit = base_mask & (rank >= 0) & (rank < total)
        if NB == 0:
            return hit, torch.zeros_like(rank, dtype=torch.int32), total
        r = torch.where(hit, rank, 0)
        b = torch.searchsorted(bpre[gq], r[:, None], right=True)[:, 0].clamp(max=NB - 1)
        before = torch.where(b > 0, bpre[gq, (b - 1).clamp(min=0)], 0)
        cpre = csum[gq, b].cumsum(dim=1)                          # [T, block]
        k = (cpre <= (r - before)[:, None]).sum(dim=1).clamp(max=block - 1)
        before = before + torch.where(k > 0, cpre.gather(1, (k - 1).clamp(min=0)[:, None])[:, 0],
                                      0)
        walked = (cells[gq, b, k].cumsum(dim=1) <= (r - before)[:, None]).sum(dim=1)
        return hit, ((b * block + k) * chunk + walked).to(torch.int32), total

    in_a, node_a, total_a = lookup(gn_a, r0, in_group)
    status = torch.where(in_a, ALLOCATED, task_status)
    node = torch.where(in_a, node_a, task_node)
    if gn_p is not None:
        in_p, node_p, _ = lookup(gn_p, r0 - total_a, in_group & ~in_a)
        status = torch.where(in_p, PIPELINED, status)
        node = torch.where(in_p, node_p, node)
    return status.to(torch.int32), node.to(torch.int32)


class DecodePlan:
    """K3's launch over one batched allocate action.

    Built once where the action's round loop starts: it checks the
    dtypes and shapes once and binds the counts ``gn_a`` (and ``gn_p``,
    None for backfill), the pack's ``task_group`` / ``task_group_rank``
    / ``task_valid``, the action's ``entry_placed`` and the state's
    ``task_status`` / ``task_node``, which a launch updates IN PLACE; it
    owns its chunk- and block-sum scratch and barrier word and keeps
    the stream current when it was built.  The counts must be filled in place
    before the launch.  A launch passes the round loop's ``any_a`` /
    ``any_p`` (bool device scalars): with neither set it leaves status
    and node as they are, and it reads ``gn_p`` only when ``any_p`` is
    set.  CPU tensors take the plain version, gated on the host, into
    the same tensors.  ``launches`` counts the kernel's launches over
    every plan."""

    launches = 0

    def __init__(self, gn_a, gn_p, task_group, task_group_rank, task_valid, entry_placed,
                 task_status, task_node):
        dev = gn_a.device
        self.dev = dev
        self.args = (gn_a, gn_p, task_group, task_group_rank, task_valid, entry_placed)
        self.status, self.node = task_status, task_node
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"decode_deferred: tensors on {dev}")
        G, N = gn_a.shape
        T = task_group.shape[0]
        checks = [
            (gn_a, torch.int32, (G, N)), (gn_p, torch.int32, (G, N)),
            (task_group, torch.int32, (T,)), (task_group_rank, torch.int32, (T,)),
            (task_valid, torch.bool, (T,)), (entry_placed, torch.int32, (G,)),
            (task_status, torch.int32, (T,)), (task_node, torch.int32, (T,)),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            if t is None:
                continue
            build.require(t, dt, f"decode_deferred.arg{i}", dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"decode_deferred.arg{i}: shape {tuple(t.shape)}, want {shape}")
        if G == 0:
            raise ValueError("decode_deferred: no groups")
        NB = -(-N // (BLOCK * CHUNK))
        mats = 1 if gn_p is None else 2
        self.csum = torch.empty((mats, G, NB * BLOCK), dtype=torch.int32, device=dev)
        self.bsum = torch.empty((mats, G, NB), dtype=torch.int32, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        vec = N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (gn_a, gn_p) if t is not None)
        p = build.ptr
        self.static = _Static(p(gn_a), p(gn_p), p(self.csum), p(self.bsum), p(self.ticket),
                              p(task_group), p(task_group_rank), p(task_valid), p(entry_placed),
                              p(task_status), p(task_node), G, N, NB, T, int(vec), ALLOCATED,
                              PIPELINED)
        self.static_ptr = ctypes.addressof(self.static)
        self.call = _Call()
        self.call_ptr = ctypes.addressof(self.call)
        self.fn = build.bind("decode_deferred", "kat_decode_deferred", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, any_a: torch.Tensor, any_p: torch.Tensor) -> None:
        """Decode the counts into the bound status / node, in place."""
        if self.dev.type == "cpu":
            if not bool(any_a | any_p):
                return
            gn_a, gn_p, *rest = self.args
            status, node = decode_deferred_plain(gn_a, gn_p if bool(any_p) else None, *rest,
                                                 self.status, self.node)
            self.status.copy_(status)
            self.node.copy_(node)
            return
        if (any_a.dtype != torch.bool or any_p.dtype != torch.bool or not any_a.is_cuda
                or not any_p.is_cuda or any_a.numel() != 1 or any_p.numel() != 1):
            raise ValueError("decode_deferred: any_a and any_p must be one bool each on the card")
        self.call.any_a, self.call.any_p = any_a.data_ptr(), any_p.data_ptr()
        build.check(self.fn(self.static_ptr, self.call_ptr, self.stream), "decode_deferred")
        build.launched(DecodePlan)
