"""K3 ``decode_deferred``: per-(group, node) counts -> task placements.

Replaces ops/allocate.py:_decode_deferred (:1059-1131).  The task of rank
r in its group (uid order, less what earlier actions placed) goes to the
first node whose inclusive count along the group's ``gn_a`` row exceeds
r; tasks that miss take rank ``r - total_a`` into ``gn_p`` and become
PIPELINED.  Integer-exact.  CUDA source: csrc/decode_deferred.cu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...api.types import TaskStatus
from . import build
from .build import I, P

ALLOCATED = int(TaskStatus.ALLOCATED)
PIPELINED = int(TaskStatus.PIPELINED)

# C signature of csrc/decode_deferred.cu
SIGNATURES = {
    "kat_decode_deferred": (
        P, P, I, I, P, P, P, P, P, P, P, P, I, P, P, I, I, P,
    ),
}


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
    """The same lookup as one searchsorted into the flattened inclusive
    cumsum of the count matrix (rows are contiguous in it)."""
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


def decode_deferred(
    gn_a: torch.Tensor,
    gn_p: Optional[torch.Tensor],
    task_group: torch.Tensor,
    task_group_rank: torch.Tensor,
    task_valid: torch.Tensor,
    entry_placed: torch.Tensor,
    task_status: torch.Tensor,
    task_node: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """i32 gn_a [G, N] (gn_p the same, or None when nothing can pipeline),
    the pack's task_group / task_group_rank / task_valid, i32 entry_placed
    [G], the current task_status / task_node -> the new (status, node).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if gn_a.device.type == "cpu":
        return decode_deferred_plain(
            gn_a, gn_p, task_group, task_group_rank, task_valid, entry_placed,
            task_status, task_node,
        )
    dev = gn_a.device
    if dev.type != "cuda":
        raise ValueError(f"decode_deferred: tensors on {dev}")
    G, N = gn_a.shape
    T = task_group.shape[0]
    for t, dt, name in (
        (gn_a, torch.int32, "gn_a"), (task_group, torch.int32, "task_group"),
        (task_group_rank, torch.int32, "task_group_rank"),
        (task_valid, torch.bool, "task_valid"), (entry_placed, torch.int32, "entry_placed"),
        (task_status, torch.int32, "task_status"), (task_node, torch.int32, "task_node"),
    ):
        build.require(t, dt, f"decode_deferred.{name}", dev)
    if gn_p is not None:
        build.require(gn_p, torch.int32, "decode_deferred.gn_p", dev)
        if gn_p.shape != gn_a.shape:
            raise ValueError("decode_deferred: gn_p must match gn_a")
    scan_a = torch.empty_like(gn_a)
    scan_p = None if gn_p is None else torch.empty_like(gn_p)
    status = torch.empty_like(task_status)
    node = torch.empty_like(task_node)
    fn = build.bind("decode_deferred", "kat_decode_deferred", SIGNATURES)
    build.check(fn(
        build.ptr(gn_a), build.ptr(gn_p), G, N, build.ptr(scan_a), build.ptr(scan_p),
        build.ptr(task_group), build.ptr(task_group_rank), build.ptr(task_valid),
        build.ptr(entry_placed), build.ptr(task_status), build.ptr(task_node), T,
        build.ptr(status), build.ptr(node), ALLOCATED, PIPELINED, build.stream(),
    ), "decode_deferred")
    decode_deferred.launches += 1
    return status, node


decode_deferred.launches = 0
