"""K10 ``turn_fill``: one immediate-path turn's fill, node writeback and
task decode.

Replaces the second half of ops/allocate.py:_process_queue (:623-706) of
the reference: ``use_rel`` from the idle row's sum, the exact int32
prefix fill in packing order, ``p`` scattered back to node order into
node_idle / node_releasing / node_num_tasks / node_ports (in place), the
slot -> node map and the decode of the group's pending tasks by rank
(task_status / task_node, in place).  Returns the turn's placed count
and fallback flag on the device.  CUDA source: csrc/turn_fill.cu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...api.types import TaskStatus
from . import build
from .build import I, P

ALLOCATED = int(TaskStatus.ALLOCATED)
PIPELINED = int(TaskStatus.PIPELINED)

# C signature of csrc/turn_fill.cu
SIGNATURES = {
    "kat_turn_fill": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                      P, P, P),
}


def turn_fill_plain(st, k, nperm, g, req, budget, group_placed, node_idle, node_releasing,
                    node_ports, node_num_tasks, task_status, task_node, s_max, best_effort,
                    preds_on):
    """The plain version: the reference's fill and decode op for op,
    writing the node and task state in place."""
    N = k.shape[1]
    dev = k.device
    gi = g.reshape(-1)[:1].to(torch.int64)
    k_idle, k_rel = k[0], k[1]
    use_rel = (k_idle.sum() == 0) & (budget > 0)
    if best_effort:
        use_rel = torch.zeros_like(use_rel)
    k_eff = torch.where(use_rel, k_rel, k_idle)
    cum = torch.cumsum(k_eff, 0, dtype=torch.int32)
    placed_total = torch.minimum(budget, cum[-1:]).to(torch.int32)
    p_p = torch.minimum((placed_total - (cum - k_eff)).clamp(min=0), k_eff)
    if nperm is None:
        p = p_p
    else:
        p = torch.zeros_like(p_p).scatter_(0, nperm.to(torch.int64), p_p)
    pf = p.to(torch.float32)[:, None] * req[None, :]
    node_idle.copy_(torch.where(use_rel, node_idle, node_idle - pf))
    node_releasing.copy_(torch.where(use_rel, node_releasing - pf, node_releasing))
    if preds_on:
        gports = st.group_ports[gi][0]
        has_ports = (gports != 0).any()
        node_ports.copy_(torch.where(((p > 0) & has_ports)[:, None], node_ports | gports,
                                     node_ports))
    node_num_tasks.add_(p)
    slots = torch.arange(s_max, dtype=torch.int32, device=dev)
    node_of_slot = torch.searchsorted(cum, slots, right=True, out_int32=True)
    if nperm is not None:
        node_of_slot = nperm[node_of_slot.clamp(0, N - 1).to(torch.int64)]
    slot_of_task = st.task_group_rank - group_placed[gi]
    assigned = ((st.task_group == g.reshape(-1)[:1]) & (slot_of_task >= 0)
                & (slot_of_task < placed_total) & st.task_valid)
    tnode = node_of_slot[slot_of_task.clamp(0, s_max - 1).to(torch.int64)]
    new_status = torch.where(use_rel, PIPELINED, ALLOCATED).to(torch.int32)
    task_status.copy_(torch.where(assigned, new_status, task_status))
    task_node.copy_(torch.where(assigned, tnode, task_node))
    return placed_total, use_rel.reshape(1)


def turn_fill(
    st,
    k: torch.Tensor,               # i32[2, N] idle / releasing capacity, packing order
    nperm: Optional[torch.Tensor],  # i32[N] node at each position, or None
    g: torch.Tensor,               # i32/i64[1]
    req: torch.Tensor,             # f32[R]
    budget: torch.Tensor,          # i32[1]
    group_placed: torch.Tensor,    # i32[G] (read: the group's tasks placed before)
    node_idle: torch.Tensor,       # f32[N, R], updated in place
    node_releasing: torch.Tensor,  # f32[N, R], updated in place
    node_ports: torch.Tensor,      # i32[N, W], updated in place
    node_num_tasks: torch.Tensor,  # i32[N], updated in place
    task_status: torch.Tensor,     # i32[T], updated in place
    task_node: torch.Tensor,       # i32[T], updated in place
    s_max: int,
    best_effort: bool,
    preds_on: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (placed_total i32[1], use_rel bool[1]).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    args = (st, k, nperm, g, req, budget, group_placed, node_idle, node_releasing, node_ports,
            node_num_tasks, task_status, task_node, s_max, best_effort, preds_on)
    if k.device.type == "cpu":
        return turn_fill_plain(*args)
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"turn_fill: tensors on {dev}")
    N, R = node_idle.shape
    W = node_ports.shape[1]
    T = task_status.shape[0]
    g32 = g.reshape(-1)[:1].to(torch.int32).contiguous()
    checks = [
        (k, torch.int32), (req, torch.float32), (budget, torch.int32),
        (group_placed, torch.int32), (node_idle, torch.float32),
        (node_releasing, torch.float32), (node_ports, torch.int32),
        (node_num_tasks, torch.int32), (task_status, torch.int32), (task_node, torch.int32),
        (st.group_ports, torch.int32), (st.task_group, torch.int32),
        (st.task_group_rank, torch.int32), (st.task_valid, torch.bool),
    ] + ([(nperm, torch.int32)] if nperm is not None else [])
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"turn_fill.arg{i}", dev)
    if k.shape != (2, N) or req.shape != (R,) or budget.numel() != 1:
        raise ValueError("turn_fill: shapes disagree")
    node_of_slot = torch.empty(max(s_max, 1), dtype=torch.int32, device=dev)
    placed = torch.empty(1, dtype=torch.int32, device=dev)
    use_rel = torch.empty(1, dtype=torch.bool, device=dev)
    fn = build.bind("turn_fill", "kat_turn_fill", SIGNATURES)
    p = build.ptr
    build.check(fn(
        p(k), p(nperm), p(g32), p(req), p(budget), p(st.group_ports), p(group_placed),
        p(node_idle), p(node_releasing), p(node_ports), p(node_num_tasks), p(st.task_group),
        p(st.task_group_rank), p(st.task_valid), p(task_status), p(task_node), p(node_of_slot),
        N, R, W, T, s_max, int(best_effort), int(preds_on), p(placed), p(use_rel),
        build.stream(),
    ), "turn_fill")
    turn_fill.launches += 1
    return placed, use_rel


turn_fill.launches = 0
