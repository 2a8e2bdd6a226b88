"""The scheduling cycle: open session -> allocate -> backfill -> commit
(the port of kube_arbitrator_tpu/ops/cycle.py:103-430).

Decisions are committed by masking: a job's new allocations produce bind
intents only if the job ends the cycle gang-ready.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from ..api.types import TaskStatus
from ..cache.snapshot import SnapshotTensors
from .allocate import AllocState, SessionCtx, allocate_action, backfill_action
from .common import fair, ordered_sum, safe_share, segment_sum
from .fairness import drf_equilibrium_levels_per_job, drf_shares, proportion_deserved
from .ordering import DEFAULT_ACTIONS, DEFAULT_TIERS, Tiers

ACTION_KERNELS = {
    "allocate": allocate_action,
    "backfill": backfill_action,
}
# actions of the reference this slice does not port yet
LATER_ACTIONS = {
    "preempt": "port slice 5 (ops/preempt.py)",
    "reclaim": "port slice 5 (ops/preempt.py)",
    "reclaim_optimistic": "port slice 5 (ops/preempt.py)",
}

_READY_STATUSES = (
    TaskStatus.ALLOCATED, TaskStatus.BINDING, TaskStatus.BOUND,
    TaskStatus.RUNNING, TaskStatus.SUCCEEDED, TaskStatus.PIPELINED,
)
_ALLOC_STATUSES = (
    TaskStatus.ALLOCATED, TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING,
)


@dataclasses.dataclass(frozen=True)
class CycleDecisions:
    """Output of one cycle, ready for host-side actuation (the reference's
    fields, same names and dtypes)."""

    task_node: torch.Tensor       # i32[T] assigned node ordinal (-1 none)
    task_status: torch.Tensor     # i32[T] end-of-cycle session status
    bind_mask: torch.Tensor       # bool[T] committed binds (gang-masked)
    evict_mask: torch.Tensor      # bool[T] committed evictions
    job_ready: torch.Tensor       # bool[J] gang readiness at close
    unready_alloc: torch.Tensor   # bool[T] allocated this cycle, uncommitted
    node_idle: torch.Tensor       # f32[N, R] end-of-cycle
    node_num_tasks: torch.Tensor  # i32[N]
    node_ports: torch.Tensor      # i32[N, W]
    evict_claimant: torch.Tensor  # i32[T]
    evict_phase: torch.Tensor     # i32[T]
    evict_round: torch.Tensor     # i32[T]
    queue_deserved: torch.Tensor  # f32[Q, R]
    queue_alloc: torch.Tensor     # f32[Q, R]
    bind_idx: torch.Tensor        # i32[B] bind task ordinals, -1 padded
    bind_node: torch.Tensor       # i32[B] node ordinal per slot
    evict_idx: torch.Tensor       # i32[E] evict task ordinals
    bind_count: torch.Tensor      # i32[] full bind population
    evict_count: torch.Tensor     # i32[] full evict population


def _plugin_enabled(tiers: Tiers, name: str) -> bool:
    return any(p.name == name for tier in tiers for p in tier.plugins)


def _status_in(status: torch.Tensor, members) -> torch.Tensor:
    m = torch.zeros_like(status, dtype=torch.bool)
    for s in members:
        m = m | (status == int(s))
    return m


def decode_caps(num_tasks: int) -> Tuple[int, int]:
    """(bind_cap, evict_cap): sizes of the compact decode lists for a
    T-task pack.  A first cycle over a large backlog binds more than T/2
    and overflows the bind list; the host then decodes the dense mask."""
    t = int(num_tasks)
    return min(t, max(1024, t // 2)), min(t, max(512, t // 8))


def _compact_indices(mask: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx i32[cap], count i32[]): the set ordinals of ``mask`` in
    ascending order, -1 padded; ``count`` is the full population."""
    T = mask.shape[0]
    mi = mask.to(torch.int32)
    pos = torch.cumsum(mi, 0, dtype=torch.int32) - 1
    count = mi.sum(dtype=torch.int32)
    write = mask & (pos < cap)
    idx = torch.full((cap + 1,), -1, dtype=torch.int32, device=mask.device)
    slot = torch.where(write, pos, cap).to(torch.int64)
    # only slot ``cap`` (dropped below) can receive more than one write
    idx.scatter_(0, slot, torch.arange(T, dtype=torch.int32, device=mask.device))
    return idx[:cap].contiguous(), count


def open_session(st: SnapshotTensors, tiers: Tiers) -> Tuple[SessionCtx, AllocState]:
    """OnSessionOpen equivalents: totals, water-fill, validity, initial
    aggregates.  Every sum goes through K4 in slot order."""
    J, Q = st.num_jobs, st.num_queues
    dev = st.device
    nv = st.node_valid[:, None]
    drf_total = ordered_sum(torch.where(nv, st.node_alloc, 0.0))
    prop_total = drf_total - st.others_used

    tv = st.task_valid
    alloc_now = _status_in(st.task_status, _ALLOC_STATUSES) & tv
    ready_now = _status_in(st.task_status, _READY_STATUSES) & tv
    pending_now = (st.task_status == int(TaskStatus.PENDING)) & tv
    valid_now = ready_now | pending_now

    def res_or_0(m):
        return torch.where(m[:, None], st.task_resreq, 0.0)

    tj = st.task_job
    job_alloc = segment_sum(res_or_0(alloc_now), tj, J)
    job_req = segment_sum(res_or_0(alloc_now | pending_now), tj, J)
    job_ready_cnt = segment_sum(ready_now.to(torch.int32), tj, J)
    job_valid_cnt = segment_sum(valid_now.to(torch.int32), tj, J)
    jv = st.job_valid[:, None]
    queue_alloc = segment_sum(torch.where(jv, job_alloc, 0.0), st.job_queue, Q)
    queue_req = segment_sum(torch.where(jv, job_req, 0.0), st.job_queue, Q)

    gang_ready_on = any(
        p.name == "gang" and not p.job_ready_disabled for t in tiers for p in t.plugins
    )
    if _plugin_enabled(tiers, "gang"):
        job_sched_valid = st.job_valid & (job_valid_cnt >= st.job_min_available)
    else:
        job_sched_valid = st.job_valid
    min_avail = st.job_min_available if gang_ready_on else torch.zeros(J, dtype=torch.int32, device=dev)

    if _plugin_enabled(tiers, "proportion"):
        deserved = proportion_deserved(st.queue_weight, queue_req, prop_total, st.queue_valid)
    else:
        deserved = torch.full((Q, st.task_resreq.shape[1]), 3.0e38, dtype=torch.float32, device=dev)

    job_pending_cnt = segment_sum(pending_now.to(torch.int32), tj, J)
    job_pending_req = segment_sum(res_or_0(pending_now), tj, J)
    mean_req = job_pending_req / job_pending_cnt.clamp(min=1)[:, None]
    job_share0 = drf_shares(job_alloc, drf_total)
    job_delta = safe_share(fair(mean_req), fair(drf_total)[None, :]).amax(dim=-1)
    headroom = ordered_sum(torch.where(nv, st.node_idle, 0.0))
    queue_headroom = fair(deserved) - fair(queue_alloc)
    drf_level = drf_equilibrium_levels_per_job(
        job_share0, job_delta, mean_req, job_pending_cnt,
        job_sched_valid & (job_pending_cnt > 0), headroom, st.job_queue, queue_headroom,
    )

    sess = SessionCtx(
        drf_total=drf_total, deserved=deserved, job_sched_valid=job_sched_valid,
        min_avail=min_avail, drf_level=drf_level,
    )
    T = st.num_tasks
    G = st.num_groups
    state = AllocState(
        task_status=st.task_status.clone(),
        task_node=st.task_node.clone(),
        node_idle=st.node_idle.clone(),
        node_releasing=st.node_releasing.clone(),
        node_ports=st.node_ports.clone(),
        node_num_tasks=st.node_num_tasks.clone(),
        job_alloc=job_alloc,
        queue_alloc=queue_alloc,
        job_ready_cnt=job_ready_cnt,
        group_placed=torch.zeros(G, dtype=torch.int32, device=dev),
        group_unfit=torch.zeros(G, dtype=torch.bool, device=dev),
        evicted_for=torch.full((T,), -1, dtype=torch.int32, device=dev),
        evict_claimant=torch.full((T,), -1, dtype=torch.int32, device=dev),
        evict_phase=torch.zeros(T, dtype=torch.int32, device=dev),
        evict_round=torch.full((T,), -1, dtype=torch.int32, device=dev),
        progress=torch.zeros((), dtype=torch.bool, device=dev),
    )
    return sess, state


def schedule_cycle(
    st: SnapshotTensors,
    tiers: Tiers = DEFAULT_TIERS,
    actions: Tuple[str, ...] = DEFAULT_ACTIONS,
    s_max: int = 4096,
    max_rounds: int = 100_000,
    decode_caps: Optional[Tuple[int, int]] = None,
    stats: Optional[Dict[str, int]] = None,
) -> CycleDecisions:
    """One full scheduling cycle on the pack's device.  ``stats``, when
    given, receives the rounds each action ran (``rounds.<action>``) and
    the wall time of each stage (``ms.<stage>``; the device is
    synchronised at each stage boundary to take them)."""
    clock = [time.perf_counter()]

    def mark(stage: str) -> None:
        if stats is not None:
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)
            now = time.perf_counter()
            stats[f"ms.{stage}"] = (now - clock[0]) * 1e3
            clock[0] = now

    sess, state = open_session(st, tiers)
    mark("open_session")
    for action in actions:
        if action in LATER_ACTIONS:
            raise NotImplementedError(f"action {action!r} is {LATER_ACTIONS[action]}")
        try:
            kernel = ACTION_KERNELS[action]
        except KeyError:
            raise ValueError(f"unknown action: {action}") from None
        state = kernel(st, sess, state, tiers, s_max=s_max, max_rounds=max_rounds)
        if stats is not None:
            stats[f"rounds.{action}"] = state.rounds
        mark(action)
    bind_cap, evict_cap = decode_caps if decode_caps is not None else (None, None)
    dec = commit_cycle(st, sess, state, bind_cap=bind_cap, evict_cap=evict_cap)
    mark("commit")
    return dec


def commit_cycle(
    st: SnapshotTensors,
    sess: SessionCtx,
    state: AllocState,
    bind_cap: Optional[int] = None,
    evict_cap: Optional[int] = None,
) -> CycleDecisions:
    """Gang-masked bind/evict commit, close-side readiness, and the
    compact decode lists."""
    job_ready = state.job_ready_cnt >= sess.min_avail
    ef = state.evicted_for
    cond_ok = job_ready[ef.clamp(min=0).to(torch.int64)]
    evict_mask = (ef == -2) | ((ef >= 0) & cond_ok)
    # a discarded eviction restores its victim's ready count at close
    discarded = (ef >= 0) & ~cond_ok
    restored_cnt = state.job_ready_cnt.clone()
    restored_cnt.index_put_(
        (torch.where(discarded, st.task_job, 0).to(torch.int64),),
        discarded.to(torch.int32), accumulate=True,
    )
    job_ready_status = restored_cnt >= sess.min_avail

    was_pending = (st.task_status == int(TaskStatus.PENDING)) & st.task_valid
    newly_alloc = was_pending & (state.task_status == int(TaskStatus.ALLOCATED))
    ready_of_task = job_ready_status[st.task_job.to(torch.int64)]
    bind_mask = newly_alloc & ready_of_task
    auto_b, auto_e = decode_caps(st.num_tasks)
    bind_idx, bind_count = _compact_indices(bind_mask, auto_b if bind_cap is None else bind_cap)
    evict_idx, evict_count = _compact_indices(evict_mask, auto_e if evict_cap is None else evict_cap)
    bind_node = torch.where(
        bind_idx >= 0, state.task_node[bind_idx.clamp(min=0).to(torch.int64)], -1
    ).to(torch.int32)
    return CycleDecisions(
        task_node=state.task_node,
        task_status=state.task_status,
        bind_mask=bind_mask,
        evict_mask=evict_mask,
        job_ready=job_ready_status,
        unready_alloc=newly_alloc & ~ready_of_task,
        node_idle=state.node_idle,
        node_num_tasks=state.node_num_tasks,
        node_ports=state.node_ports,
        evict_claimant=state.evict_claimant,
        evict_phase=state.evict_phase,
        evict_round=state.evict_round,
        queue_deserved=sess.deserved,
        queue_alloc=state.queue_alloc,
        bind_idx=bind_idx,
        bind_node=bind_node,
        evict_idx=evict_idx,
        bind_count=bind_count,
        evict_count=evict_count,
    )
