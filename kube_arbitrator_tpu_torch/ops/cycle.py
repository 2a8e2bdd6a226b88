"""The scheduling cycle: open session -> the conf's actions (reclaim,
allocate, backfill, preempt) -> commit (the port of
kube_arbitrator_tpu/ops/cycle.py:103-430).

Decisions are committed by masking: a job's new allocations produce bind
intents only if the job ends the cycle gang-ready.

The cycle is a generator of its host reads (:func:`cycle_steps`, the
seam of ops/steps.py): :func:`schedule_cycle` drives one alone, and
:func:`batched_schedule_cycle` (B15) drives several tenants' cycles in
lockstep, one host read a step for all of them.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.types import TaskStatus
from ..cache.snapshot import SnapshotTensors
from .allocate import AllocState, SessionCtx, allocate_action, backfill_action
from .common import fair, ordered_sum, safe_share, segment_sum
from .fairness import drf_equilibrium_levels_per_job, drf_shares, proportion_deserved
from .kernels.stable_compact import stable_compact, stable_compact_pair
from .kernels.stable_sort import segment_order
from .ordering import DEFAULT_ACTIONS, DEFAULT_TIERS, Tiers
from .steps import drive, drive_many, stepped
from .preempt import (
    phase_a_probe,
    preempt_action,
    preempt_panel_width,
    reclaim_action,
    reclaim_batch_fallback_reason,
    reclaim_engine_fallback_reason,
    turn_batch_fallback_reason,
)
from ..utils import profiling
from ..utils.metrics import metrics


@stepped
def _reclaim_optimistic_action(st, sess, state, tiers, s_max: int = 4096,
                               max_rounds: int = 100_000) -> AllocState:
    """Reclaim with the opt-in optimistic engine (the reference's
    ops/cycle.py:50-76), selected from the conf as ``actions:
    "reclaim_optimistic, allocate, ..."``.  Decides like ``reclaim``.  A
    pack the engine is illegal for (no canon pack, pod affinity, a
    (node, queue) key past int32) takes the default dispatch instead of
    raising; :func:`schedule_cycle_staged` says so once per reason."""
    legal = reclaim_engine_fallback_reason(st, tiers) is None
    return (yield from reclaim_action.steps(st, sess, state, tiers, s_max=s_max,
                                            max_rounds=max_rounds,
                                            turn_batch="optimistic" if legal else None))


ACTION_KERNELS = {
    "allocate": allocate_action,
    "backfill": backfill_action,
    "preempt": preempt_action,
    "reclaim": reclaim_action,
    "reclaim_optimistic": _reclaim_optimistic_action,
}
# the evictive actions whose counters the cycle reports beside rounds
RECLAIM_ACTIONS = ("reclaim", "reclaim_optimistic")
# kube-batch's documented evictive conf (the reference's bench.py:77)
FULL_ACTIONS = ("reclaim", "allocate", "backfill", "preempt")

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


def decisions_to_host(dec: CycleDecisions) -> CycleDecisions:
    """``dec`` with every field a host numpy array the caller owns (a
    copy), as a remote decider hands decisions to a scheduler's session."""
    return CycleDecisions(**{f.name: np.array(getattr(dec, f.name).cpu().numpy())
                             for f in dataclasses.fields(dec)})


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
    ascending order, -1 padded; ``count`` is the full population.  K16."""
    idx, count = stable_compact(mask[None, :], cap, -1)
    return idx[0], count[0]


@stepped
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

    # every per-job sum runs over task_job, every per-queue sum over
    # job_queue: each order is sorted once (K19) and shared
    tj = st.task_job
    tj_order = segment_order(tj, J)
    job_alloc = segment_sum(res_or_0(alloc_now), tj, J, order=tj_order)
    job_req = segment_sum(res_or_0(alloc_now | pending_now), tj, J, order=tj_order)
    job_ready_cnt = segment_sum(ready_now.to(torch.int32), tj, J, order=tj_order)
    job_valid_cnt = segment_sum(valid_now.to(torch.int32), tj, J, order=tj_order)
    jv = st.job_valid[:, None]
    jq_order = segment_order(st.job_queue, Q)
    queue_alloc = segment_sum(torch.where(jv, job_alloc, 0.0), st.job_queue, Q, order=jq_order)
    queue_req = segment_sum(torch.where(jv, job_req, 0.0), st.job_queue, Q, order=jq_order)

    gang_ready_on = any(
        p.name == "gang" and not p.job_ready_disabled for t in tiers for p in t.plugins
    )
    if _plugin_enabled(tiers, "gang"):
        job_sched_valid = st.job_valid & (job_valid_cnt >= st.job_min_available)
    else:
        job_sched_valid = st.job_valid
    min_avail = st.job_min_available if gang_ready_on else torch.zeros(J, dtype=torch.int32, device=dev)

    if _plugin_enabled(tiers, "proportion"):
        deserved = yield from proportion_deserved.steps(st.queue_weight, queue_req, prop_total,
                                                        st.queue_valid)
    else:
        deserved = torch.full((Q, st.task_resreq.shape[1]), 3.0e38, dtype=torch.float32, device=dev)

    job_pending_cnt = segment_sum(pending_now.to(torch.int32), tj, J, order=tj_order)
    job_pending_req = segment_sum(res_or_0(pending_now), tj, J, order=tj_order)
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


def _no_reads(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as a generator that reads nothing."""
    return fn(*args, **kwargs)
    yield  # a generator, for ``yield from``


def cycle_steps(st: SnapshotTensors, tiers: Tiers = DEFAULT_TIERS,
                actions: Tuple[str, ...] = DEFAULT_ACTIONS, s_max: int = 4096,
                max_rounds: int = 100_000, decode_caps: Optional[Tuple[int, int]] = None,
                on_stage: Optional[Callable[[str, float, float, Optional[AllocState]],
                                            None]] = None):
    """open_session -> each action -> commit, as a generator of its host
    reads (ops/steps.py) that returns the CycleDecisions.  With
    ``on_stage``, the device is synchronised at each stage boundary and
    ``on_stage(stage, wall_ts, ms, state)`` is called after each stage
    (``state`` the action's result, None for open_session and commit);
    with the kernel profiler on (utils/profiling.py), each stage also
    runs in its stage scope, the first run of a (shape, stage) under its
    profiled pass, and the state preempt enters with is probed once per
    shape for the phase-A split (:func:`_measure_phase_split`)."""
    dev = st.device
    prof = profiling.profiler()
    key = profiling.shape_key(st) if on_stage is not None and prof.enabled else None

    def stage(name, gen, state_of=None):
        if on_stage is None:
            return (yield from gen)
        with prof.stage_scope(name), prof.estimate_scope(key, name, dev):
            ts = time.time()
            t0 = time.perf_counter()
            out = yield from gen
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        on_stage(name, ts, ms, state_of(out) if state_of else None)
        return out

    sess, state = yield from stage("open_session", open_session.steps(st, tiers))
    for action in actions:
        if action not in ACTION_KERNELS:
            raise ValueError(f"unknown action: {action}")
        if action == "preempt" and key is not None:
            prof.ensure_phase_split(key, lambda state=state: _measure_phase_split(
                st, sess, state, tiers, s_max))
        kernel = ACTION_KERNELS[action]
        args = (st, sess, state, tiers)
        kw = dict(s_max=s_max, max_rounds=max_rounds)
        # an action registered from outside (framework/registry.py) may read nothing
        gen = kernel.steps(*args, **kw) if hasattr(kernel, "steps") else _no_reads(kernel, *args,
                                                                                   **kw)
        state = yield from stage(action, gen, state_of=lambda s: s)
    bind_cap, evict_cap = decode_caps if decode_caps is not None else (None, None)
    return (yield from stage("commit", _no_reads(commit_cycle, st, sess, state,
                                                 bind_cap=bind_cap, evict_cap=evict_cap)))


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
    given, receives the rounds each action ran (``rounds.<action>``),
    the gated rounds of preempt and the reclaim actions
    (``rounds_gated.<action>``), the reclaim actions' claim conflicts
    (``claim_conflicts.<action>``) and the wall time of each stage
    (``ms.<stage>``; the device is synchronised at each stage boundary
    to take them)."""

    def record(stage, ts, ms, state):
        if state is not None:
            stats[f"rounds.{stage}"] = state.rounds
            if stage == "preempt" or stage in RECLAIM_ACTIONS:
                stats[f"rounds_gated.{stage}"] = state.rounds_gated
            if stage in RECLAIM_ACTIONS:
                stats[f"claim_conflicts.{stage}"] = state.claim_conflicts
        stats[f"ms.{stage}"] = ms

    return drive(cycle_steps(st, tiers, tuple(actions), s_max, max_rounds, decode_caps,
                             None if stats is None else record))


def batched_schedule_cycle(
    packs,
    tiers: Tiers = DEFAULT_TIERS,
    actions: Tuple[str, ...] = DEFAULT_ACTIONS,
    decode_caps: Optional[Tuple[int, int]] = None,
    s_max: int = 4096,
    max_rounds: int = 100_000,
) -> Tuple[CycleDecisions, ...]:
    """B15 (the reference's rpc/pool.py ``_run_batched``): the cycles of
    K tenants' packs on one device, in lockstep on one stream.  Each
    tenant's cycle is its own ``schedule_cycle`` with its own plans and
    its own K1-K20 launches; each step of all of them is served by one
    host read (ops/steps.drive_many), so the batch reads as often as its
    longest cycle.  Nothing is padded.  Its plain version is the K cycles
    one after another through :func:`schedule_cycle`; each tenant's
    decisions equal that, field for field."""
    packs = tuple(packs)
    devices = {p.device for p in packs}
    if len(devices) > 1:
        raise ValueError(f"batched_schedule_cycle: packs on {sorted(map(str, devices))}")
    return tuple(drive_many([
        cycle_steps(p, tiers, tuple(actions), s_max, max_rounds, decode_caps) for p in packs
    ]))


def schedule_cycle_staged(
    st: SnapshotTensors,
    tiers: Tiers = DEFAULT_TIERS,
    actions: Tuple[str, ...] = DEFAULT_ACTIONS,
    s_max: int = 4096,
    max_rounds: int = 100_000,
    decode_caps: Optional[Tuple[int, int]] = None,
):
    """The same cycle, stage by stage (the reference's
    ops/cycle.py:464-574).  Returns ``(CycleDecisions, [(stage, wall_ts,
    ms, rounds, rounds_gated, claim_conflicts), ...])`` for
    ``open_session``, each action and ``commit``; the three counters are
    the action's ``AllocState`` counters after the stage (None for the
    other stages).  Before the cycle, an evictive action whose fast
    engine this pack cannot take is counted in
    ``turn_batch_fallback_total{action, reason}`` and named once per
    (action, reason) on stderr.  With the kernel profiler on
    (utils/profiling.py), the cycle's stage times land in its table under
    the pack's shape key, with the per-shape profiled pass and phase-A
    split :func:`cycle_steps` takes."""
    timings: List[tuple] = []

    def record(stage, ts, ms, state):
        counters = ((state.rounds, state.rounds_gated, state.claim_conflicts)
                    if state is not None else (None, None, None))
        timings.append((stage, ts, ms) + counters)

    _record_fallback_reasons(st, tiers, actions)
    dec = drive(cycle_steps(st, tiers, tuple(actions), s_max, max_rounds, decode_caps, record))
    prof = profiling.profiler()
    if prof.enabled:
        prof.record_cycle(profiling.shape_key(st), timings)
    return dec, timings


# (action, reason) pairs already reported by this process
_FALLBACKS_SEEN: set = set()


def _record_fallback_reasons(st, tiers, actions) -> None:
    """Count ``turn_batch_fallback_total{action, reason}`` each staged
    cycle whose evictive action's fast engine is disabled for this pack,
    and print once per (action, reason) and process what runs instead
    (the reference's counter and text)."""
    for action, reason_fn, fell_to in (
        ("preempt", turn_batch_fallback_reason, "sequential turn loop"),
        ("reclaim", reclaim_batch_fallback_reason, "sorted-space _reclaim_fast kernel"),
        ("reclaim_optimistic", reclaim_engine_fallback_reason,
         "default reclaim dispatch (sequential canon walk or sorted-space _reclaim_fast)"),
    ):
        if action not in actions:
            continue
        reason = reason_fn(st, tiers)
        if reason is None:
            continue
        metrics().counter_add("turn_batch_fallback_total",
                              labels={"action": action, "reason": reason})
        if (action, reason) in _FALLBACKS_SEEN:
            continue
        _FALLBACKS_SEEN.add((action, reason))
        print(f"# kat: {action} fast-path engine disabled for this pack shape "
              f"(reason={reason}); running the {fell_to}", file=sys.stderr)


def _measure_phase_split(st, sess, state, tiers, s_max: int) -> Dict[str, float]:
    """One preempt round's phase A at this pack shape, full and gated
    (ops/preempt.phase_a_probe), host-timed: the best of three after a
    warm run, each run ending in its read through the seam.  The panel is
    the tier ``preempt_action`` selects for this state
    (``preempt_panel_width``).  Served at /debug/kernels as
    ``preempt:phase_a``: tail ~= the preempt stage's mean -
    rounds_full * full_ms - rounds_gated * gated_ms."""
    panel_w = preempt_panel_width(st, sess, state)
    out: Dict[str, float] = {"panel_w": panel_w}
    for name, gated in (("phase_a_full_ms", False), ("phase_a_gated_ms", True)):
        kw = dict(s_max=s_max, gated=gated, panel_w=panel_w)
        phase_a_probe(st, sess, state, tiers, **kw)  # warm: plans bound, kernels built
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            phase_a_probe(st, sess, state, tiers, **kw)
            best = min(best, (time.perf_counter() - t0) * 1e3)
        out[name] = round(best, 3)
    return out


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
    # K16: both lists from one launch, into one buffer that leaves with the decisions
    (bind_idx, bind_count), (evict_idx, evict_count) = stable_compact_pair(
        bind_mask, auto_b if bind_cap is None else bind_cap, -1,
        evict_mask, auto_e if evict_cap is None else evict_cap, -1)
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
