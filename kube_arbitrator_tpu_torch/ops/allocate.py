"""The allocate action on its batched, deferred-decode path (the port of
kube_arbitrator_tpu/ops/allocate.py).

Rounds run until one places nothing.  Each round orders the active
queues, then walks them in chunks of TURN_CHUNK turns: the chunk's
(job, group, budget) selections are computed together (two K2 launches
plus plain torch for the budgets), then K1 runs the chunk's node
admission slot by slot on the device, and the chunk's aggregates are
committed.  Placements accumulate as per-(group, node) counts, decoded
into task placements once per action by K3.

K1's plain version (``copies_fit`` / ``node_capacity`` and the prefix
fill, the reference's ``_copies_fit`` / ``_node_capacity``) lives beside
it in ops/kernels/admit_chunk.py.

Only first-fit node order without pod affinity is ported here; the
immediate path (binpack/spread, pod affinity, ``turn_batch=False``, more
than DEFER_MAX_CELLS cells) raises NotImplementedError.

Host reads: ``trip`` and ``progress`` once per round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cache.snapshot import SnapshotTensors, pa_enabled
from .common import BIG, EPS, ceil_div_pos, fair, lex_argmin, plugin_on, safe_share, to_i32
from .fairness import drf_shares, overused, queue_shares
from .kernels.admit_chunk import admit_chunk
from .kernels.decode_deferred import decode_deferred
from .ordering import Tiers, group_order_keys, job_order_keys, node_order_policy, queue_order_keys

IMMEDIATE_PATH = (
    "the immediate allocate path (binpack/spread node order, pod affinity, "
    "turn_batch=False, or more than DEFER_MAX_CELLS cells) is port slice 4"
)


@dataclasses.dataclass
class AllocState:
    """Per-cycle scheduling state threaded through the actions.  Each
    action works on its own copy (``_copy``), so a caller's state is never
    changed; inside an action the node tensors are updated in place."""

    task_status: torch.Tensor      # i32[T]
    task_node: torch.Tensor        # i32[T]
    node_idle: torch.Tensor        # f32[N, R]
    node_releasing: torch.Tensor   # f32[N, R]
    node_ports: torch.Tensor       # i32[N, W]
    node_num_tasks: torch.Tensor   # i32[N]
    job_alloc: torch.Tensor        # f32[J, R] allocated (incl. pipelined)
    queue_alloc: torch.Tensor      # f32[Q, R]
    job_ready_cnt: torch.Tensor    # i32[J]
    group_placed: torch.Tensor     # i32[G] pending tasks placed this cycle
    group_unfit: torch.Tensor      # bool[G] proven unplaceable this action
    # eviction attribution; allocate and backfill evict nothing
    evicted_for: torch.Tensor      # i32[T]
    evict_claimant: torch.Tensor   # i32[T]
    evict_phase: torch.Tensor      # i32[T]
    evict_round: torch.Tensor      # i32[T]
    progress: torch.Tensor         # bool scalar: placements this round
    rounds: int = 0


def _copy(state: AllocState) -> AllocState:
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state) if f.name != "rounds"
    })


@dataclasses.dataclass(frozen=True)
class SessionCtx:
    """Quantities fixed for the whole cycle (OnSessionOpen equivalents)."""

    drf_total: torch.Tensor      # f32[R]
    deserved: torch.Tensor       # f32[Q, R]
    job_sched_valid: torch.Tensor  # bool[J]
    min_avail: torch.Tensor      # i32[J]
    drf_level: torch.Tensor      # f32[J]


def _drf_before_gang(tiers: Tiers) -> bool:
    """True when drf's job order is consulted before gang's."""
    for tier in tiers:
        for p in tier.plugins:
            if p.job_order_disabled:
                continue
            if p.name == "gang":
                return False
            if p.name == "drf":
                return True
    return False


def _scatter_any(index: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """bool[size]: out[i] = any(values[index == i]) (the reference's
    ``.at[index].max`` of bools)."""
    hits = torch.zeros(size, dtype=torch.int32, device=values.device)
    hits.index_put_((index.to(torch.int64),), values.to(torch.int32), accumulate=True)
    return hits > 0


def group_live_mask(st, sess, group_placed, group_unfit, best_effort_pass: bool):
    """Eligible-group mask shared by the per-turn selection and the
    round-level active-queue bound (one definition, so the bound cannot
    drift from per-turn eligibility)."""
    return (
        st.group_valid
        & (st.group_size - group_placed > 0)
        & sess.job_sched_valid[st.group_job.to(torch.int64)]
        & (st.group_best_effort == best_effort_pass)
        & ~group_unfit
    )


def queue_has_live_job(st, grp_live):
    """bool[Q]: queues owning at least one valid job with a live group."""
    job_live = _scatter_any(st.group_job, grp_live, st.num_jobs) & st.job_valid
    return _scatter_any(st.job_queue, job_live, st.num_queues)


def turn_budget(st, sess, tiers, j, q, req, job_share, job_ready, jmask, state, s_max):
    """How many tasks the sequential loop would grant job ``j`` before the
    ordering switches away from it — min(gang, DRF share crossing or the
    equilibrium quota, proportion's first deserved boundary) — for every
    slot of a chunk at once: ``j``/``q`` are i64[S], ``req`` f32[S, R],
    ``jmask`` bool[S, J].  (The reference's preempt mode, which drops the
    queue clamp, is ported with the evictive actions.)"""
    J = st.num_jobs
    ready_j = job_ready[j]
    b_gang = torch.where(
        ready_j, s_max, (sess.min_avail[j] - state.job_ready_cnt[j]).clamp(min=1)
    )
    # DRF: tasks until this job's share reaches the next contender's
    jr = torch.arange(J, device=j.device)
    others = (
        jmask
        & (jr[None, :] != j[:, None])
        & (st.job_priority[None, :] == st.job_priority[j][:, None])
        & (job_ready[None, :] == ready_j[:, None])
    )
    s2 = torch.where(others, job_share[None, :], BIG).amin(dim=-1)
    delta = safe_share(req, sess.drf_total[None, :]).amax(dim=-1)
    b_drf = torch.where(
        (s2 >= BIG / 2) | (delta <= 0),
        s_max,
        ceil_div_pos((s2 - job_share[j]).clamp(min=0.0), delta) + 1,
    )
    # proportion's check-before-pop: stop at the queue's first
    # yet-uncrossed deserved boundary
    d_minus_a = fair(sess.deserved[q]) - fair(state.queue_alloc[q])
    req_f = fair(req)
    steps = torch.floor((d_minus_a - EPS) / req_f.clamp(min=1e-30))
    under = (req_f > 0) & (d_minus_a >= EPS)
    b_first = torch.where(under, steps + 1.0, BIG).amin(dim=-1)
    f_r = torch.where(req_f > 0, steps, torch.where(d_minus_a >= EPS, BIG, -1.0))
    t_max = f_r.amax(dim=-1) + 1.0
    b_rest = torch.where(t_max >= BIG / 2, float(s_max), t_max.clamp(min=1.0))
    b_queue = to_i32(torch.where(b_first >= BIG / 2, b_rest, b_first.clamp(min=1.0)))
    # equilibrium floor for gang-ready jobs
    b_quota = to_i32(torch.floor((sess.drf_level[j] - job_share[j]) / delta.clamp(min=1e-9)))
    b_not_ready = torch.minimum(b_gang, b_drf) if _drf_before_gang(tiers) else b_gang
    return torch.minimum(
        torch.where(ready_j, torch.maximum(b_drf, b_quota), b_not_ready), b_queue
    ).to(torch.int32)


DEFER_MAX_CELLS = 1 << 25


def _use_deferred_decode(st: SnapshotTensors, tiers: Tiers) -> bool:
    """The batched deferred-decode path is legal under first-fit node
    order, without pod affinity, within the [G, N] cell cap."""
    return (
        node_order_policy(tiers) == "first_fit"
        and not pa_enabled(st)
        and st.num_groups * st.num_nodes <= DEFER_MAX_CELLS
    )


PRUNE_FLOOR = 256


def _class_minreq(st):
    """f32[K, R]: per predicate class, the elementwise MIN per-task request
    over its resource-requesting valid groups (BIG where none)."""
    K = st.class_fit.shape[0]
    R = st.task_resreq.shape[1]
    gmask = st.group_valid & ~st.group_best_effort
    out = torch.full((K + 1, R), BIG, dtype=torch.float32, device=gmask.device)
    klass = torch.where(gmask, st.group_klass, K).to(torch.int64)
    vals = torch.where(gmask[:, None], st.group_resreq, BIG)
    out.scatter_reduce_(0, klass[:, None].expand(-1, R), vals, reduce="amin", include_self=True)
    return out[:K]


def _feasible_cells(class_fit, node_klass, node_valid, node_unsched, preds_on, minreq, basis):
    """bool[K, n]: node x class feasibility (predicates; plus the
    capacity screen against ``minreq`` when given)."""
    K = class_fit.shape[0]
    n = node_klass.shape[0]
    if preds_on:
        feas = class_fit[:, node_klass.to(torch.int64)] & node_valid[None, :] & ~node_unsched[None, :]
    else:
        feas = node_valid[None, :].expand(K, n)
    if minreq is not None:
        never = (
            (minreq[:, None, :] > 0)
            & (minreq[:, None, :] < BIG / 2)
            & (basis[None, :, :] < minreq[:, None, :] - EPS)
        ).any(dim=-1)
        feas = feas & ~never
    return feas


def _prune_feasible(st, state, tiers, best_effort_pass):
    """bool[K, N]: once-per-action feasibility; a False cell can never
    grant a copy to any group of the class during this action."""
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    if best_effort_pass:
        minreq = basis = None
    else:
        minreq = _class_minreq(st)
        basis = torch.maximum(state.node_idle, state.node_releasing)
    return _feasible_cells(
        st.class_fit, st.node_klass, st.node_valid, st.node_unsched, preds_on, minreq, basis,
    )


def _compact_rows(feas: torch.Tensor, NC: int) -> torch.Tensor:
    """i32[K, NC]: per-class stable compaction of the feasible nodes
    (node order kept); slots past the class's count hold N."""
    K, N = feas.shape
    dest = torch.cumsum(feas.to(torch.int32), dim=1, dtype=torch.int32) - 1
    slot = torch.where(feas & (dest < NC), dest, NC).to(torch.int64)
    idx = torch.full((K, NC + 1), N, dtype=torch.int32, device=feas.device)
    nodes = torch.arange(N, dtype=torch.int32, device=feas.device).expand(K, N)
    # only column NC (dropped below) can receive more than one write
    idx.scatter_(1, slot, nodes)
    return idx[:, :NC].contiguous()


def _selection_shared(st, sess, state, tiers, best_effort_pass):
    """Queue-independent arrays a turn's selection reads, from the
    round-start aggregates."""
    grp_remaining = st.group_size - state.group_placed
    grp_elig = group_live_mask(st, sess, state.group_placed, state.group_unfit, best_effort_pass)
    job_has_pending = _scatter_any(st.group_job, grp_elig, st.num_jobs)
    job_ready = state.job_ready_cnt >= sess.min_avail
    job_share = drf_shares(state.job_alloc, sess.drf_total)
    jkeys = job_order_keys(tiers, st.job_priority, job_ready, st.job_creation_rank, job_share)
    gkeys = group_order_keys(tiers, st.group_priority, st.group_uid_rank)
    return grp_remaining, grp_elig, job_has_pending, job_ready, job_share, jkeys, gkeys


def select_turns(st, sess, state, tiers, s_max, best_effort_pass, shared, q_ids, q_ok):
    """Every slot's (job, group, has_grp, req, budget) at once: the
    reference's vmapped ``_select_turn`` with the slot axis written out.
    ``q_ids`` i64[S], ``q_ok`` bool[S].  The two argmins go through K2;
    backfill grants up to ``s_max`` per turn."""
    (grp_remaining, grp_elig, job_has_pending, job_ready, job_share, jkeys, gkeys) = shared
    jmask = (
        (st.job_queue[None, :] == q_ids[:, None])
        & (job_has_pending & st.job_valid)[None, :]
        & q_ok[:, None]
    )
    j, has_job = lex_argmin(jkeys, jmask)
    j = j.to(torch.int64)
    gmask = (st.group_job[None, :] == j[:, None]) & grp_elig[None, :] & has_job[:, None]
    g, has_grp = lex_argmin(gkeys, gmask)
    g = g.to(torch.int64)
    req = st.group_resreq[g]
    if best_effort_pass:
        budget = torch.full_like(g, s_max, dtype=torch.int32)
    else:
        budget = turn_budget(st, sess, tiers, j, q_ids, req, job_share, job_ready, jmask, state, s_max)
    budget = budget.clamp(0, s_max)
    budget = torch.where(has_grp, torch.minimum(budget, grp_remaining[g]), 0).to(torch.int32)
    return j, g, has_grp, req, budget


TURN_CHUNK = 8  # queue turns selected per batched chunk


def _round_batched(st, sess, state, tiers, s_max, best_effort_pass, gn, perm, trip, prune_idx=None):
    """One round: chunks of TURN_CHUNK turns, each selected together and
    admitted by K1; node state and the [G, N] counts are updated in
    place.  Bit-exact with the sequential turn loop because a turn's
    selection reads only rows its own queue owns."""
    Q = st.num_queues
    S = TURN_CHUNK
    dev = st.device
    shared = _selection_shared(st, sess, state, tiers, best_effort_pass)
    if best_effort_pass:
        q_served = st.queue_valid
    else:
        q_served = st.queue_valid & ~overused(state.queue_alloc, sess.deserved)
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    gn_a, gn_p, any_a, any_p = gn
    W = st.group_ports.shape[1]
    slot = torch.arange(S, device=dev)
    for c in range((trip + S - 1) // S):
        idx = c * S + slot
        q_idx = perm[idx.clamp(0, Q - 1)]
        j_sel, g_sel, has_grp, req_s, budget_s = select_turns(
            st, sess, state, tiers, s_max, best_effort_pass, shared, q_idx,
            q_served[q_idx] & (idx < trip),
        )
        if preds_on:
            ports_s = st.group_ports[g_sel]
            has_ports_s = (ports_s != 0).any(dim=1)
        else:
            ports_s = torch.zeros((S, W), dtype=torch.int32, device=dev)
            has_ports_s = torch.zeros(S, dtype=torch.bool, device=dev)
        n_slots = torch.full((1,), min(trip - c * S, S), dtype=torch.int32, device=dev)
        placed_v, use_rel_v = admit_chunk(
            st, state.node_idle, state.node_releasing, state.node_ports,
            state.node_num_tasks, gn_a, gn_p, n_slots, g_sel.to(torch.int32),
            req_s.contiguous(), budget_s, ports_s.contiguous(), has_ports_s, prune_idx,
            s_max, best_effort_pass, preds_on,
        )
        # ---- aggregate commit: the slots are distinct queues, hence
        # distinct job/group rows; empty slots add exact zeros ----
        if best_effort_pass:
            unfit_now = has_grp & (placed_v < budget_s)
        else:
            unfit_now = has_grp & use_rel_v & (placed_v < budget_s)
        ptf = placed_v.to(torch.float32)[:, None] * req_s
        placed = placed_v > 0
        any_a = any_a | (placed & ~use_rel_v).any()
        any_p = any_p | (placed & use_rel_v).any()
        state.job_alloc.index_put_((j_sel,), ptf, accumulate=True)
        state.queue_alloc.index_put_((q_idx,), ptf, accumulate=True)
        state.job_ready_cnt.index_put_((j_sel,), placed_v, accumulate=True)
        state.group_placed.index_put_((g_sel,), placed_v, accumulate=True)
        state.group_unfit |= _scatter_any(g_sel, unfit_now, st.num_groups)
        state.progress = state.progress | placed.any() | unfit_now.any()
    return (gn_a, gn_p, any_a, any_p)


def _round(st, sess, state, tiers, s_max, best_effort_pass, gn, prune_idx=None):
    """One round over the ACTIVE queues in queue order (inactive ones
    sort last and are not visited)."""
    grp_live = group_live_mask(st, sess, state.group_placed, state.group_unfit, best_effort_pass)
    q_active = st.queue_valid & queue_has_live_job(st, grp_live)
    if not best_effort_pass:
        q_active = q_active & ~overused(state.queue_alloc, sess.deserved)
    trip = max(int(q_active.sum()), 1)
    q_share = queue_shares(state.queue_alloc, sess.deserved)
    keys = [torch.where(q_active, k, BIG) for k in queue_order_keys(tiers, q_share, st.queue_uid_rank)]
    keys.insert(0, torch.where(q_active, 0.0, 1.0))
    # the reference's jnp.lexsort (first key here primary): stable sorts,
    # least significant key first
    perm = torch.arange(st.num_queues, device=st.device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    gn = _round_batched(st, sess, state, tiers, s_max, best_effort_pass, gn, perm, trip, prune_idx)
    state.rounds += 1
    return gn


def _decode_deferred(st, state, entry_placed, gn_a, gn_p):
    """Counts -> task placements through K3 (allocated before pipelined)."""
    status, node = decode_deferred(
        gn_a, gn_p, st.task_group, st.task_group_rank, st.task_valid,
        entry_placed, state.task_status, state.task_node,
    )
    state.task_status, state.task_node = status, node


def allocate_action(
    st: SnapshotTensors,
    sess: SessionCtx,
    state: AllocState,
    tiers: Tiers,
    s_max: int = 4096,
    max_rounds: int = 100_000,
    best_effort_pass: bool = False,
    turn_batch: Optional[bool] = None,
    prune: Optional[bool] = None,
    prune_floor: int = PRUNE_FLOOR,
) -> AllocState:
    """Run rounds until a full round places nothing.  Returns a new
    state; ``state`` is left as it was.

    ``prune``: None enables feasibility pre-pruning when N // 8 >=
    ``prune_floor``; the panel is the smallest of N//8, N//4 or full
    that the largest class's feasible-node count fits."""
    if turn_batch is False or not _use_deferred_decode(st, tiers):
        raise NotImplementedError(IMMEDIATE_PATH)
    N = st.num_nodes
    if prune is None:
        prune = N // 8 >= prune_floor
    entry_placed = state.group_placed.clone()
    state = _copy(state)
    dev = st.device
    state.progress = torch.ones((), dtype=torch.bool, device=dev)
    state.rounds = 0
    state.group_unfit = torch.zeros_like(state.group_unfit)

    prune_idx = None
    if prune:
        feas = _prune_feasible(st, state, tiers, best_effort_pass)
        cmax = int(feas.to(torch.int32).sum(dim=1).max())
        if cmax <= N // 8:
            prune_idx = _compact_rows(feas, N // 8)
        elif cmax <= N // 4:
            prune_idx = _compact_rows(feas, N // 4)

    G = st.num_groups
    gn_a = torch.zeros((G, N), dtype=torch.int32, device=dev)
    # backfill (best-effort) never pipelines
    gn_p = None if best_effort_pass else torch.zeros((G, N), dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    gn = (gn_a, gn_p, no, no)
    while state.rounds < max_rounds and bool(state.progress):
        state.progress = torch.zeros((), dtype=torch.bool, device=dev)
        gn = _round(st, sess, state, tiers, s_max, best_effort_pass, gn, prune_idx)
    gn_a, gn_p, any_a, any_p = gn
    if bool(any_a | any_p):
        _decode_deferred(st, state, entry_placed, gn_a, gn_p if bool(any_p) else None)
    return state


def backfill_action(
    st: SnapshotTensors,
    sess: SessionCtx,
    state: AllocState,
    tiers: Tiers,
    s_max: int = 4096,
    max_rounds: int = 100_000,
) -> AllocState:
    """backfill.go:40-71: place BestEffort (empty-resreq) pending tasks on
    any node passing the non-resource predicates."""
    return allocate_action(
        st, sess, state, tiers, s_max=s_max, max_rounds=max_rounds, best_effort_pass=True,
    )
