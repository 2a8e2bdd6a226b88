"""The allocate action (the port of kube_arbitrator_tpu/ops/allocate.py).

Rounds run until one places nothing; each round visits the active queues
in queue order.  Two paths, chosen as the reference chooses them
(:func:`_use_deferred_decode`):

* batched, deferred decode (first-fit node order, no pod affinity,
  within DEFER_MAX_CELLS [G, N] cells): a round walks its queues in
  chunks of TURN_CHUNK turns; the chunk's (job, group, budget) selections
  are computed together (one K2 launch, the job and group picks, plus
  plain torch for the budgets), K1 runs the chunk's node admission slot by slot, and
  placements accumulate as per-(group, node) counts that K3 decodes into
  task placements once per action (gated on the device).  With pruning,
  K16 evaluates the feasibility cells and compacts each class's nodes
  into the panel once per action.  Host reads: ``trip`` and ``progress`` once per
  round each, and the panel's widest class once per action, each through
  the seam (ops/steps.py).
* immediate (binpack / spread node order, pod affinity, larger packs,
  or ``turn_batch=False``, the reference's parity path): one turn per
  active queue, each deciding its tasks at once — selection (one K2
  launch), the group's pod-affinity fit (K11), per-node capacity and
  the packing order (K9), seed and domain cap (K12), fill, node
  writeback and task decode (K10).  Host reads: one per round (the
  progress flag and the active-queue count together); a turn reads
  nothing on the host.

The plain versions of the kernels (``copies_fit`` / ``node_capacity``,
the reference's ``_copies_fit`` / ``_node_capacity``, and the turn's
fill) live beside them in ops/kernels/.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..cache.snapshot import SnapshotTensors, pa_enabled
from .common import BIG, EPS, ceil_div_pos, fair, plugin_on, safe_share, to_i32
from .fairness import drf_shares, overused
from .kernels.admit_chunk import AdmitPlan
from .kernels.decode_deferred import DecodePlan
from .kernels.lex_argmin import TurnPickPlan
from .kernels.queue_order import QueueOrderPlan, queue_order
from .kernels.stable_compact import FeasCells, stable_compact
from .kernels.turn_caps import TurnCapsPlan
from .kernels.turn_fill import TurnFillPlan, build_group_index
from .ordering import Tiers, node_order_policy
from .podaffinity import PaFitPlan, PaShapePlan
from .steps import read, stepped

# Eviction-phase codes carried by AllocState.evict_phase (the reference's
# ops/allocate.py:69-72; stable wire values of the audit records)
EVICT_PHASE_NONE = 0
EVICT_PHASE_PREEMPT = 1        # preempt phase 1: inter-job, same queue
EVICT_PHASE_PREEMPT_INTRA = 2  # preempt phase 2: within the claimant job
EVICT_PHASE_RECLAIM = 3        # cross-queue reclaim

# Turn-selection modes (the reference's SELECT_MODES): allocate's two
# passes and preempt's two phases
SELECT_MODES = ("allocate", "backfill", "preempt", "preempt_intra")


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
    # eviction attribution (ops/preempt.py): -1 not evicted; >= 0 the
    # claimant job whose gang readiness commits it; -2 unconditional
    evicted_for: torch.Tensor      # i32[T]
    # decision-audit aux: claimant job, EVICT_PHASE_*, round of each eviction
    evict_claimant: torch.Tensor   # i32[T]
    evict_phase: torch.Tensor      # i32[T]
    evict_round: torch.Tensor      # i32[T]
    progress: torch.Tensor         # bool scalar: placements this round
    rounds: int = 0
    rounds_gated: int = 0          # rounds served by preempt's round gate or reclaim's
    #                                batched / optimistic fast paths
    claim_conflicts: int = 0       # the optimistic reclaim engine's discarded claims
    windows: int = 0               # the optimistic reclaim engine's speculation windows


def _copy(state: AllocState) -> AllocState:
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
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


def _scatter_count(index: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """i32[size]: out[i] = sum(values[index == i]) for bool or int32
    ``values`` (integer adds: exact in any order); out-of-range indices
    are dropped, as the reference's ``mode="drop"``."""
    idx = index.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    hits = torch.zeros(size + 1, dtype=torch.int32, device=values.device)
    hits.scatter_add_(0, idx, values.to(torch.int32))
    return hits[:size]


def _scatter_any(index: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """bool[size]: out[i] = any(values[index == i]) (the reference's
    ``.at[index].max`` of bools)."""
    return _scatter_count(index, values, size) > 0


def group_live_mask(st, sess, group_placed, group_unfit, best_effort_pass=None):
    """Eligible-group mask shared by the per-turn selection and the
    round-level active-queue bound (one definition, so the bound cannot
    drift from per-turn eligibility).  ``best_effort_pass=None`` keeps
    resource-requesting groups only (the evictive actions);
    ``group_unfit`` may be None for actions that retire no groups."""
    m = (
        st.group_valid
        & (st.group_size - group_placed > 0)
        & sess.job_sched_valid[st.group_job.to(torch.int64)]
    )
    if best_effort_pass is None:
        m = m & ~st.group_best_effort
    else:
        m = m & (st.group_best_effort == best_effort_pass)
    if group_unfit is not None:
        m = m & ~group_unfit
    return m


def queue_has_live_job(st, grp_live, job_extra=None):
    """bool[Q]: queues owning at least one valid job with a live group
    (and ``job_extra``, when given)."""
    job_live = _scatter_any(st.group_job, grp_live, st.num_jobs) & st.job_valid
    if job_extra is not None:
        job_live = job_live & job_extra
    return _scatter_any(st.job_queue, job_live, st.num_queues)


def queue_perm(tiers, q_active, queue_alloc, deserved, queue_uid_rank, plan=None):
    """(nq, perm): the active-queue count (a device scalar) and a round's
    queue order — active queues first, by the tiered queue keys over the
    proportion shares.  One K17 launch, through ``plan`` (the action's
    :class:`QueueOrderPlan` over ``tiers``, ``deserved`` and
    ``queue_uid_rank``: its outputs are overwritten by its next launch)
    or a plan of its own."""
    if plan is None:
        perm, nq = queue_order(tiers, q_active, queue_alloc, deserved, queue_uid_rank)
    else:
        perm, nq = plan(q_active, queue_alloc)
    return nq, perm


def turn_budget(st, sess, tiers, j, q, req, job_share, job_ready, jmask, state, s_max,
                mode: str = "allocate"):
    """How many tasks the sequential loop would grant job ``j`` before the
    ordering switches away from it — min(gang, DRF share crossing or the
    equilibrium quota, proportion's first deserved boundary) — for every
    slot of a chunk at once: ``j``/``q`` are i64[S], ``req`` f32[S, R],
    ``jmask`` bool[S, J].  ``mode`` "allocate" applies proportion's queue
    clamp; "preempt" has none (preempt pops queues unconditionally)."""
    if mode not in ("allocate", "preempt"):
        raise ValueError(f"turn_budget mode {mode!r}")
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
    if mode == "allocate":
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
    else:
        b_queue = torch.full_like(j, s_max, dtype=torch.int32)
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


def _prune_cells(st, state, tiers, best_effort_pass) -> FeasCells:
    """The once-per-action feasibility cells [K, N]: a False cell can
    never grant a copy to any group of the class during this action
    (static predicates; capacity only shrinks during allocate, so a node
    whose entry max(idle, releasing) lies below the class's smallest
    request in a requested dimension never fits).  Backfill places
    without a resource screen."""
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    if best_effort_pass:
        minreq = basis = None
    else:
        minreq = _class_minreq(st)
        basis = torch.maximum(state.node_idle, state.node_releasing)
    return FeasCells(st.class_fit, st.node_klass, st.node_valid, st.node_unsched, preds_on,
                     minreq, basis)


def _prune_feasible(st, state, tiers, best_effort_pass):
    """bool[K, N]: the cells of :func:`_prune_cells`, evaluated."""
    return _prune_cells(st, state, tiers, best_effort_pass).mask()


def _compact_rows(feas, NC: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i32[K, NC], count i32[K]): per-class stable compaction of the
    feasible nodes (node order kept; slots past the class's count hold
    N) through K16, which evaluates :class:`FeasCells` in the same
    launch."""
    return stable_compact(feas, NC, feas.shape[1])


def _selection_shared(st, sess, state, tiers, best_effort_pass):
    """Queue-independent arrays a turn's selection reads, from the
    round-start aggregates (K2 builds the keys from ``job_ready`` and
    ``job_share``)."""
    grp_remaining = st.group_size - state.group_placed
    grp_elig = group_live_mask(st, sess, state.group_placed, state.group_unfit, best_effort_pass)
    job_has_pending = _scatter_any(st.group_job, grp_elig, st.num_jobs)
    job_ready = state.job_ready_cnt >= sess.min_avail
    job_share = drf_shares(state.job_alloc, sess.drf_total)
    return grp_remaining, grp_elig, job_has_pending, job_ready, job_share


def select_turns(st, sess, state, tiers, s_max, mode, shared, q_ids, q_ok, pick=None):
    """Every slot's (job, group, has_grp, req, budget) at once: the
    reference's vmapped ``_select_turn`` with the slot axis written out.
    ``mode`` is one of :data:`SELECT_MODES`; ``q_ids`` i64[S], ``q_ok``
    bool[S].  Both picks are one K2 launch through ``pick``, the action's
    :class:`TurnPickPlan` (None: a plan of its own); its j, g and job
    mask are plan-owned, so a selection is consumed before the plan's
    next selection of as many rows.  Backfill grants up to ``s_max`` per
    turn."""
    if mode not in SELECT_MODES:
        raise ValueError(f"select mode {mode!r}; one of {SELECT_MODES}")
    grp_remaining, grp_elig, job_has_pending, job_ready, job_share = shared
    if pick is None:
        pick = TurnPickPlan(st, tiers)
    j, has_job, g, has_grp, jmask = pick.select(q_ids, q_ok, job_has_pending, job_ready,
                                                job_share, grp_elig, jmask=mode != "backfill")
    req = st.group_resreq[g]
    if mode == "backfill":
        budget = torch.full_like(g, s_max, dtype=torch.int32)
    else:
        budget = turn_budget(
            st, sess, tiers, j, q_ids, req, job_share, job_ready, jmask, state, s_max,
            mode="preempt" if mode.startswith("preempt") else "allocate",
        )
    budget = budget.clamp(0, s_max)
    budget = torch.where(has_grp, torch.minimum(budget, grp_remaining[g]), 0).to(torch.int32)
    return j, g, has_grp, req, budget


TURN_CHUNK = 8  # queue turns selected per batched chunk


def _round_batched(st, sess, state, tiers, s_max, best_effort_pass, gn, perm, trip, admit,
                   pick=None):
    """One round: chunks of TURN_CHUNK turns, each selected together (K2,
    ``pick``, the action's TurnPickPlan; None: one for this round) and
    admitted by K1 (``admit``, the action's AdmitPlan over the node state
    and the [G, N] counts, which it updates in place).  Bit-exact with
    the sequential turn loop because a turn's selection reads only rows
    its own queue owns."""
    Q = st.num_queues
    S = TURN_CHUNK
    dev = st.device
    if pick is None:
        pick = TurnPickPlan(st, tiers)
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
            st, sess, state, tiers, s_max, "backfill" if best_effort_pass else "allocate",
            shared, q_idx,
            q_served[q_idx] & (idx < trip), pick,
        )
        if preds_on:
            ports_s = st.group_ports[g_sel]
            has_ports_s = (ports_s != 0).any(dim=1)
        else:
            ports_s = torch.zeros((S, W), dtype=torch.int32, device=dev)
            has_ports_s = torch.zeros(S, dtype=torch.bool, device=dev)
        placed_v, use_rel_v = admit(min(trip - c * S, S), g_sel.to(torch.int32),
                                    req_s.contiguous(), budget_s, ports_s.contiguous(),
                                    has_ports_s)
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


def _round(st, sess, state, tiers, s_max, best_effort_pass, gn, admit, order, pick):
    """One round over the ACTIVE queues in queue order (inactive ones
    sort last and are not visited); ``order`` is the action's K17 plan,
    ``pick`` its K2 plan.  A generator of its one host read (the trip)."""
    grp_live = group_live_mask(st, sess, state.group_placed, state.group_unfit, best_effort_pass)
    q_active = st.queue_valid & queue_has_live_job(st, grp_live)
    if not best_effort_pass:
        q_active = q_active & ~overused(state.queue_alloc, sess.deserved)
    nq, perm = queue_perm(tiers, q_active, state.queue_alloc, sess.deserved, st.queue_uid_rank,
                          order)
    (nq_h,) = yield from read(nq)
    trip = max(nq_h, 1)
    gn = _round_batched(st, sess, state, tiers, s_max, best_effort_pass, gn, perm, trip, admit,
                        pick)
    state.rounds += 1
    return gn


@stepped
def _turn_plans(st, state, s_max, best_effort_pass, policy, preds_on, pa_on):
    """(K9's plan over ``state``'s node arrays, K11's plan or None, K12's
    plan or None, K10's plan): the immediate turn's kernels, bound once
    for a run of turns on one state (K10 updates those node arrays and
    the task state in place).  K12's plan reads K11's plan-owned fit and
    shapes K9's plan-owned rows in place; K10's plan reads those rows
    after it.  On the card K10's group index is checked with one host
    read, through the seam."""
    caps = TurnCapsPlan(st, state.node_idle, state.node_releasing, state.node_ports,
                        state.node_num_tasks, s_max, best_effort_pass, preds_on, policy)
    index = None
    if st.device.type == "cuda":
        gstart, gidx, bad = build_group_index(st)
        (n_bad,) = yield from read(bad.reshape(()))
        index = (gstart, gidx, n_bad == 0)
    fill = TurnFillPlan(st, caps.k, caps.nperm, state.group_placed, state.node_idle,
                        state.node_releasing, state.node_ports, state.node_num_tasks,
                        state.task_status, state.task_node, s_max, best_effort_pass, preds_on,
                        index=index)
    if not pa_on:
        return caps, None, None, fill
    fit = PaFitPlan(st)
    return caps, fit, PaShapePlan(st, fit.fit, caps.k, caps.nperm), fill


def _process_queue(q, st, sess, state, tiers, s_max, best_effort_pass, policy, preds_on, pa_on,
                   plans=None, pick=None):
    """One queue's turn on the immediate path, in place (the reference's
    _process_queue, :553-706): selection from the current aggregates,
    then K11 / K9 / K12 / K10 and the aggregate commit.  ``q`` is i64[1];
    a padding or drained queue's turn places nothing.  ``plans`` is the
    action's (K9, K11, K12, K10 plans; K11's and K12's None without pod
    affinity) from :func:`_turn_plans`; None builds them for this turn
    alone.  ``pick`` is the action's K2 plan (None: one for this turn)."""
    if plans is None:
        plans = _turn_plans(st, state, s_max, best_effort_pass, policy, preds_on, pa_on)
    caps_plan, fit_plan, shape_plan, fill_plan = plans
    if best_effort_pass:
        q_ok = st.queue_valid[q]  # backfill has no queue-fairness gate
    else:
        q_ok = st.queue_valid[q] & ~overused(state.queue_alloc, sess.deserved)[q]
    shared = _selection_shared(st, sess, state, tiers, best_effort_pass)
    j, g, has_grp, req, budget = select_turns(
        st, sess, state, tiers, s_max, "backfill" if best_effort_pass else "allocate",
        shared, q, q_ok, pick,
    )
    req1 = req[0].contiguous()
    fit = None if fit_plan is None else fit_plan(g, state.task_status, state.task_node)
    caps_plan(g, req1, None if fit is None else fit.ok)  # k, nperm: K10's bound rows
    if shape_plan is not None:
        shape_plan()  # k in place
    placed, use_rel = fill_plan(g, req1, budget)  # plan-owned: consumed below
    # capacity-limited (not budget-limited) groups can never place again
    if best_effort_pass:
        unfit_now = has_grp & (placed < budget)
    else:
        unfit_now = has_grp & use_rel & (placed < budget)
    ptf = placed.to(torch.float32)[:, None] * req
    state.job_alloc.index_put_((j,), ptf, accumulate=True)
    state.queue_alloc.index_put_((q,), ptf, accumulate=True)
    state.job_ready_cnt.index_put_((j,), placed, accumulate=True)
    state.group_placed.index_put_((g,), placed, accumulate=True)
    state.group_unfit.index_put_((g,), state.group_unfit[g] | unfit_now)
    # marking a group unfit is progress: the queue's next job gets a turn
    state.progress = state.progress | (placed > 0)[0] | unfit_now[0]


def _rounds_immediate(st, sess, state, tiers, s_max, max_rounds, best_effort_pass):
    """The immediate path's round loop: each round's active queues in
    queue order, one turn each; one host read per round (a generator of
    them)."""
    policy = node_order_policy(tiers)
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    pa_on = preds_on and pa_enabled(st)
    # K9's, K11's, K12's, K10's, K17's and K2's launches over this action: checked and
    # bound once
    plans = yield from _turn_plans.steps(st, state, s_max, best_effort_pass, policy, preds_on,
                                         pa_on)
    order = QueueOrderPlan(tiers, sess.deserved, st.queue_uid_rank)
    pick = TurnPickPlan(st, tiers)
    while True:
        grp_live = group_live_mask(st, sess, state.group_placed, state.group_unfit,
                                   best_effort_pass)
        q_active = st.queue_valid & queue_has_live_job(st, grp_live)
        if not best_effort_pass:
            q_active = q_active & ~overused(state.queue_alloc, sess.deserved)
        nq, perm = queue_perm(tiers, q_active, state.queue_alloc, sess.deserved,
                              st.queue_uid_rank, order)
        go, trip = yield from read(state.progress, nq)
        if not (go and state.rounds < max_rounds):
            return state
        state.progress = torch.zeros_like(state.progress)
        for qi in range(max(trip, 1)):
            _process_queue(perm[qi:qi + 1], st, sess, state, tiers, s_max, best_effort_pass,
                           policy, preds_on, pa_on, plans, pick)
        state.rounds += 1


@stepped
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

    ``turn_batch``: None takes the batched deferred-decode round when
    :func:`_use_deferred_decode` allows it, else the immediate turn loop;
    False forces the immediate loop (the reference's parity path); True
    requires the batched round and raises ValueError where it is not
    legal.

    ``prune`` (batched round only): None enables feasibility pre-pruning
    when N // 8 >= ``prune_floor``; the panel is the smallest of N//8,
    N//4 or full that the largest class's feasible-node count fits."""
    legal = _use_deferred_decode(st, tiers)
    if turn_batch and not legal:
        raise ValueError(
            "turn_batch=True but the batched round is not legal for this pack / tiers "
            "(node order, pod affinity, or cell cap)"
        )
    defer = legal if turn_batch is None else bool(turn_batch)
    N = st.num_nodes
    if prune is None:
        prune = defer and N // 8 >= prune_floor
    if prune and not defer:
        raise ValueError("prune=True requires the batched round; the immediate loop is full width")
    entry_placed = state.group_placed.clone()
    state = _copy(state)
    dev = st.device
    state.progress = torch.ones((), dtype=torch.bool, device=dev)
    state.rounds, state.rounds_gated, state.claim_conflicts = 0, 0, 0
    state.group_unfit = torch.zeros_like(state.group_unfit)
    if not defer:
        return (yield from _rounds_immediate(st, sess, state, tiers, s_max, max_rounds,
                                             best_effort_pass))

    prune_idx = None
    if prune:
        # one compaction at N // 4: when every class fits N // 8, its
        # first N // 8 columns are the N // 8 compaction
        panel, counts = _compact_rows(_prune_cells(st, state, tiers, best_effort_pass), N // 4)
        (cmax,) = yield from read(counts.max())
        if cmax <= N // 8:
            prune_idx = panel[:, :N // 8].contiguous()
        elif cmax <= N // 4:
            prune_idx = panel

    G = st.num_groups
    gn_a = torch.zeros((G, N), dtype=torch.int32, device=dev)
    # backfill (best-effort) never pipelines
    gn_p = None if best_effort_pass else torch.zeros((G, N), dtype=torch.int32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    gn = (gn_a, gn_p, no, no)
    # K1's, K17's, K2's and K3's launches over this action: checked and bound once
    admit = AdmitPlan(st, state.node_idle, state.node_releasing, state.node_ports,
                      state.node_num_tasks, gn_a, gn_p, prune_idx, s_max, best_effort_pass,
                      plugin_on(tiers, "predicates", "predicate_disabled"), TURN_CHUNK)
    order = QueueOrderPlan(tiers, sess.deserved, st.queue_uid_rank)
    pick = TurnPickPlan(st, tiers)
    # counts -> placements, allocated before pipelined, into the state's
    # own (cloned) status / node; gated on the device by any_a / any_p
    decode = DecodePlan(gn_a, gn_p, st.task_group, st.task_group_rank, st.task_valid,
                        entry_placed, state.task_status, state.task_node)
    while state.rounds < max_rounds:
        (go,) = yield from read(state.progress)
        if not go:
            break
        state.progress = torch.zeros((), dtype=torch.bool, device=dev)
        gn = yield from _round(st, sess, state, tiers, s_max, best_effort_pass, gn, admit, order,
                               pick)
    decode(gn[2], gn[3])
    return state


@stepped
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
    return (yield from allocate_action.steps(
        st, sess, state, tiers, s_max=s_max, max_rounds=max_rounds, best_effort_pass=True,
    ))
