"""The preempt and reclaim actions (the port of kube_arbitrator_tpu/ops/
preempt.py).

* preempt (preempt.go:43-253): per queue, a job with pending tasks evicts
  RUNNING tasks of other jobs of its queue (phase 1), then lower-priority
  running tasks of its own job (phase 2), gated by the tiered
  Preemptable verdicts (gang, drf).  An eviction records its claimant job
  in ``evicted_for``; the commit keeps it only if that job ends the cycle
  gang-ready.
* reclaim (reclaim.go:41-188): a non-overused queue's job evicts RUNNING
  tasks of other queues, gated by the Reclaimable verdicts (gang,
  proportion), one task claim per job per cycle.

Engines: preempt's batched round (``_rounds_batched``, the default,
with its incremental round gate) and sequential turn loop (``_rounds``,
which pod-affinity packs take: the claim reads the group's affinity
fit); reclaim's sequential canon walk over the pack's canon victim
layout (``_reclaim_canon``, the reference's default), the opt-in
round-batched (``_reclaim_canon_batched``, ``turn_batch=True``) and
optimistic (``_reclaim_canon_optimistic``, ``turn_batch="optimistic"``
and the ``reclaim_optimistic`` action) engines over the same layout,
and, for packs without the canon pack or with pod affinity,
``_reclaim_fast`` over victim layouts sorted at action entry (its
claimant decode deferred to a claim log, or immediate under pod
affinity).  Every reclaim engine decides alike.

Kernels: K5 ``seg_scan`` runs every victim-layout scan (two per verdict
pass under the default tiers, three when drf's tier decides; two in the
canon seed; one in ``_reclaim_fast``'s entry), K6 ``claim_nodes`` the
node half of a preempt claim (with K11 ``pa_fit`` / K12 ``pa_shape``
under pod affinity), K7 ``canon_pick`` / K8 ``canon_commit`` a canon
reclaim turn, K13 ``round_products`` / K14 ``union_fit`` / K15
``window_gate`` the opt-in engines' products, picks and commit gate
(K8 commits their claims too), K16 ``stable_compact`` preempt's victim
panel; K2 picks jobs and groups and K4 sums per node, job and queue in
slot order.  Host reads: one per round (the progress flag and the
active-queue count together), one per preempt action for the
victim-panel tier and one for the gated-round count; the optimistic
engine reads once per speculation window instead of per round.  A turn
reads nothing on the host.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import torch

from ..api.types import TaskStatus
from ..cache.snapshot import SnapshotTensors, pa_enabled
from .allocate import (
    EVICT_PHASE_PREEMPT,
    EVICT_PHASE_PREEMPT_INTRA,
    EVICT_PHASE_RECLAIM,
    AllocState,
    SessionCtx,
    _copy,
    _host,
    _scatter_any,
    _scatter_count,
    _selection_shared,
    group_live_mask,
    queue_has_live_job,
    queue_perm,
    select_turns,
)
from .common import (
    BIG, EPS, fair, lex_argmin, lexsort, mm_cumsum, plugin_on, safe_share, seg_cumsum,
)
from .fairness import drf_shares
from .kernels.canon_commit import _scatter_set, canon_commit
from .kernels.canon_pick import canon_pick
from .kernels.claim_nodes import claim_nodes
from .kernels.round_products import new_products, round_products
from .kernels.seg_scan import seg_scan
from .kernels.segment_sum import segment_order, segment_sum
from .kernels.stable_compact import stable_compact
from .kernels.stable_sort import sorted_lookup, stable_sort
from .kernels.union_fit import union_fit
from .kernels.window_gate import (
    CONFLICTS, GATED, ROUND_DONE, START, TRIP, new_gate, window_gate,
)
from .ordering import Tiers, group_order_keys, job_order_keys
from .podaffinity import pa_shape, pod_affinity_fit

RUNNING = int(TaskStatus.RUNNING)
RELEASING = int(TaskStatus.RELEASING)
PIPELINED = int(TaskStatus.PIPELINED)
INT_MAX = 2**31 - 1
INT_MIN = -(2**31)
SHARE_DELTA = 1e-6  # drf.go:28 shareDelta

# Batched-round gate: above this many [panel, J] / [panel, G] selection
# cells the action takes the sequential turn loop.
TURN_BATCH_MAX_CELLS = 1 << 22
# Active-queue panel of the batched round's selection; a round with more
# active queues runs its overflow turns through the sequential turn.
TURN_PANEL = 32


# ---------------------------------------------------------------- victim view


@dataclasses.dataclass(frozen=True)
class SortLayout:
    """One fixed victim order (priority, uid within a segment key) with
    its segment starts, built once per action."""

    order: torch.Tensor       # i32[P] sorted position -> panel slot
    seg_start: torch.Tensor   # bool[P] sorted position starts a segment
    res_sorted: torch.Tensor  # f32[P, R] resreq in sorted order

    @classmethod
    def build(cls, segment, priority, uid_rank, resreq, extra_keys=()):
        """``segment`` is one i32[P] key or a tuple of them (grouped by all
        jointly; lexsort order, the last the primary)."""
        segs = segment if isinstance(segment, tuple) else (segment,)
        order = lexsort((uid_rank, priority) + tuple(extra_keys) + segs)
        seg_start = torch.zeros(order.shape[0], dtype=torch.bool, device=order.device)
        seg_start[0] = True
        for s in segs:
            s_s = s[order]
            seg_start[1:] |= s_s[1:] != s_s[:-1]
        return cls(order=order.to(torch.int32), seg_start=seg_start,
                   res_sorted=resreq[order].contiguous())

    def rank_and_cum(self, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per slot: the exclusive in-segment rank among ``mask`` (i32)
        and the inclusive cumulative resreq of ``mask`` (f32), through K5.
        Segment-local: a slot's values depend on its own segment only."""
        return seg_scan(mask, self.order, self.seg_start, self.res_sorted)


@dataclasses.dataclass(frozen=True)
class VictimLayouts:
    """The three victim orders a preempt phase needs; every segment is
    queue-pure, so one scan over a round's union mask gives each queue
    what its own mask would."""

    by_job: SortLayout
    by_queue: SortLayout
    by_node_queue: SortLayout


@dataclasses.dataclass(frozen=True)
class VictimView:
    """The compacted victim panel [P] shared by both preempt phases
    (padding slots: idx T, job J, queue Q, node N), with the slot orders
    K4 sums over."""

    idx: torch.Tensor       # i32[P] panel slot -> task (T = padding)
    valid: torch.Tensor     # bool[P]
    job: torch.Tensor       # i32[P]
    queue: torch.Tensor     # i32[P]
    node: torch.Tensor      # i32[P]
    priority: torch.Tensor  # i32[P]
    resreq: torch.Tensor    # f32[P, R]
    layouts: VictimLayouts
    node_order: tuple       # segment_order(node, N)
    job_order: tuple        # segment_order(job, J)
    queue_order: tuple      # segment_order(queue, Q)

    def running(self, task_status: torch.Tensor) -> torch.Tensor:
        """bool[P]: panel slots still RUNNING — the candidate predicate of
        every turn and of the round gate."""
        T = task_status.shape[0]
        return self.valid & (task_status[self.idx.clamp(max=T - 1).to(torch.int64)] == RUNNING)


def _build_view(st: SnapshotTensors, state: AllocState, qualify: torch.Tensor, P: int) -> VictimView:
    """Stable-compact ``qualify`` into a [P] panel through K16, padded
    with T (callers guarantee the count fits)."""
    T, J, Q, N = st.num_tasks, st.num_jobs, st.num_queues, st.num_nodes
    idx = stable_compact(qualify[None, :], P, T)[0][0]
    valid = idx < T
    idxc = idx.clamp(max=T - 1).to(torch.int64)
    job = torch.where(valid, st.task_job[idxc], J).to(torch.int32)
    queue = torch.where(valid, st.job_queue[job.clamp(0, J - 1).to(torch.int64)], Q).to(torch.int32)
    node = torch.where(valid, state.task_node[idxc], N).to(torch.int32)
    priority = torch.where(valid, st.task_priority[idxc], INT_MAX).to(torch.int32)
    uid = torch.where(valid, st.task_uid_rank[idxc], INT_MAX).to(torch.int32)
    resreq = torch.where(valid[:, None], st.task_resreq[idxc], 0.0).contiguous()
    layouts = VictimLayouts(
        by_job=SortLayout.build(job, priority, uid, resreq),
        by_queue=SortLayout.build(queue, priority, uid, resreq),
        # node is the primary key; queue splits each node block
        by_node_queue=SortLayout.build((queue, node), priority, uid, resreq),
    )
    return VictimView(
        idx=idx, valid=valid, job=job, queue=queue, node=node, priority=priority,
        resreq=resreq, layouts=layouts, node_order=segment_order(node, N),
        job_order=segment_order(job, J), queue_order=segment_order(queue, Q),
    )


# ---------------------------------------------------------------- preempt turn


def _victim_verdict(st, state, sess, tiers, candidates, claimant_job, req, view):
    """Tiered Preemptable victim filter (session_plugins.go:59-140: the
    first tier with an enabled verdict plugin decides, its verdicts
    intersected).  ``claimant_job`` i64[P] and ``req`` f32[P, R] are per
    slot, so one call serves every queue of a round."""
    J = st.num_jobs
    vj = view.job.clamp(max=J - 1).to(torch.int64)
    layouts = view.layouts
    job_rank, job_cum = layouts.by_job.rank_and_cum(candidates)

    def gang_ok():
        # the victim's job must stay gang-viable as victims accumulate
        cap = (state.job_ready_cnt - sess.min_avail).clamp(min=0)
        return candidates & (job_rank < cap[vj])

    def drf_ok():
        total = sess.drf_total
        _, queue_cum = layouts.by_queue.rank_and_cum(candidates)
        supported = torch.where(req > 0, queue_cum / req.clamp(min=1e-30), BIG).amin(dim=-1)
        supported = torch.floor((supported - 1.0).clamp(min=0.0))
        ls = safe_share(
            state.job_alloc[claimant_job] + (supported[:, None] + 1.0) * req, total[None, :]
        ).amax(dim=-1)
        rs = safe_share(state.job_alloc[vj] - job_cum, total[None, :]).amax(dim=-1)
        return candidates & ((ls < rs) | ((ls - rs).abs() <= SHARE_DELTA))

    verdict_fns = {"gang": gang_ok, "drf": drf_ok}
    for tier in tiers:
        masks = [
            verdict_fns[p.name]()
            for p in tier.plugins
            if p.name in verdict_fns and not p.preemptable_disabled
        ]
        if not masks:
            continue
        out = masks[0]
        for m in masks[1:]:
            out = out & m
        return out
    return torch.zeros_like(candidates)


def _phase_budget(mode, budget, was_ready, need, has_grp, grp_rem_g, s_max):
    """Preempt's statement budget: a not-ready claimant pops exactly its
    tasks-to-ready gap; re-clamped to the decodable ``s_max``."""
    if mode == "preempt":
        budget = torch.where(
            was_ready, budget,
            torch.where(has_grp, torch.minimum(need.clamp(min=1), grp_rem_g), 0),
        )
    return budget.clamp(max=s_max).to(torch.int32)


def claim_aggregates(st, view, victims):
    """(node_victims i32[N], totfree f32[N, R], vmax, vmin f32[N, R]): the
    per-node victim count and resreq sums in slot order (K4) and the
    order-free max / min (-BIG / BIG where a node has no victim)."""
    N, R = st.num_nodes, view.resreq.shape[1]
    vres = torch.where(victims[:, None], view.resreq, 0.0)
    agg = segment_sum(
        torch.cat([victims.to(torch.float32)[:, None], vres], dim=1), view.node, N,
        order=view.node_order,
    )
    vsel = torch.where(victims, view.node, N).to(torch.int64)[:, None].expand(-1, R)
    vmax = torch.full((N + 1, R), -BIG, dtype=torch.float32, device=st.device)
    vmax.scatter_reduce_(0, vsel, torch.where(victims[:, None], view.resreq, -BIG), "amax")
    vmin = torch.full((N + 1, R), BIG, dtype=torch.float32, device=st.device)
    vmin.scatter_reduce_(0, vsel, torch.where(victims[:, None], view.resreq, BIG), "amin")
    return (agg[:, 0].to(torch.int32), agg[:, 1:].contiguous(), vmax[:N].contiguous(),
            vmin[:N].contiguous())


def _apply_claim(st, sess, state, tiers, s_max, mode, view, q, j, g, has_grp, req, budget,
                 was_ready, need, victims, node_rank, node_cum) -> None:
    """The selection-independent tail of one queue turn, in place: per-node
    aggregates (K4), claim capacity / prefix fill / evict rule (K6), the
    claimant decode and the state scatters.  ``q``/``j``/``g`` are i64[1],
    ``has_grp``/``was_ready`` bool[1], ``budget``/``need`` i32[1], ``req``
    f32[R]; ``victims`` is this queue's verdict mask."""
    J, Q, N = st.num_jobs, st.num_queues, st.num_nodes
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    pa = None
    if preds_on and pa_enabled(st):
        fit = pod_affinity_fit(st, g, state.task_status, state.task_node)
        pa = (fit.ok, lambda cap: pa_shape(st, fit, cap[None, :])[0])
    p, cum, placed, evict = claim_nodes(
        st, *claim_aggregates(st, view, victims), state.node_ports, state.node_num_tasks,
        victims, view.node, view.resreq, node_rank, node_cum, g, req, budget, has_grp,
        was_ready, need, s_max, mode == "preempt", preds_on, pa,
    )
    placed_total, placed_pre = placed[0:1], placed[1:2]
    freed = segment_sum(torch.where(evict[:, None], view.resreq, 0.0), view.node, N,
                        order=view.node_order)

    # ---- claimant decode (the identity when nothing is placed)
    placed_before = state.group_placed[g]
    slots = torch.arange(s_max, dtype=torch.int32, device=st.device)
    node_of_slot = torch.searchsorted(cum, slots, right=True, out_int32=True)
    slot_of_task = st.task_group_rank - placed_before
    assigned = (
        (st.task_group == g) & (slot_of_task >= 0) & (slot_of_task < placed_total) & st.task_valid
    )
    tnode = node_of_slot[slot_of_task.clamp(0, s_max - 1).to(torch.int64)]

    # ---- state scatters; the evicted panel slots are distinct tasks
    uncond = mode == "preempt_intra"
    _scatter_set(state.task_status, view.idx, evict, RELEASING)
    state.task_status = torch.where(assigned, PIPELINED, state.task_status)
    state.task_node = torch.where(assigned, tnode, state.task_node)
    _scatter_set(state.evicted_for, view.idx, evict, -2 if uncond else j.to(torch.int32))
    ptf = placed_total.to(torch.float32) * req
    neg_res = -torch.where(evict[:, None], view.resreq, 0.0)
    segment_sum(neg_res, view.job, J, out=state.job_alloc, order=view.job_order)
    state.job_alloc[j] = state.job_alloc[j] + ptf
    segment_sum(neg_res, view.queue, Q, out=state.queue_alloc, order=view.queue_order)
    state.queue_alloc[q] = state.queue_alloc[q] + ptf
    segment_sum(-evict.to(torch.int32), view.job, J, out=state.job_ready_cnt, order=view.job_order)
    state.job_ready_cnt[j] = state.job_ready_cnt[j] + placed_total
    if preds_on:
        gports = st.group_ports[g]
        has_ports = (gports != 0).any()
        state.node_ports = torch.where(
            ((p > 0) & has_ports)[:, None], state.node_ports | gports, state.node_ports
        )
    state.node_releasing = state.node_releasing + freed - p.to(torch.float32)[:, None] * req[None, :]
    state.node_num_tasks = state.node_num_tasks + p
    state.group_placed[g] = state.group_placed[g] + placed_total
    short = has_grp & (placed_pre < budget)
    state.group_unfit[g] = state.group_unfit[g] | short
    _scatter_set(state.evict_claimant, view.idx, evict, j.to(torch.int32))
    _scatter_set(state.evict_phase, view.idx, evict,
                 EVICT_PHASE_PREEMPT_INTRA if uncond else EVICT_PHASE_PREEMPT)
    _scatter_set(state.evict_round, view.idx, evict, state.rounds)
    # unfit-marking counts as progress so later jobs still get a turn
    state.progress = state.progress | (placed_total > 0)[0] | short[0]


def _claim_turn(q, st, sess, state, tiers, s_max, mode, view) -> None:
    """One queue turn of a preempt phase, sequentially: selection, the
    verdict over this queue's scope, then the shared claim tail."""
    P = view.idx.shape[0]
    q_ok = st.queue_valid[q]  # preempt has no overused gate
    shared = _selection_shared(st, sess, state, tiers, None)
    grp_remaining, job_ready = shared[0], shared[3]
    j, g, has_grp, req, budget = select_turns(st, sess, state, tiers, s_max, mode, shared, q, q_ok)
    was_ready = job_ready[j]
    need = (sess.min_avail[j] - state.job_ready_cnt[j]).clamp(min=0)
    budget = _phase_budget(mode, budget, was_ready, need, has_grp, grp_remaining[g], s_max)
    p_running = view.running(state.task_status)
    if mode == "preempt":
        scope = p_running & (view.job != j) & (view.queue == q)
    else:  # lower-priority running tasks of the claimant's own job
        scope = p_running & (view.job == j) & (view.priority < st.group_priority[g])
    victims = _victim_verdict(
        st, state, sess, tiers, scope, j.expand(P), req.expand(P, req.shape[1]), view,
    ) & has_grp
    node_rank, node_cum = view.layouts.by_node_queue.rank_and_cum(victims)
    _apply_claim(st, sess, state, tiers, s_max, mode, view, q, j, g, has_grp, req[0], budget,
                 was_ready, need, victims, node_rank, node_cum)


# ---------------------------------------------------------------- preempt rounds


def _round_gate(st, sess, s, mode, view):
    """bool[Q]: the queues that get a turn this round — live-claimant
    queues whose victim scope can be non-empty (phase 1: two jobs of the
    queue with running tasks, or one and a claimant that is not it;
    phase 2: a running task of lower priority in a claimant's own job).
    One definition for both engines; a skipped turn could only have
    marked its group unfit."""
    J, Q = st.num_jobs, st.num_queues
    p_running = view.running(s.task_status)
    grp_live = group_live_mask(st, sess, s.group_placed, s.group_unfit)
    q_active = st.queue_valid & queue_has_live_job(st, grp_live)
    if mode == "preempt":
        run_job = _scatter_any(view.job, p_running, J)
        nrun = _scatter_count(st.job_queue, run_job, Q)
        job_claim = _scatter_any(st.group_job, grp_live, J)
        claim_not_run = _scatter_any(st.job_queue, job_claim & ~run_job & st.job_valid, Q)
        possible = (nrun >= 2) | ((nrun == 1) & claim_not_run)
    else:
        minp = torch.full((J + 1,), INT_MAX, dtype=torch.int32, device=st.device)
        minp.scatter_reduce_(0, view.job.to(torch.int64),
                             torch.where(p_running, view.priority, INT_MAX), "amin")
        g_pos = grp_live & (minp[st.group_job.to(torch.int64)] < st.group_priority)
        possible = _scatter_any(st.job_queue[st.group_job.to(torch.int64)], g_pos, Q)
    return q_active & possible


def _queue_perm(st, sess, s, tiers, q_active):
    return queue_perm(tiers, q_active, s.queue_alloc, sess.deserved, st.queue_uid_rank)


def _start_rounds(state: AllocState) -> None:
    state.progress = torch.ones((), dtype=torch.bool, device=state.progress.device)
    state.group_unfit = torch.zeros_like(state.group_unfit)


def _rounds(st, sess, state, tiers, s_max, max_rounds, mode, view) -> AllocState:
    """The sequential turn loop: each active queue's full turn in the
    round's queue order.  The rounds counter accumulates over phases."""
    _start_rounds(state)
    while True:
        q_active = _round_gate(st, sess, state, mode, view)
        nq, perm = _queue_perm(st, sess, state, tiers, q_active)
        go, trip = _host(state.progress, nq)
        if not (go and state.rounds < max_rounds):
            return state
        state.progress = torch.zeros_like(state.progress)
        for qi in range(trip):
            _claim_turn(perm[qi:qi + 1], st, sess, state, tiers, s_max, mode, view)
        state.rounds += 1


def _rounds_batched(st, sess, state, tiers, s_max, max_rounds, mode, view, round_gate=True):
    """The batched turn kernel: per round, every panel queue's selection,
    budget, union verdict and (node, queue) scans at once; the claim tails
    run in the round's queue order (the node pool is the only cross-queue
    channel).  With ``round_gate``, a round after a round that committed
    nothing keeps the carried verdicts and scans of the queues whose
    selection did not change and recomputes the rest — decision-identical,
    and counted in ``rounds_gated``.  (The reference also carries the
    victim-pool half of the round gate through such rounds; nothing was
    committed, so ``task_status`` and that half are unchanged, and the
    port recomputes it.)"""
    Q, R, P = st.num_queues, st.task_resreq.shape[1], view.idx.shape[0]
    QA = min(Q, TURN_PANEL)
    dev = st.device
    _start_rounds(state)
    i64 = torch.int64
    have = False
    placed_prev = torch.full((), -1, dtype=i64, device=dev)
    vic_valid = torch.zeros(Q, dtype=torch.bool, device=dev)
    j_c = torch.zeros(Q, dtype=i64, device=dev)
    g_c = torch.zeros(Q, dtype=i64, device=dev)
    has_c = torch.zeros(Q, dtype=torch.bool, device=dev)
    req_c = torch.zeros((Q, R), dtype=torch.float32, device=dev)
    vic_c = torch.zeros(P, dtype=torch.bool, device=dev)
    nr_c = torch.zeros(P, dtype=torch.int32, device=dev)
    ncum_c = torch.zeros((P, R), dtype=torch.float32, device=dev)
    gated_rounds = torch.zeros((), dtype=i64, device=dev)
    qp_s = view.queue.clamp(max=Q - 1).to(i64)

    def verdicts_of(s, q_active, j_sel, g_sel, has_grp, req_all, scope_limit):
        p_running = view.running(s.task_status)
        cl = j_sel[qp_s]
        slot_on = view.valid & q_active[qp_s] & has_grp[qp_s] & scope_limit[qp_s]
        if mode == "preempt":
            scope = p_running & (view.job != cl) & slot_on
        else:
            scope = (p_running & (view.job == cl)
                     & (view.priority < st.group_priority[g_sel[qp_s]]) & slot_on)
        victims = _victim_verdict(st, s, sess, tiers, scope, cl, req_all[qp_s], view)
        node_rank, node_cum = view.layouts.by_node_queue.rank_and_cum(victims)
        return victims, node_rank, node_cum

    while True:
        placed_entry = state.group_placed.sum(dtype=i64)
        committed = placed_entry != placed_prev
        if round_gate and have:
            gated = ~committed
        else:
            gated = torch.zeros((), dtype=torch.bool, device=dev)
        vic_valid = vic_valid & ~committed
        q_active = _round_gate(st, sess, state, mode, view)
        nq, perm = _queue_perm(st, sess, state, tiers, q_active)
        go, trip = _host(state.progress, nq)
        if not (go and state.rounds < max_rounds):
            break
        state.progress = torch.zeros_like(state.progress)

        shared = _selection_shared(st, sess, state, tiers, None)
        grp_remaining, job_ready = shared[0], shared[3]
        q_panel = perm[:QA]
        jp, gp, hgp, reqp, budp = select_turns(
            st, sess, state, tiers, s_max, mode, shared, q_panel, q_active[q_panel]
        )
        wrp = job_ready[jp]
        needp = (sess.min_avail[jp] - state.job_ready_cnt[jp]).clamp(min=0)
        budp = _phase_budget(mode, budp, wrp, needp, hgp, grp_remaining[gp], s_max)
        same = (
            (jp == j_c[q_panel]) & (gp == g_c[q_panel]) & (hgp == has_c[q_panel])
            & (reqp == req_c[q_panel]).all(dim=-1)
        )
        fresh = ~gated | ~same | ~vic_valid[q_panel]
        changed = torch.zeros(Q, dtype=torch.bool, device=dev)
        changed[q_panel] = q_active[q_panel] & fresh
        vic_valid = vic_valid | changed
        j_sel, g_sel, has_grp, req_all = j_c.clone(), g_c.clone(), has_c.clone(), req_c.clone()
        j_sel[q_panel], g_sel[q_panel], has_grp[q_panel], req_all[q_panel] = jp, gp, hgp, reqp
        budget_all = torch.zeros(Q, dtype=torch.int32, device=dev)
        was_ready = torch.zeros(Q, dtype=torch.bool, device=dev)
        need = torch.zeros(Q, dtype=torch.int32, device=dev)
        budget_all[q_panel], was_ready[q_panel], need[q_panel] = budp, wrp, needp
        vf, nrf, ncf = verdicts_of(state, q_active, j_sel, g_sel, has_grp, req_all, changed)
        # unchanged active queues keep their carried verdicts and scans;
        # (node, queue) segments are queue-pure, so nothing leaks across
        chg_s = changed[qp_s]
        victims_all = torch.where(chg_s, vf, vic_c)
        node_rank = torch.where(chg_s, nrf, nr_c)
        node_cum = torch.where(chg_s[:, None], ncf, ncum_c)

        for qi in range(min(trip, QA)):
            q = perm[qi:qi + 1]
            _apply_claim(
                st, sess, state, tiers, s_max, mode, view, q, j_sel[q], g_sel[q], has_grp[q],
                req_all[q][0], budget_all[q], was_ready[q], need[q],
                victims_all & (view.queue == q), node_rank, node_cum,
            )
        for qi in range(QA, trip):  # overflow turns: the full sequential turn
            _claim_turn(perm[qi:qi + 1], st, sess, state, tiers, s_max, mode, view)
        state.rounds += 1
        gated_rounds = gated_rounds + gated.to(i64)
        have, placed_prev = True, placed_entry
        j_c, g_c, has_c, req_c = j_sel, g_sel, has_grp, req_all
        vic_c, nr_c, ncum_c = victims_all, node_rank, node_cum
    state.rounds_gated += int(gated_rounds)
    return state


def _entry_qualify(st, sess, state, running0):
    """bool[T]: tasks that could be a victim of phase 1 (same queue, other
    job) or phase 2 (same job, lower priority) at action entry; both sets
    only shrink during the action."""
    J, Q = st.num_jobs, st.num_queues
    grp_live0 = group_live_mask(st, sess, state.group_placed, None)
    tq = st.job_queue[st.task_job.to(torch.int64)].to(torch.int64)
    run_job0 = _scatter_any(st.task_job, running0, J)
    nrun0 = _scatter_count(st.job_queue, run_job0, Q)
    job_claim0 = _scatter_any(st.group_job, grp_live0, J)
    claim_not_run0 = _scatter_any(st.job_queue, job_claim0 & ~run_job0 & st.job_valid, Q)
    claim_any0 = _scatter_any(st.job_queue, job_claim0 & st.job_valid, Q)
    possible1 = claim_any0 & ((nrun0 >= 2) | ((nrun0 == 1) & claim_not_run0))
    qual1 = running0 & possible1[tq]
    maxgp = torch.full((J,), INT_MIN, dtype=torch.int32, device=st.device)
    maxgp.scatter_reduce_(0, st.group_job.to(torch.int64),
                          torch.where(grp_live0, st.group_priority, INT_MIN), "amax")
    qual2 = running0 & (st.task_priority < maxgp[st.task_job.to(torch.int64)])
    return qual1 | qual2


def turn_batch_fallback_reason(st: SnapshotTensors, tiers: Tiers):
    """Why ``preempt_action``'s auto ``turn_batch`` would take the
    sequential turn loop (None: the batched engine)."""
    if plugin_on(tiers, "predicates", "predicate_disabled") and pa_enabled(st):
        return "pod_affinity"
    panel_w = min(st.num_queues, TURN_PANEL)
    if (panel_w * st.num_jobs > TURN_BATCH_MAX_CELLS
            or panel_w * st.num_groups > TURN_BATCH_MAX_CELLS):
        return "cell_cap"
    return None


def preempt_action(
    st: SnapshotTensors,
    sess: SessionCtx,
    state: AllocState,
    tiers: Tiers,
    s_max: int = 4096,
    max_rounds: int = 100_000,
    panel_floor: int = 1024,
    turn_batch=None,
    round_gate=None,
) -> AllocState:
    """Phase 1 (inter-job within a queue), then phase 2 (intra-job
    priority), over one victim panel built at entry: T//8 or T//4 slots
    when the qualifying victims fit (a host read of their count), else
    the full width; snapshots with T//8 < ``panel_floor`` use the full
    width.  ``turn_batch`` None picks the batched engine unless
    :func:`turn_batch_fallback_reason` says otherwise; ``round_gate``
    None turns the incremental round gate on.  Returns a new state."""
    T = st.num_tasks
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    if turn_batch is None:
        turn_batch = turn_batch_fallback_reason(st, tiers) is None
    elif turn_batch and preds_on and pa_enabled(st):
        raise ValueError("turn_batch=True but pod affinity is enabled for this pack")
    rounds_fn = partial(_rounds_batched, round_gate=round_gate is None or bool(round_gate)) \
        if turn_batch else _rounds
    state = _copy(state)
    state.rounds, state.rounds_gated, state.claim_conflicts = 0, 0, 0
    running0 = (state.task_status == RUNNING) & st.task_valid & (state.task_node >= 0)
    P = T // 8
    if P < panel_floor:
        view = _build_view(st, state, running0, T)
    else:
        qualify = _entry_qualify(st, sess, state, running0)
        count = int(qualify.sum())
        if count <= P:
            view = _build_view(st, state, qualify, P)
        elif count <= T // 4:
            view = _build_view(st, state, qualify, T // 4)
        else:
            view = _build_view(st, state, running0, T)
    state = rounds_fn(st, sess, state, tiers, s_max, max_rounds, "preempt", view)
    return rounds_fn(st, sess, state, tiers, s_max, max_rounds, "preempt_intra", view)


# ---------------------------------------------------------------- reclaim


def _reclaim_verdict_names(tiers: Tiers):
    """The verdict plugins of the first tier with an enabled Reclaimable
    plugin (later tiers never contribute)."""
    for tier in tiers:
        names = [
            p.name for p in tier.plugins
            if p.name in ("gang", "proportion") and not p.reclaimable_disabled
        ]
        if names:
            return tuple(names)
    return ()


def _reclaim_flags(tiers: Tiers):
    """(use_gang, use_prop, preds_on) of a reclaim action under ``tiers``."""
    names = _reclaim_verdict_names(tiers)
    return ("gang" in names, "proportion" in names,
            plugin_on(tiers, "predicates", "predicate_disabled"))


def _claim_key_fits(num_groups: int, num_tasks: int) -> bool:
    """Does the claim log's (group, rank) join key fit int32?"""
    return num_groups * (num_tasks + 1) < 2**31


def _replay_claim_log(st, task_status, task_node, log_g, log_n, log_r):
    """Deferred claimant decode: claim k pipelined group ``log_g[k]``'s
    task of rank ``log_r[k]`` onto node ``log_n[k]``, joined on the
    (group, rank) key (unique: one claim per job)."""
    T = st.num_tasks
    J = log_g.shape[0]
    claim_key = torch.where(log_g >= 0, log_g * (T + 1) + log_r, INT_MAX).to(torch.int32)
    key_order, keys_sorted = stable_sort((claim_key,), want_sorted=True)  # K19
    task_key = (st.task_group.clamp(0, st.num_groups - 1) * (T + 1) + st.task_group_rank).to(torch.int32)
    pos, found = sorted_lookup(keys_sorted, task_key)  # K19
    pos_c = pos.clamp(0, J - 1)
    hit = found & (st.task_group >= 0) & st.task_valid
    tnode = log_n[key_order][pos_c]
    return torch.where(hit, PIPELINED, task_status), torch.where(hit, tnode, task_node)


@dataclasses.dataclass(frozen=True)
class _CanonCtx:
    """One-time gathers over the canon pack."""

    cj: torch.Tensor          # i32[Vp] slot -> job (J-1 padding)
    cq: torch.Tensor          # i32[Vp] slot -> queue (Q-1 padding)
    cres: torch.Tensor        # f32[Vp, R] victim resreq (0 padding)
    deserved_c: torch.Tensor  # f32[Vp, F] fair(deserved)[cq]
    cnode: torch.Tensor       # i32[Vp] slot -> node (N padding)
    cnode_order: tuple        # segment_order(cnode, N)
    min_avail: torch.Tensor   # i32[J] the session's gang floors
    # ascending (node, queue) segment key node * (Q + 1) + queue of the
    # valid slots (a contiguous prefix), a sentinel above every real key
    # on the padding; meaningful where the key fits int32 (the batched
    # engines' legality condition)
    skey: torch.Tensor        # i32[Vp]


def _canon_ctx(st: SnapshotTensors, sess: SessionCtx) -> _CanonCtx:
    J, Q, N = st.num_jobs, st.num_queues, st.num_nodes
    vidx = st.rv_idx.to(torch.int64)
    cvalid = st.rv_valid
    Vp = vidx.shape[0]
    cj = torch.where(cvalid, st.task_job[vidx], J - 1).to(torch.int32)
    cq = torch.where(cvalid, st.job_queue[cj.clamp(0, J - 1).to(torch.int64)], Q - 1).to(torch.int32)
    cres = torch.where(cvalid[:, None], st.task_resreq[vidx], 0.0).contiguous()
    deserved_c = fair(sess.deserved)[cq.to(torch.int64)].contiguous()
    cnode = torch.searchsorted(
        st.rv_block_start, torch.arange(Vp, dtype=torch.int32, device=st.device),
        right=True, out_int32=True,
    ) - 1
    skey = torch.where(cvalid, cnode.to(torch.int64) * (Q + 1) + cq, N * (Q + 1) + Q)
    return _CanonCtx(cj=cj, cq=cq, cres=cres, deserved_c=deserved_c, cnode=cnode,
                     cnode_order=segment_order(cnode, N), min_avail=sess.min_avail,
                     skey=skey.to(torch.int32).contiguous())


@dataclasses.dataclass
class _CanonCarry:
    """The canon walk's carried arrays (updated in place by K8)."""

    q_entries: torch.Tensor     # i32[Q] queue PQ entries left
    job_consumed: torch.Tensor  # bool[J] the job's one claim attempt is spent
    cand: torch.Tensor          # bool[Vp] live candidates
    evicted_c: torch.Tensor     # bool[Vp] evicted this action
    rank_nj: torch.Tensor       # f32[Vp] exclusive in-(node, job) candidate rank
    cum_nq: torch.Tensor        # f32[Vp, F] inclusive in-(node, queue) fair cumulative
    log_g: torch.Tensor         # i32[J+1] group per claim (row J: dropped writes)
    log_n: torch.Tensor         # i32[J+1] node per claim
    log_r: torch.Tensor         # i32[J+1] group rank per claim
    n_claims: torch.Tensor      # i32[1]


def _canon_seed(st, state, ctx) -> _CanonCarry:
    """The live candidate mask, the carried scans (two K5 launches), the
    queue entry budgets and an empty claim log."""
    J, Q = st.num_jobs, st.num_queues
    dev = st.device
    cand0 = st.rv_valid & (state.task_status[st.rv_idx.to(torch.int64)] == RUNNING)
    candf0 = cand0.to(torch.float32)
    rank_nj0 = seg_cumsum(candf0, st.rv_nj_start) - candf0
    cum_nq0 = seg_cumsum(torch.where(cand0[:, None], fair(ctx.cres), 0.0), st.rv_nq_start)
    return _CanonCarry(
        q_entries=_scatter_count(st.job_queue, st.job_valid, Q),
        job_consumed=torch.zeros(J, dtype=torch.bool, device=dev),
        cand=cand0.contiguous(),
        evicted_c=torch.zeros_like(cand0),
        rank_nj=rank_nj0.contiguous(),
        cum_nq=cum_nq0.contiguous(),
        log_g=torch.full((J + 1,), -1, dtype=torch.int32, device=dev),
        log_n=torch.zeros(J + 1, dtype=torch.int32, device=dev),
        log_r=torch.zeros(J + 1, dtype=torch.int32, device=dev),
        n_claims=torch.zeros(1, dtype=torch.int32, device=dev),
    )


def _reclaim_shared(st, sess, state, tiers, job_consumed):
    """Queue-independent pop inputs of one reclaim turn."""
    grp_elig = (
        group_live_mask(st, sess, state.group_placed, None)
        & ~job_consumed[st.group_job.to(torch.int64)]
    )
    job_has_pending = _scatter_any(st.group_job, grp_elig, st.num_jobs)
    job_ready = state.job_ready_cnt >= sess.min_avail
    job_share = drf_shares(state.job_alloc, sess.drf_total)
    jkeys = job_order_keys(tiers, st.job_priority, job_ready, st.job_creation_rank, job_share)
    gkeys = group_order_keys(tiers, st.group_priority, st.group_uid_rank)
    return grp_elig, job_has_pending, jkeys, gkeys


def _pops(st, sess, state, shared, q, q_entry):
    """Reclaim pops of the queues ``q`` i64[S] with entry budgets
    ``q_entry`` i32[S]: the OverusedFn row, the job pop over each queue's
    unconsumed jobs, the group pop (reclaim.go:54-105), both argmins
    batched through K2.  Returns (j, g, has_grp, req f32[S, R], pop,
    burn_now)."""
    grp_elig, job_has_pending, jkeys, gkeys = shared
    q_over = (fair(sess.deserved[q]) < fair(state.queue_alloc[q]) + EPS).all(dim=-1)
    active = st.queue_valid[q] & (q_entry > 0)
    jmask = ((st.job_queue[None, :] == q[:, None]) & (job_has_pending & st.job_valid)[None, :]
             & (active & ~q_over)[:, None])
    j, has_job = lex_argmin(jkeys, jmask)
    pop = active & ~q_over & has_job
    burn_now = active & (q_over | ~has_job)
    gmask = (st.group_job[None, :] == j[:, None]) & grp_elig[None, :] & pop[:, None]
    g, has_grp = lex_argmin(gkeys, gmask)
    return j, g, has_grp, st.group_resreq[g.to(torch.int64)], pop, burn_now


def _reclaim_pop(st, sess, state, tiers, shared, q, q_entry):
    """One queue's pop (``q`` i64[1]); ``req`` comes back as f32[R]."""
    j, g, has_grp, req, pop, burn_now = _pops(st, sess, state, shared, q, q_entry)
    return j, g, has_grp, req[0], pop, burn_now


def reclaim_select_turns(st, sess, state, tiers, shared, q_ids, q_entries):
    """Every panel row's pop at once (the reference's vmapped
    ``_reclaim_pop``, :2000-2010): ``q_ids`` i64[S], ``q_entries`` i32[Q].
    One definition with the single-queue pop; the two argmins are one K2
    launch each over [S, J] and [S, G]."""
    return _pops(st, sess, state, shared, q_ids, q_entries[q_ids])


def _canon_round_order(st, sess, tiers, state, carry):
    """(nq, perm): the round's active-queue count and queue order."""
    q_active = st.queue_valid & (carry.q_entries > 0) & queue_has_live_job(
        st, group_live_mask(st, sess, state.group_placed, None),
        job_extra=~carry.job_consumed,
    )
    return queue_perm(tiers, q_active, state.queue_alloc, sess.deserved, st.queue_uid_rank)


def _canon_writeback(st, state, carry) -> AllocState:
    """Once per action: evicted marks, statuses, claimant decode."""
    J = st.num_jobs
    _scatter_set(state.evicted_for, st.rv_idx, carry.evicted_c, -2)
    _scatter_set(state.task_status, st.rv_idx, carry.evicted_c, RELEASING)
    state.task_status, state.task_node = _replay_claim_log(
        st, state.task_status, state.task_node,
        carry.log_g[:J], carry.log_n[:J], carry.log_r[:J],
    )
    return state


def _reclaim_canon(st, sess, state, tiers, max_rounds) -> AllocState:
    """Cross-queue reclaim over the canon layout, pop for pop: per turn
    the queue's job / group pop (K2), the eligibility + per-node sums +
    first-fit node (K7) and the window commit (K8), no host read."""
    use_gang, use_prop, preds_on = _reclaim_flags(tiers)
    ctx = _canon_ctx(st, sess)
    state.progress = torch.ones((), dtype=torch.bool, device=st.device)
    state.rounds, state.rounds_gated, state.claim_conflicts = 0, 0, 0
    carry = _canon_seed(st, state, ctx)
    i32 = torch.int32
    while True:
        nq, perm = _canon_round_order(st, sess, tiers, state, carry)
        go, nq_h = _host(state.progress, nq)
        if not (go and state.rounds < max_rounds):
            break
        state.progress = torch.zeros((), dtype=torch.bool, device=st.device)
        for qi in range(max(nq_h, 1)):
            q = perm[qi:qi + 1]
            shared = _reclaim_shared(st, sess, state, tiers, carry.job_consumed)
            j, g, has_grp, req, pop, burn_now = _reclaim_pop(
                st, sess, state, tiers, shared, q, carry.q_entries[q]
            )
            q32, j32, g32 = q.to(i32), j.to(i32), g.to(i32)
            pick = canon_pick(
                st, ctx, carry.cand, carry.rank_nj, carry.cum_nq, state.job_ready_cnt,
                sess.min_avail, state.queue_alloc, state.node_ports, state.node_num_tasks,
                q32, g32, has_grp, pop, req, use_gang, use_prop, preds_on,
            )
            canon_commit(st, ctx, state, carry, pick, q32, j32, g32, has_grp, pop, burn_now,
                         req, use_gang, use_prop)
        state.rounds += 1
    return _canon_writeback(st, state, carry)


def _reclaim_panel(st: SnapshotTensors) -> int:
    """RP: the pop panel of the opt-in engines — every queue while the
    [panel, max(J, G)] selection cells stay under TURN_BATCH_MAX_CELLS,
    at least TURN_PANEL."""
    return min(st.num_queues,
               max(TURN_PANEL, TURN_BATCH_MAX_CELLS // max(st.num_jobs, st.num_groups, 1)))


def _round_products(st, sess, state, ctx, carry, use_gang, use_prop, out, dirty=None):
    """The union eligibility, per-node sums and (node, queue) segmented
    scan of the current state into ``out`` (K13; the reference's
    ``_round_products``, shared by both opt-in engines).  With ``dirty``,
    only where that device flag is set."""
    return round_products(st, ctx, carry.cand, carry.rank_nj, carry.cum_nq, state.job_ready_cnt,
                          sess.min_avail, state.queue_alloc, use_gang, use_prop, out, dirty)


def _union_fit(st, state, ctx, prods, preds_on, q, g, has_grp, req, pop):
    """First feasible node per row (K14): the union sums minus each row's
    own-queue segment totals (the reference's ``_union_minus_own``), then
    ``_fit_feasible``.  ``q``/``g`` i32[S], ``req`` f32[S, R]."""
    _, pn, segcum = prods
    return union_fit(st, ctx.skey, segcum, pn, q, g, has_grp, pop, req, state.node_ports,
                     state.node_num_tasks, preds_on)


def _reclaim_canon_batched(st, sess, state, tiers, max_rounds) -> AllocState:
    """The round-batched canon reclaim engine (the reference's
    ``_reclaim_canon_batched``, preempt.py:2384-2579), pop for pop equal
    to the canon walk.

    Per round: every panel queue's pop from round-start state (one K2
    launch pair over [RP, J] and [RP, G]) and the round products (K13).
    Per turn, in the round's queue order: the products refresh when the
    previous turn claimed (K13 reads K8's claimed bit on the device and
    returns at once otherwise); the turn takes its round-start pop until
    a claim lands in the round (or its queue is past the panel), a live
    pop after that (both are computed, ``torch.where`` picks); K14 picks
    the first feasible node from the union sums minus the queue's own
    segment totals; K8 commits.  A round with no claim and no turn past
    the panel ran on round-start products only and counts in
    ``rounds_gated``.  One host read per round, one per action for the
    gated count; none per turn.  The subtraction is exact while the sums
    of integral device units stay below 2^24, as in the reference."""
    use_gang, use_prop, preds_on = _reclaim_flags(tiers)
    ctx = _canon_ctx(st, sess)
    RP = _reclaim_panel(st)
    dev = st.device
    i32 = torch.int32
    state.progress = torch.ones((), dtype=torch.bool, device=dev)
    state.rounds, state.rounds_gated, state.claim_conflicts = 0, 0, 0
    carry = _canon_seed(st, state, ctx)
    Vp, R = ctx.cres.shape
    prods = new_products(Vp, st.num_nodes, R, dev)
    dirty = torch.zeros(1, dtype=torch.bool, device=dev)        # the last turn claimed
    claimed_any = torch.zeros(1, dtype=torch.bool, device=dev)  # a turn of this round claimed
    gated_rounds = torch.zeros((), dtype=i32, device=dev)
    while True:
        nq, perm = _canon_round_order(st, sess, tiers, state, carry)
        go, nq_h = _host(state.progress, nq)
        if not (go and state.rounds < max_rounds):
            break
        state.progress = torch.zeros((), dtype=torch.bool, device=dev)
        trip = max(nq_h, 1)
        panel = reclaim_select_turns(
            st, sess, state, tiers, _reclaim_shared(st, sess, state, tiers, carry.job_consumed),
            perm[:RP], carry.q_entries,
        )
        _round_products(st, sess, state, ctx, carry, use_gang, use_prop, prods)
        dirty.zero_()
        claimed_any.zero_()
        for qi in range(trip):
            _round_products(st, sess, state, ctx, carry, use_gang, use_prop, prods, dirty)
            q = perm[qi:qi + 1]
            live = _reclaim_pop(st, sess, state, tiers,
                                _reclaim_shared(st, sess, state, tiers, carry.job_consumed),
                                q, carry.q_entries[q])
            if qi < RP:
                rows = [x[qi:qi + 1] for x in panel]
                rows[3] = rows[3][0]
                live = [torch.where(claimed_any, lv, pv) for lv, pv in zip(live, rows)]
            j, g, has_grp, req, pop, burn_now = live
            q32, j32, g32 = q.to(i32), j.to(i32), g.to(i32)
            pick = _union_fit(st, state, ctx, prods, preds_on, q32, g32, has_grp,
                              req[None, :].contiguous(), pop)
            canon_commit(st, ctx, state, carry, pick, q32, j32, g32, has_grp, pop, burn_now, req,
                         use_gang, use_prop, claimed_out=dirty)
            claimed_any |= dirty
        state.rounds += 1
        if trip <= RP:
            gated_rounds += (~claimed_any).to(i32)[0]
    state.rounds_gated = int(gated_rounds)
    return _canon_writeback(st, state, carry)


def _reclaim_canon_optimistic(st, sess, state, tiers, max_rounds) -> AllocState:
    """The optimistic canon reclaim engine (the reference's
    ``_reclaim_canon_optimistic``, preempt.py:2623-2821), pop for pop
    equal to the canon walk.

    A speculation window is RP consecutive turns of the round's queue
    order from position START.  From window-start state: every row's
    pop (K2 over [RP, J] and [RP, G]), the products (K13) and every
    row's first feasible node (K14 over RP rows; a row outside the
    window does not pop).  The gate (K15) commits the burn / fail prefix
    before the first speculative claim, counts the later speculative
    claims as conflicts (discarded: the next window re-derives them from
    post-claim state), advances START and ends the round; K8 commits the
    accepted claim (nothing when the window has none).  A window that
    starts a round re-derives the queue order and resets progress; a
    continuation window keeps both, and runs whatever ``max_rounds``
    says (the round is finished first).  A round finished in its first
    window with no claim counts in ``rounds_gated``.  One host read per
    window (START, the round end, progress and the counters)."""
    use_gang, use_prop, preds_on = _reclaim_flags(tiers)
    ctx = _canon_ctx(st, sess)
    RP = _reclaim_panel(st)
    Q, N = st.num_queues, st.num_nodes
    dev = st.device
    i32 = torch.int32
    state.progress = torch.ones((), dtype=torch.bool, device=dev)
    state.rounds, state.rounds_gated, state.claim_conflicts = 0, 0, 0
    carry = _canon_seed(st, state, ctx)
    Vp, R = ctx.cres.shape
    prods = new_products(Vp, N, R, dev)
    ctl, sel = new_gate(R, dev)
    sel_i, sel_b, sel_req = sel
    w_iota = torch.arange(RP, dtype=torch.int64, device=dev)
    perm = torch.arange(Q, dtype=torch.int64, device=dev)
    start, progress, rounds, windows = 0, True, 0, 0
    vals = [0] * ctl.shape[0]
    while start > 0 or (progress and rounds < max_rounds):
        if start == 0:
            state.progress = torch.zeros((), dtype=torch.bool, device=dev)
            nq, perm = _canon_round_order(st, sess, tiers, state, carry)
            ctl[TRIP:TRIP + 1].copy_(nq.clamp(min=1).reshape(1))
        pos = w_iota + start
        q_panel = perm[pos.clamp(max=Q - 1)]
        in_window = pos < ctl[TRIP]
        jp, gp, hgp, reqp, popp, burnp = reclaim_select_turns(
            st, sess, state, tiers, _reclaim_shared(st, sess, state, tiers, carry.job_consumed),
            q_panel, carry.q_entries,
        )
        _round_products(st, sess, state, ctx, carry, use_gang, use_prop, prods)
        qp32 = q_panel.to(i32)
        pick = _union_fit(st, state, ctx, prods, preds_on, qp32, gp, hgp, reqp, popp & in_window)
        window_gate(pick, N, qp32, jp, gp, hgp, reqp, popp, burnp, ctl, carry.q_entries,
                    carry.job_consumed, state.progress, sel)
        state.rounds = rounds
        canon_commit(st, ctx, state, carry, sel_i[3:4], sel_i[0:1], sel_i[1:2], sel_i[2:3],
                     sel_b[0:1], sel_b[1:2], sel_b[2:3], sel_req, use_gang, use_prop,
                     active=sel_b[3:4])
        vals = torch.cat([ctl, state.progress.reshape(1).to(i32)]).tolist()
        start, progress = vals[START], bool(vals[-1])
        rounds += vals[ROUND_DONE]
        windows += 1
    state.rounds, state.windows = rounds, windows
    state.rounds_gated, state.claim_conflicts = vals[GATED], vals[CONFLICTS]
    return _canon_writeback(st, state, carry)


def _task_layout(segment, priority, uid_rank, resreq, extra_keys=()):
    """A fixed victim order over the whole task axis: (SortLayout, inv
    i64[T] task -> sorted position, base i64[T] sorted position -> its
    segment's first position)."""
    lay = SortLayout.build(segment, priority, uid_rank, resreq, extra_keys)
    T = lay.order.shape[0]
    pos = torch.arange(T, device=lay.order.device)
    inv = torch.empty_like(pos)
    inv[lay.order.to(torch.int64)] = pos
    base = torch.cummax(torch.where(lay.seg_start, pos, 0), dim=0).values
    return lay, inv, base


def _reclaim_fast(st, sess, state, tiers, max_rounds) -> AllocState:
    """Cross-queue reclaim over victim layouts sorted once at action entry
    (the reference's _reclaim_fast, preempt.py:1567-1913), pop for pop.

    Per turn: the queue's job / group pop (K2); the victims' eligibility —
    gang's in-(node, job) rank as the entry rank minus the segment's
    evictions so far (K5 ranks once at entry), proportion's in-(node,
    queue) cumulative as a difference of one global cumulative (added in
    the reference's order, ``mm_cumsum``); the per-node victim count and
    sums (K4, slot order); the first feasible node; the covering victim
    prefix on it; the accounting.  The claimant decode is deferred to a
    claim log replayed at the end, or immediate under pod affinity (the
    fit reads the live placements).  Updates ``state`` in place."""
    J, Q, N, T = st.num_jobs, st.num_queues, st.num_nodes, st.num_tasks
    dev = st.device
    i64, i32 = torch.int64, torch.int32
    rr = st.task_resreq
    vj = st.task_job
    vq = st.job_queue[vj.to(i64)]
    vj64, vq64 = vj.to(i64), vq.to(i64)
    verdict_names = _reclaim_verdict_names(tiers)
    preds_on = plugin_on(tiers, "predicates", "predicate_disabled")
    use_gang = "gang" in verdict_names
    use_prop = "proportion" in verdict_names
    pa_on = preds_on and pa_enabled(st)
    defer = not pa_on and _claim_key_fits(st.num_groups, T)

    node_key = state.task_node.clamp(min=0)
    # within-node victim order (queue, job, priority, uid)
    L_node, inv_node, _ = _task_layout(node_key, st.task_priority, st.task_uid_rank, rr,
                                       extra_keys=(vj, vq))
    order_node = L_node.order.to(i64)
    node_sorted = node_key[order_node]
    cand0 = (state.task_status == RUNNING) & st.task_valid & (state.task_node >= 0)
    # per-node sums run over the entry candidates only (the others add
    # exact zeros in the reference's scatter), so no segment collects
    # every task without a node
    cand_node = torch.where(cand0, node_key, N)
    node_order = segment_order(cand_node, N)
    if use_gang:
        L_nj, inv_nj, base_nj = _task_layout((vj, node_key), st.task_priority,
                                             st.task_uid_rank, rr)
        rank0_nj, _ = L_nj.rank_and_cum(cand0)
        tbase_nj = base_nj[inv_nj]
    if use_prop:
        L_nq, inv_nq, base_nq = _task_layout((vq, node_key), st.task_priority,
                                             st.task_uid_rank, rr, extra_keys=(vj,))
        order_nq = L_nq.order.to(i64)
        res_nq = fair(L_nq.res_sorted)
        deserved_t = fair(sess.deserved)[vq64]

    state.progress = torch.ones((), dtype=torch.bool, device=dev)
    state.rounds, state.rounds_gated, state.claim_conflicts = 0, 0, 0
    q_entries = _scatter_count(st.job_queue, st.job_valid, Q)
    job_consumed = torch.zeros(J, dtype=torch.bool, device=dev)
    cand = cand0.clone()
    e_nj = torch.zeros(T, dtype=i32, device=dev)  # evictions per (job, node) segment base
    log_g = torch.full((J + 1,), -1, dtype=i32, device=dev)  # row J: dropped writes
    log_n = torch.zeros(J + 1, dtype=i32, device=dev)
    log_r = torch.zeros(J + 1, dtype=i32, device=dev)
    n_claims = torch.zeros(1, dtype=i32, device=dev)
    node_ids = torch.arange(N, device=dev)
    while True:
        q_active = st.queue_valid & (q_entries > 0) & queue_has_live_job(
            st, group_live_mask(st, sess, state.group_placed, None), job_extra=~job_consumed,
        )
        nq, perm = queue_perm(tiers, q_active, state.queue_alloc, sess.deserved, st.queue_uid_rank)
        go, nq_h = _host(state.progress, nq)
        if not (go and state.rounds < max_rounds):
            break
        state.progress = torch.zeros_like(state.progress)
        for qi in range(max(nq_h, 1)):
            q = perm[qi:qi + 1]
            shared = _reclaim_shared(st, sess, state, tiers, job_consumed)
            j, g, has_grp, req, pop, burn_now = _reclaim_pop(
                st, sess, state, tiers, shared, q, q_entries[q]
            )
            j64, g64 = j.to(i64), g.to(i64)
            # ---- victim eligibility: corrected gang rank, lean prop cum
            elig = cand
            if use_gang:
                rank_now = rank0_nj - e_nj[tbase_nj]
                cap = (state.job_ready_cnt - sess.min_avail).clamp(min=0)
                elig = elig & (rank_now < cap[vj64])
            if use_prop:
                m_nq = cand[order_nq]
                v_nq = torch.where(m_nq[:, None], res_nq, 0.0)
                c_nq = mm_cumsum(v_nq)
                cum_seg = c_nq - (c_nq[base_nq] - v_nq[base_nq])  # inclusive in-segment
                after = fair(state.queue_alloc)[vq64] - cum_seg[inv_nq]
                elig = elig & (deserved_t < after + EPS).all(dim=-1)
            if not verdict_names:
                elig = torch.zeros_like(cand)
            mask_v = elig & (vq64 != q)
            vstat = torch.cat([mask_v.to(torch.float32)[:, None],
                               torch.where(mask_v[:, None], rr, 0.0)], dim=1)
            agg = segment_sum(vstat, cand_node, N, order=node_order)
            vic_cnt, vic_res = agg[:, 0], agg[:, 1:]
            # ---- first-fit node choice
            if preds_on:
                klass = st.group_klass[g64].to(i64)
                node_ok = (st.class_fit[klass][:, st.node_klass.to(i64)][0]
                           & st.node_valid & ~st.node_unsched)
                g_ports = st.group_ports[g64][0]
                node_ok = node_ok & ((g_ports[None, :] & state.node_ports) == 0).all(dim=-1)
                node_ok = node_ok & (st.node_max_tasks - state.node_num_tasks > 0)
            else:
                node_ok = st.node_valid
            if pa_on:
                node_ok = node_ok & pod_affinity_fit(st, g, state.task_status, state.task_node).ok
            weak_ok = ~(vic_res < req[None, :]).all(dim=-1)
            feas = node_ok & (vic_cnt > 0) & weak_ok & pop & has_grp
            n_star = torch.where(feas, node_ids, N).argmin().reshape(1)
            claimed = pop & has_grp & feas.any()
            fail = pop & ~claimed
            q_entries.index_put_((q,), -(burn_now | fail).to(i32), accumulate=True)
            job_consumed.index_put_((j64,), job_consumed[j64] | pop)
            # ---- the minimal covering prefix on n_star (only its victims
            # are non-zero, so one cumulative in node order is in-node)
            m_s = mask_v[order_node] & (node_sorted == n_star)
            v_s = torch.where(m_s[:, None], L_node.res_sorted, 0.0)
            cum_s = mm_cumsum(v_s)
            evict_s = m_s & claimed & ((cum_s - v_s) < (req - EPS)[None, :]).any(dim=-1)
            evict = evict_s[inv_node]
            evict_res = torch.where(evict[:, None], rr, 0.0)
            # the evicted victims' sum, in slot order (only they are non-zero)
            freed = segment_sum(evict_res, (~evict).to(i32), 1)[0]
            cand = cand & ~evict
            if use_gang:
                # every task adds its 0 / 1 at its own segment's base: integer
                # atomics spread over the segments (a sort-based accumulate
                # into one drop row serialises T adds on the card)
                e_nj.scatter_add_(0, tbase_nj, evict.to(i32))
            # ---- claimant decode
            placed_g = state.group_placed[g64]
            if defer:
                slot = torch.where(claimed, n_claims, J).to(i64)
                log_g.index_put_((slot,), g.to(i32))
                log_n.index_put_((slot,), n_star.to(i32))
                log_r.index_put_((slot,), placed_g)
                n_claims = n_claims + claimed.to(i32)
            else:
                assigned = ((st.task_group == g) & st.task_valid
                            & (st.task_group_rank == placed_g) & claimed)
                state.task_status = torch.where(evict, RELEASING, state.task_status)
                state.task_status = torch.where(assigned, PIPELINED, state.task_status)
                state.task_node = torch.where(assigned, n_star.to(i32), state.task_node)
            # ---- accounting
            ev_cnt_res = torch.cat([evict.to(torch.float32)[:, None], evict_res], dim=1)
            jstat = segment_sum(ev_cnt_res, torch.where(evict, vj, J), J)
            qstat = segment_sum(ev_cnt_res, torch.where(evict, vq, Q), Q)
            creq = (req * claimed.to(torch.float32))[None, :]
            state.job_alloc = state.job_alloc - jstat[:, 1:]
            state.job_alloc.index_put_((j64,), creq, accumulate=True)
            state.queue_alloc = state.queue_alloc - qstat[:, 1:]
            state.queue_alloc.index_put_((q,), creq, accumulate=True)
            state.job_ready_cnt = state.job_ready_cnt - jstat[:, 0].to(i32)
            state.job_ready_cnt.index_put_((j64,), claimed.to(i32), accumulate=True)
            state.node_releasing.index_put_((n_star,), (freed[None, :] - creq), accumulate=True)
            ports_row = state.node_ports[n_star]
            state.node_ports.index_put_(
                (n_star,), torch.where(claimed[:, None], ports_row | st.group_ports[g64], ports_row)
            )
            state.node_num_tasks.index_put_((n_star,), claimed.to(i32), accumulate=True)
            state.group_placed.index_put_((g64,), claimed.to(i32), accumulate=True)
            state.evicted_for = torch.where(evict, -2, state.evicted_for)
            state.evict_claimant = torch.where(evict, j.to(i32), state.evict_claimant)
            state.evict_phase = torch.where(evict, EVICT_PHASE_RECLAIM, state.evict_phase)
            state.evict_round = torch.where(evict, state.rounds, state.evict_round)
            state.progress = state.progress | pop[0]
        state.rounds += 1
    if defer:
        state.task_status = torch.where(cand0 & ~cand, RELEASING, state.task_status)
        state.task_status, state.task_node = _replay_claim_log(
            st, state.task_status, state.task_node, log_g[:J], log_n[:J], log_r[:J],
        )
    return state


def _canon_pack_ok(st: SnapshotTensors) -> bool:
    """Does the pack carry the reclaim canon layout (and fit the claim
    log's int32 key)?"""
    return (
        st.rv_block_start.shape[0] == st.num_nodes + 1
        and st.rv_idx.shape[0] > 0
        and st.rv_window > 0
        and _claim_key_fits(st.num_groups, st.num_tasks)
    )


def reclaim_batch_fallback_reason(st: SnapshotTensors, tiers: Tiers):
    """Why ``reclaim_action``'s default dispatch degrades from the canon
    walk to ``_reclaim_fast`` (None: it does not)."""
    if not _canon_pack_ok(st):
        return "no_canon_pack"
    if plugin_on(tiers, "predicates", "predicate_disabled") and pa_enabled(st):
        return "pod_affinity"
    return None


def reclaim_engine_fallback_reason(st: SnapshotTensors, tiers: Tiers):
    """Why the opt-in engines (round-batched, optimistic) are illegal for
    this pack (None: legal): the canon conditions above, plus the (node,
    queue) segment key of the own-queue subtraction fitting int32.  The
    ``reclaim_optimistic`` action degrades to the default dispatch on a
    reason instead of raising."""
    reason = reclaim_batch_fallback_reason(st, tiers)
    if reason is not None:
        return reason
    if (st.num_nodes + 1) * (st.num_queues + 1) >= 2**31:
        return "segment_key_overflow"
    return None


def reclaim_action(
    st: SnapshotTensors,
    sess: SessionCtx,
    state: AllocState,
    tiers: Tiers,
    s_max: int = 4096,
    max_rounds: int = 100_000,
    turn_batch=None,
) -> AllocState:
    """The reference's dispatch.  ``turn_batch`` None or False: the
    sequential canon walk over the pack's canon layout, or
    ``_reclaim_fast`` where the pack has none (or its key would overflow
    int32) or pod affinity is on.  True: the round-batched engine;
    ``"optimistic"``: the optimistic engine — both raise ValueError where
    :func:`reclaim_engine_fallback_reason` gives a reason.  All decide
    alike.  ``s_max`` is accepted for the action signature; reclaim
    claims one task at a time.  Returns a new state."""
    del s_max
    if turn_batch and reclaim_engine_fallback_reason(st, tiers) is not None:
        raise ValueError(
            f"turn_batch={turn_batch!r} but the round-batched/optimistic "
            "reclaim engines are not legal for this snapshot/tiers "
            "(missing canon pack, pod affinity, or the (node, queue) "
            "segment key overflows int32)"
        )
    state = _copy(state)
    state.windows = 0
    if turn_batch == "optimistic":
        return _reclaim_canon_optimistic(st, sess, state, tiers, max_rounds)
    if turn_batch:
        return _reclaim_canon_batched(st, sess, state, tiers, max_rounds)
    if reclaim_batch_fallback_reason(st, tiers) is None:
        return _reclaim_canon(st, sess, state, tiers, max_rounds)
    return _reclaim_fast(st, sess, state, tiers, max_rounds)
