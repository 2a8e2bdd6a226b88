"""K8 ``canon_commit``: the commit tail of one reclaim canon turn, in
place.

Replaces the reference's ops/preempt.py:_canon_fit_commit (:2080-2219)
after the node pick: claim and pop accounting, the covering-prefix
eviction inside the chosen node's W-wide window, the cand / evicted
marks, the restore of the carried scans over the window, the job and
queue stat sums, the claim-log slot, the node releasing / ports / pod
count updates and the audit aux.  ``pick`` is K7's output on the device.

``state`` is the action's AllocState and ``carry`` the canon walk's
carried arrays (ops/preempt._CanonCarry); both are updated in place.
The claim log has J + 1 rows: row J takes the writes of turns that did
not claim.  CUDA source: csrc/canon_commit.cu.
"""
from __future__ import annotations

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .build import I, P
from .canon_pick import canon_elig
from .seg_scan import seg_scan_plain
from .segment_sum import segment_sum_plain

EPS = DEVICE_EPSILON
EVICT_PHASE_RECLAIM = 3  # ops/allocate.EVICT_PHASE_RECLAIM

# C signature of csrc/canon_commit.cu
SIGNATURES = {
    "kat_canon_commit": (
        P, P, P, P, P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
        P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P, P, P,
    ),
}


def _scatter_set(dst: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, value) -> None:
    """dst[idx[k]] = value where mask[k], in place (indices unique where
    masked; the others land in a dropped pad row).  A number ``value`` is
    filled on the device: a host scalar copied to the card would
    synchronise."""
    n = dst.shape[0]
    pad = torch.cat([dst, dst[:1]])
    slot = torch.where(mask, idx.to(torch.int64), n)
    if not isinstance(value, torch.Tensor):
        value = torch.full(slot.shape, value, dtype=dst.dtype, device=dst.device)
    pad.index_put_((slot,), value.to(dst.dtype).expand(slot.shape))
    dst.copy_(pad[:n])


def canon_commit_plain(st, ctx, state, carry, pick, q, j, g, has_grp, pop, burn_now, req,
                       use_gang, use_prop, active=None, claimed_out=None):
    """The plain version, op for op in the kernel's order."""
    if active is not None and not bool(active.reshape(())):
        return
    N, W, J = st.num_nodes, st.rv_window, st.num_jobs
    dev = req.device
    i64 = torch.int64
    has_node = pick < N
    n_star = torch.where(has_node, pick, 0).to(i64)
    claimed = pop & has_grp & has_node
    fail = pop & ~claimed
    if claimed_out is not None:
        claimed_out.copy_(claimed.reshape(claimed_out.shape))
    bstart = st.rv_block_start.to(i64)
    start = bstart[n_star]
    blen = bstart[n_star + 1] - start
    w_iota = torch.arange(W, device=dev)
    win = start + w_iota
    qq, jj, gg = q.to(i64), j.to(i64), g.to(i64)

    # the window mask, from the turn-entry state
    elig = canon_elig(ctx, carry.cand, carry.rank_nj, carry.cum_nq, state.job_ready_cnt,
                      ctx.min_avail, state.queue_alloc, use_gang, use_prop)
    m_w = elig[win] & (ctx.cq[win] != q) & (w_iota < blen)
    v_w = ctx.cres[win]
    v_wm = torch.where(m_w[:, None], v_w, 0.0)
    one_seg = torch.zeros(W, dtype=torch.bool, device=dev)
    _, cum_w = seg_scan_plain(torch.ones_like(m_w), None, one_seg, v_wm)
    evict_w = m_w & claimed & (cum_w - v_wm < req[None, :] - EPS).any(dim=-1)
    ev_res_w = torch.where(evict_w[:, None], v_w, 0.0)
    freed = segment_sum_plain(ev_res_w, torch.zeros(W, dtype=torch.int32, device=dev), 1)[0]

    carry.cand[win] = carry.cand[win] & ~evict_w
    carry.evicted_c[win] = carry.evicted_c[win] | evict_w
    cand_w = carry.cand[win]
    if use_gang:
        rank_w, _ = seg_scan_plain(cand_w, None, st.rv_nj_start[win],
                                   torch.zeros((W, 0), device=dev))
        carry.rank_nj[win] = rank_w.to(torch.float32)
    if use_prop:
        _, cum_nq_w = seg_scan_plain(cand_w, None, st.rv_nq_start[win],
                                     v_w[:, :NUM_FAIR_RESOURCES].contiguous())
        carry.cum_nq[win] = cum_nq_w

    ev_cnt_res = torch.cat([evict_w.to(torch.float32)[:, None], ev_res_w], dim=1)
    jstat = segment_sum_plain(ev_cnt_res, torch.where(evict_w, ctx.cj[win], J), J)
    qstat = segment_sum_plain(ev_cnt_res, torch.where(evict_w, ctx.cq[win], st.num_queues),
                              st.num_queues)
    creq = req * claimed.to(torch.float32)
    state.job_alloc.sub_(jstat[:, 1:])
    state.job_alloc[jj] = state.job_alloc[jj] + creq
    state.queue_alloc.sub_(qstat[:, 1:])
    state.queue_alloc[qq] = state.queue_alloc[qq] + creq
    state.job_ready_cnt.sub_(jstat[:, 0].to(torch.int32))
    state.job_ready_cnt[jj] += claimed.to(torch.int32)
    carry.q_entries[qq] -= (burn_now | fail).to(torch.int32)
    carry.job_consumed[jj] |= pop

    slot = torch.where(claimed, carry.n_claims, J).to(i64)
    carry.log_g[slot] = g
    carry.log_n[slot] = n_star.to(torch.int32)
    carry.log_r[slot] = state.group_placed[gg]
    carry.n_claims += claimed.to(torch.int32)
    state.node_releasing[n_star] = state.node_releasing[n_star] + (freed - creq)
    state.node_ports[n_star] = torch.where(
        claimed[:, None], state.node_ports[n_star] | st.group_ports[gg], state.node_ports[n_star]
    )
    state.node_num_tasks[n_star] += claimed.to(torch.int32)
    state.group_placed[gg] += claimed.to(torch.int32)
    ev_t = st.rv_idx[win]
    _scatter_set(state.evict_claimant, ev_t, evict_w, j.to(torch.int32))
    _scatter_set(state.evict_phase, ev_t, evict_w, EVICT_PHASE_RECLAIM)
    _scatter_set(state.evict_round, ev_t, evict_w, state.rounds)
    state.progress = state.progress | pop[0]


def canon_commit(st, ctx, state, carry, pick, q, j, g, has_grp, pop, burn_now, req,
                 use_gang: bool, use_prop: bool, active=None, claimed_out=None) -> None:
    """Commit one turn in place.  ``pick`` i32[1] from K7 or K14;
    ``q``/``j``/``g`` i32[1]; ``has_grp``/``pop``/``burn_now`` bool[1];
    ``req`` f32[R].  Optional bool[1] device flags: ``active`` (clear: do
    nothing) and ``claimed_out`` (receives the turn's claimed bit).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    args = (st, ctx, state, carry, pick, q, j, g, has_grp, pop, burn_now, req,
            use_gang, use_prop, active, claimed_out)
    if req.device.type == "cpu":
        canon_commit_plain(*args)
        return
    dev = req.device
    if dev.type != "cuda":
        raise ValueError(f"canon_commit: tensors on {dev}")
    if state.progress.dim() != 0 or state.progress.dtype != torch.bool:
        raise ValueError("canon_commit: progress must be a bool scalar")
    checks = [
        (carry.cand, torch.bool), (carry.rank_nj, torch.float32), (carry.cum_nq, torch.float32),
        (ctx.cj, torch.int32), (ctx.cq, torch.int32), (ctx.deserved_c, torch.float32),
        (state.job_ready_cnt, torch.int32), (ctx.min_avail, torch.int32),
        (state.queue_alloc, torch.float32), (pick, torch.int32), (q, torch.int32),
        (j, torch.int32), (g, torch.int32), (has_grp, torch.bool), (pop, torch.bool),
        (burn_now, torch.bool), (req, torch.float32), (st.rv_block_start, torch.int32),
        (st.rv_idx, torch.int32), (ctx.cres, torch.float32), (st.rv_nj_start, torch.bool),
        (st.rv_nq_start, torch.bool), (st.group_ports, torch.int32),
        (carry.evicted_c, torch.bool), (state.job_alloc, torch.float32),
        (carry.q_entries, torch.int32), (carry.job_consumed, torch.bool),
        (state.group_placed, torch.int32), (carry.log_g, torch.int32),
        (carry.log_n, torch.int32), (carry.log_r, torch.int32), (carry.n_claims, torch.int32),
        (state.node_releasing, torch.float32), (state.node_ports, torch.int32),
        (state.node_num_tasks, torch.int32), (state.evict_claimant, torch.int32),
        (state.evict_phase, torch.int32), (state.evict_round, torch.int32),
        (state.progress, torch.bool),
    ] + [(t, torch.bool) for t in (active, claimed_out) if t is not None]
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"canon_commit.arg{i}", dev)
    W = st.rv_window
    if W <= 0:
        raise ValueError("canon_commit: the pack has no canon window")
    R = ctx.cres.shape[1]
    fn = build.bind("canon_commit", "kat_canon_commit", SIGNATURES)
    build.check(fn(
        build.ptr(carry.cand), build.ptr(carry.rank_nj), build.ptr(carry.cum_nq),
        build.ptr(ctx.cj), build.ptr(ctx.cq), build.ptr(ctx.deserved_c),
        build.ptr(state.job_ready_cnt), build.ptr(ctx.min_avail), build.ptr(state.queue_alloc),
        R, carry.cum_nq.shape[1], int(use_gang), int(use_prop), build.ptr(pick), build.ptr(q),
        build.ptr(j), build.ptr(g), build.ptr(has_grp), build.ptr(pop), build.ptr(burn_now),
        build.ptr(req), build.ptr(st.rv_block_start), build.ptr(st.rv_idx),
        build.ptr(ctx.cres), build.ptr(st.rv_nj_start), build.ptr(st.rv_nq_start),
        build.ptr(st.group_ports), build.ptr(carry.evicted_c), build.ptr(state.job_alloc),
        build.ptr(carry.q_entries), build.ptr(carry.job_consumed), build.ptr(state.group_placed),
        build.ptr(carry.log_g), build.ptr(carry.log_n), build.ptr(carry.log_r),
        build.ptr(carry.n_claims), build.ptr(state.node_releasing), build.ptr(state.node_ports),
        build.ptr(state.node_num_tasks), build.ptr(state.evict_claimant),
        build.ptr(state.evict_phase), build.ptr(state.evict_round), build.ptr(state.progress),
        st.num_nodes, W, state.node_ports.shape[1], state.rounds, EVICT_PHASE_RECLAIM,
        build.ptr(active), build.ptr(claimed_out), build.stream(),
    ), "canon_commit")
    canon_commit.launches += 1


canon_commit.launches = 0
