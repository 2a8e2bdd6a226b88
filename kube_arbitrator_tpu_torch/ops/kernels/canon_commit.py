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
not claim.  :class:`CanonCommitPlan` binds one engine call's launches
once (a launch passes only the turn); :func:`canon_commit` is the same
through a throwaway plan.  CUDA source: csrc/canon_commit.cu.
"""
from __future__ import annotations

import ctypes

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .build import P
from .canon_pick import WIDE, canon_elig
from .seg_scan import seg_scan_plain
from .segment_sum import segment_sum_plain

EPS = DEVICE_EPSILON
EVICT_PHASE_RECLAIM = 3  # ops/allocate.EVICT_PHASE_RECLAIM

MAX_R = 8  # csrc/canon_commit.cu's MAX_R
SMEM_LIMIT = 227 * 1024  # shared memory one CTA can have on an H100


def smem_bytes(W: int, R: int) -> int:
    """Shared memory of a window of ``W`` slots (csrc's smem_bytes): the
    resreq rows and the job / queue rows an eviction updates (3 W R f32),
    four i32 and five flags a slot, a short bit a slot."""
    return W * (12 * R + 16 + 5) + 4 * (-(-W // 32))

# C signature of csrc/canon_commit.cu: (static, turn, stream)
SIGNATURES = {"kat_canon_commit": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/canon_commit.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "cj", "cq", "cres", "deserved_c", "min_avail", "bstart", "rv_idx", "nj_start",
        "nq_start", "group_ports", "cand", "evicted_c", "rank_nj", "cum_nq", "q_entries",
        "job_consumed", "log_g", "log_n", "log_r", "n_claims", "job_alloc", "queue_alloc",
        "job_ready_cnt", "group_placed", "node_releasing", "node_ports", "node_num_tasks",
        "evict_claimant", "evict_phase", "evict_round",
    )] + [(n, ctypes.c_int) for n in (
        "R", "F", "use_gang", "use_prop", "N", "W", "PW", "J", "phase_code")]


class _Turn(ctypes.Structure):
    """csrc/canon_commit.cu's Turn: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "pick", "q", "j", "g", "has_grp", "pop", "burn", "req", "active", "claimed_out",
        "progress", "progress_out")] + [(n, ctypes.c_int) for n in ("q_wide", "j_wide", "g_wide", "rounds")]


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
                       use_gang, use_prop, active=None, claimed_out=None, progress_out=None):
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
    carry.log_g[slot] = g.to(torch.int32)
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
    if progress_out is not None:
        progress_out.masked_fill_(pop.reshape(progress_out.shape), 1)


class CanonCommitPlan:
    """K8's launches over one canon engine call.

    Built once per call beside the engine's other plans: it checks the
    dtypes and shapes once and binds the fixed pointers (the canon
    context, the carry — ``cand``, ``evicted_c``, ``rank_nj``,
    ``cum_nq``, ``q_entries``, ``job_consumed``, the claim log and
    ``n_claims`` —, ``job_alloc``, ``queue_alloc``, ``job_ready_cnt``,
    ``group_placed``, the node releasing / ports / pod counts, the three
    audit fields and the pack's canon arrays) and the flags, and keeps
    the stream current when it was built.  Every bound tensor must be
    updated IN PLACE between launches (the canon engines never reassign
    them).  ``state.progress`` and ``state.rounds`` are read at each
    launch: the engines give progress a new tensor every round.  CPU
    tensors take the plain version on the same state."""

    def __init__(self, st, ctx, state, carry, use_gang: bool, use_prop: bool):
        self.st, self.ctx, self.state, self.carry = st, ctx, state, carry
        self.flags = (bool(use_gang), bool(use_prop))
        dev = carry.cand.device
        self.dev = dev
        self.first = True
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"canon_commit: tensors on {dev}")
        W = st.rv_window
        if W <= 0:
            raise ValueError("canon_commit: the pack has no canon window")
        Vp, R = ctx.cres.shape
        F = carry.cum_nq.shape[1]
        N, J = st.num_nodes, st.num_jobs
        PW = state.node_ports.shape[1]
        if not 1 <= R <= MAX_R or F > R:
            raise ValueError(f"canon_commit: R = {R}, F = {F}; want 1 <= F <= R <= {MAX_R}")
        if smem_bytes(W, R) > SMEM_LIMIT:
            raise ValueError(f"canon_commit: a window of {W} slots needs more shared memory "
                             "than a CTA has")
        checks = [
            (ctx.cj, torch.int32, (Vp,)), (ctx.cq, torch.int32, (Vp,)),
            (ctx.cres, torch.float32, (Vp, R)), (ctx.deserved_c, torch.float32, (Vp, F)),
            (ctx.min_avail, torch.int32, (J,)), (st.rv_block_start, torch.int32, (N + 1,)),
            (st.rv_idx, torch.int32, (Vp,)), (st.rv_nj_start, torch.bool, (Vp,)),
            (st.rv_nq_start, torch.bool, (Vp,)), (st.group_ports, torch.int32, None),
            (carry.cand, torch.bool, (Vp,)), (carry.evicted_c, torch.bool, (Vp,)),
            (carry.rank_nj, torch.float32, (Vp,)), (carry.cum_nq, torch.float32, (Vp, F)),
            (carry.q_entries, torch.int32, None), (carry.job_consumed, torch.bool, (J,)),
            (carry.log_g, torch.int32, (J + 1,)), (carry.log_n, torch.int32, (J + 1,)),
            (carry.log_r, torch.int32, (J + 1,)), (carry.n_claims, torch.int32, (1,)),
            (state.job_alloc, torch.float32, (J, R)), (state.queue_alloc, torch.float32, None),
            (state.job_ready_cnt, torch.int32, (J,)), (state.group_placed, torch.int32, None),
            (state.node_releasing, torch.float32, (N, R)), (state.node_ports, torch.int32, (N, PW)),
            (state.node_num_tasks, torch.int32, (N,)), (state.evict_claimant, torch.int32, None),
            (state.evict_phase, torch.int32, None), (state.evict_round, torch.int32, None),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"canon_commit.arg{i}", dev)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"canon_commit.arg{i}: shape {tuple(t.shape)}, want {shape}")
        if state.queue_alloc.dim() != 2 or state.queue_alloc.shape[1] != R:
            raise ValueError("canon_commit: queue_alloc must be f32[Q, R]")
        if st.group_ports.dim() != 2 or st.group_ports.shape[1] != PW:
            raise ValueError("canon_commit: group_ports must be i32[G, PW]")
        p = build.ptr
        self.static = _Static(
            p(ctx.cj), p(ctx.cq), p(ctx.cres), p(ctx.deserved_c), p(ctx.min_avail),
            p(st.rv_block_start), p(st.rv_idx), p(st.rv_nj_start), p(st.rv_nq_start),
            p(st.group_ports), p(carry.cand), p(carry.evicted_c), p(carry.rank_nj),
            p(carry.cum_nq), p(carry.q_entries), p(carry.job_consumed), p(carry.log_g),
            p(carry.log_n), p(carry.log_r), p(carry.n_claims), p(state.job_alloc),
            p(state.queue_alloc), p(state.job_ready_cnt), p(state.group_placed),
            p(state.node_releasing), p(state.node_ports), p(state.node_num_tasks),
            p(state.evict_claimant), p(state.evict_phase), p(state.evict_round),
            R, F, int(use_gang), int(use_prop), N, W, PW, J, EVICT_PHASE_RECLAIM,
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.turn = _Turn()
        self.turn_ptr = ctypes.addressof(self.turn)
        self.fn = build.bind("canon_commit", "kat_canon_commit", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, pick, q, j, g, has_grp, pop, burn_now, req, active=None,
                 claimed_out=None, progress_out=None) -> None:
        """Commit one turn in place: ``pick`` i32[1] (K7's or K14's), ``q``
        / ``j`` / ``g`` i32 or i64 [1], ``has_grp`` / ``pop`` / ``burn_now``
        bool[1], ``req`` f32[R]; ``active`` / ``claimed_out`` optional
        bool[1] device flags, ``progress_out`` an optional i32[1] set to 1
        wherever progress is set; all on the plan's device."""
        state = self.state
        if self.dev.type == "cpu":
            canon_commit_plain(self.st, self.ctx, state, self.carry, pick, q, j, g, has_grp,
                               pop, burn_now, req, *self.flags, active, claimed_out,
                               progress_out)
            return
        t = self.turn
        t.q_wide, t.j_wide, t.g_wide = (WIDE.get(x.dtype, -1) for x in (q, j, g))
        if min(t.q_wide, t.j_wide, t.g_wide) < 0:
            raise TypeError(f"canon_commit: q / j / g dtypes {q.dtype} / {j.dtype} / {g.dtype}, "
                            "want i32 or i64")
        progress = state.progress
        if self.first:  # the turn's tensors keep their types all action
            R = self.ctx.cres.shape[1]
            for name, x, dt in (("pick", pick, torch.int32), ("has_grp", has_grp, torch.bool),
                                ("pop", pop, torch.bool), ("burn_now", burn_now, torch.bool),
                                ("req", req, torch.float32), ("progress", progress, torch.bool),
                                ("active", active, torch.bool),
                                ("claimed_out", claimed_out, torch.bool),
                                ("progress_out", progress_out, torch.int32)):
                if x is not None:
                    build.require(x, dt, f"canon_commit.{name}", self.dev)
            if req.shape != (R,) or progress.dim() != 0:
                raise ValueError("canon_commit: req must be f32[R], progress a bool scalar")
            if not all(x.device == self.dev for x in (q, j, g)):
                raise ValueError("canon_commit: q / j / g off the plan's device")
            self.first = False
        t.pick, t.q, t.j, t.g = pick.data_ptr(), q.data_ptr(), j.data_ptr(), g.data_ptr()
        t.has_grp, t.pop, t.burn = has_grp.data_ptr(), pop.data_ptr(), burn_now.data_ptr()
        t.req, t.active, t.claimed_out = req.data_ptr(), build.ptr(active), build.ptr(claimed_out)
        t.progress_out = build.ptr(progress_out)
        t.progress, t.rounds = progress.data_ptr(), state.rounds
        build.check(self.fn(self.static_ptr, self.turn_ptr, self.stream), "canon_commit")
        build.launched(canon_commit)


def canon_commit(st, ctx, state, carry, pick, q, j, g, has_grp, pop, burn_now, req,
                 use_gang: bool, use_prop: bool, active=None, claimed_out=None) -> None:
    """Commit one turn in place.  ``pick`` i32[1] from K7 or K14;
    ``q``/``j``/``g`` i32 or i64 [1]; ``has_grp``/``pop``/``burn_now``
    bool[1]; ``req`` f32[R].  Optional bool[1] device flags: ``active``
    (clear: do nothing) and ``claimed_out`` (receives the turn's claimed
    bit).  CPU tensors take the plain version; CUDA tensors launch the
    kernel once through a plan of its own."""
    CanonCommitPlan(st, ctx, state, carry, use_gang, use_prop)(
        pick, q, j, g, has_grp, pop, burn_now, req, active, claimed_out)


canon_commit.launches = 0
