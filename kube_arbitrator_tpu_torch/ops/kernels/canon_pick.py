"""K7 ``canon_pick``: one reclaim turn's per-node victim sums and its
first-fit node.

Replaces, per turn of the reference's ops/preempt.py:_reclaim_canon
(:2331-2335): ``_canon_elig`` (:2012) with the own-queue exclusion,
``_canon_per_node`` (:2035) and the first-fit pick of
``_canon_fit_commit`` (``_fit_feasible`` :2058, :2104-2108).  Returns
``pick`` i32[1]: the first feasible node, or N when none is (the
reference then takes node 0 with ``has_node`` False; K8 reads it so).

``ctx`` is the action's canon context (ops/preempt._CanonCtx: ``cj``,
``cq``, ``cres``, ``deserved_c``, ``cnode``, ``cnode_order``).
:class:`CanonPickPlan` binds one ``_reclaim_canon`` call's launches once
(the carried scans, the job and queue state and the node state change in
place between them, so a launch passes only the turn's q, g, has_grp,
pop and req); :func:`canon_pick` is the same through a throwaway plan.
CUDA source: csrc/canon_pick.cu (eligibility in csrc/canon.cuh).
"""
from __future__ import annotations

import ctypes

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .build import I, P
from .segment_sum import segment_sum_plain

EPS = DEVICE_EPSILON

# C signature of csrc/canon_pick.cu: (static, turn, stream)
SIGNATURES = {"kat_canon_pick": (P, P, P)}
WIDE = {torch.int32: 0, torch.int64: 1}  # an index tensor's dtype -> read as i64


class _Static(ctypes.Structure):
    """csrc/canon_pick.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "cand", "rank_nj", "cum_nq", "cj", "cq", "deserved_c", "job_ready_cnt", "min_avail",
        "queue_alloc", "bstart", "cres", "class_fit", "node_klass", "node_valid", "node_unsched",
        "node_max_tasks", "node_num_tasks", "node_ports", "group_klass", "group_ports", "picks",
    )] + [(n, ctypes.c_int) for n in (
        "R", "F", "use_gang", "use_prop", "CN", "N", "PW", "preds_on")]


class _Turn(ctypes.Structure):
    """csrc/canon_pick.cu's Turn: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("q", "g", "has_grp", "pop", "req")] + [
        (n, ctypes.c_int) for n in ("q_wide", "g_wide", "parity")]


def canon_elig(ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
               use_gang, use_prop):
    """bool[Vp]: victim eligibility from the carried scans, before the
    own-queue exclusion (the reference's ``_canon_elig``)."""
    if not (use_gang or use_prop):
        return torch.zeros_like(cand)
    elig = cand
    if use_gang:
        cap = (job_ready_cnt - min_avail).clamp(min=0)
        elig = elig & (rank_nj < cap[ctx.cj.to(torch.int64)].to(torch.float32))
    if use_prop:
        after = queue_alloc[:, :NUM_FAIR_RESOURCES][ctx.cq.to(torch.int64)] - cum_nq
        elig = elig & (ctx.deserved_c < after + EPS).all(dim=-1)
    return elig


def fit_feasible(st, node_ports, node_num_tasks, preds_on, g, has_grp, req, pop, vic_cnt, vic_res):
    """bool[N]: first-fit feasibility of one reclaim claim (the
    reference's ``_fit_feasible``)."""
    if preds_on:
        klass = st.group_klass[g].to(torch.int64)
        node_ok = (
            st.class_fit[klass][:, st.node_klass.to(torch.int64)][0]
            & st.node_valid & ~st.node_unsched
        )
        g_ports = st.group_ports[g][0]
        node_ok = node_ok & ((g_ports[None, :] & node_ports) == 0).all(dim=-1)
        node_ok = node_ok & (st.node_max_tasks - node_num_tasks > 0)
    else:
        node_ok = st.node_valid
    weak_ok = ~(vic_res < req[None, :]).all(dim=-1)
    return node_ok & (vic_cnt > 0) & weak_ok & pop & has_grp


def canon_pick_plain(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                     node_ports, node_num_tasks, q, g, has_grp, pop, req,
                     use_gang, use_prop, preds_on):
    """The plain version: the eligibility mask over the whole canon pack,
    per-node [count | resreq] sums in slot order, feasibility, first
    feasible node."""
    N = st.num_nodes
    elig = canon_elig(ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                      use_gang, use_prop)
    mask_v = elig & (ctx.cq != q)
    stat = torch.cat(
        [mask_v.to(torch.float32)[:, None], torch.where(mask_v[:, None], ctx.cres, 0.0)], dim=1
    )
    per_node = segment_sum_plain(stat, ctx.cnode, N, order=ctx.cnode_order)
    feas = fit_feasible(st, node_ports, node_num_tasks, preds_on, g, has_grp, req, pop,
                        per_node[:, 0], per_node[:, 1:])
    nodes = torch.arange(N, dtype=torch.int32, device=feas.device)
    return torch.where(feas, nodes, N).amin().reshape(1).to(torch.int32)


class CanonPickPlan:
    """K7's launches over one ``_reclaim_canon`` call.

    Built once per call beside the queue-order plan: it checks the
    dtypes and shapes once, binds the fixed pointers (the canon context,
    the carry's ``cand`` / ``rank_nj`` / ``cum_nq``, ``job_ready_cnt``,
    ``min_avail``, ``queue_alloc``, ``node_ports``, ``node_num_tasks``, the
    pack's block starts and node screens, the plan's two pick words)
    and the flags, and keeps the stream current when it was built.  Every
    bound tensor must be updated IN PLACE between launches (K8 writes the
    carry, ``job_ready_cnt``, ``queue_alloc``, ``node_ports`` and
    ``node_num_tasks`` in place; the canon walk never reassigns them): a
    launch reads whatever they hold then.  The plan owns two pick words
    and launches alternate them: a launch's ``pick`` (``self.pick`` after
    it) is OVERWRITTEN by the next launch, which re-arms it to N for the
    one after: the turn's K8 consumes it in stream order before the next
    turn.  CPU tensors take the plain version, into the same owned
    words."""

    def __init__(self, st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                 node_ports, node_num_tasks, use_gang: bool, use_prop: bool, preds_on: bool):
        self.st, self.ctx = st, ctx
        self.state = (cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc, node_ports,
                      node_num_tasks)
        self.flags = (bool(use_gang), bool(use_prop), bool(preds_on))
        dev = cand.device
        self.dev = dev
        N = st.num_nodes
        self.picks = torch.full((2,), N, dtype=torch.int32, device=dev)
        self.words = (self.picks[0:1], self.picks[1:2])
        self.launched = 0
        self.first = True
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"canon_pick: tensors on {dev}")
        Vp, R = ctx.cres.shape
        F = cum_nq.shape[1]
        PW = node_ports.shape[1]
        checks = [
            (cand, torch.bool, (Vp,)), (rank_nj, torch.float32, (Vp,)),
            (cum_nq, torch.float32, (Vp, F)), (ctx.cj, torch.int32, (Vp,)),
            (ctx.cq, torch.int32, (Vp,)), (ctx.deserved_c, torch.float32, (Vp, F)),
            (job_ready_cnt, torch.int32, None), (min_avail, torch.int32, None),
            (queue_alloc, torch.float32, None), (st.rv_block_start, torch.int32, (N + 1,)),
            (ctx.cres, torch.float32, (Vp, R)), (st.class_fit, torch.bool, None),
            (st.node_klass, torch.int32, (N,)), (st.node_valid, torch.bool, (N,)),
            (st.node_unsched, torch.bool, (N,)), (st.node_max_tasks, torch.int32, (N,)),
            (node_num_tasks, torch.int32, (N,)), (node_ports, torch.int32, (N, PW)),
            (st.group_klass, torch.int32, None), (st.group_ports, torch.int32, None),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"canon_pick.arg{i}", dev)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"canon_pick.arg{i}: shape {tuple(t.shape)}, want {shape}")
        if queue_alloc.dim() != 2 or queue_alloc.shape[1] != R:
            raise ValueError("canon_pick: queue_alloc must be f32[Q, R]")
        if st.group_ports.dim() != 2 or st.group_ports.shape[1] != PW:
            raise ValueError("canon_pick: group_ports must be i32[G, W]")
        if not 1 <= R <= 32:
            raise ValueError(f"canon_pick: R = {R} resources, a warp holds 1 to 32")
        p = build.ptr
        self.static = _Static(
            p(cand), p(rank_nj), p(cum_nq), p(ctx.cj), p(ctx.cq), p(ctx.deserved_c),
            p(job_ready_cnt), p(min_avail), p(queue_alloc), p(st.rv_block_start), p(ctx.cres),
            p(st.class_fit), p(st.node_klass), p(st.node_valid), p(st.node_unsched),
            p(st.node_max_tasks), p(node_num_tasks), p(node_ports), p(st.group_klass),
            p(st.group_ports), p(self.picks),
            R, F, int(use_gang), int(use_prop), st.class_fit.shape[1], N, PW, int(preds_on),
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.turn = _Turn()
        self.turn_ptr = ctypes.addressof(self.turn)
        self.fn = build.bind("canon_pick", "kat_canon_pick", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, q: torch.Tensor, g: torch.Tensor, has_grp: torch.Tensor,
                 pop: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
        """-> this launch's pick word i32[1] (N: no feasible node) for the turn of
        queue ``q`` and group ``g`` (i32 or i64 [1]), ``has_grp`` /
        ``pop`` bool[1] and ``req`` f32[R], all on the plan's device."""
        parity = self.launched & 1
        if self.dev.type == "cpu":
            self.words[parity ^ 1].fill_(self.st.num_nodes)
            self.words[parity].copy_(canon_pick_plain(self.st, self.ctx, *self.state, q, g,
                                                      has_grp, pop, req, *self.flags))
            self.launched += 1
            return self.words[parity]
        t = self.turn
        t.q_wide, t.g_wide = WIDE.get(q.dtype, -1), WIDE.get(g.dtype, -1)
        if t.q_wide < 0 or t.g_wide < 0:
            raise TypeError(f"canon_pick: q / g dtypes {q.dtype} / {g.dtype}, want i32 or i64")
        if self.first:  # the turn's flags and row keep their types all action
            R = self.ctx.cres.shape[1]
            for name, x, dt in (("has_grp", has_grp, torch.bool), ("pop", pop, torch.bool),
                                ("req", req, torch.float32)):
                build.require(x, dt, f"canon_pick.{name}", self.dev)
            if req.shape != (R,):
                raise ValueError(f"canon_pick.req: shape {tuple(req.shape)}, want ({R},)")
            if q.device != self.dev or g.device != self.dev:
                raise ValueError("canon_pick: q / g off the plan's device")
            self.first = False
        t.q, t.g, t.has_grp = q.data_ptr(), g.data_ptr(), has_grp.data_ptr()
        t.pop, t.req, t.parity = pop.data_ptr(), req.data_ptr(), parity
        build.check(self.fn(self.static_ptr, self.turn_ptr, self.stream), "canon_pick")
        self.launched += 1
        build.launched(canon_pick)
        return self.words[parity]

    @property
    def pick(self) -> torch.Tensor:
        """The last launch's pick word (i32[1]; before any launch, N)."""
        return self.words[(self.launched - 1) & 1]


def canon_pick(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
               node_ports, node_num_tasks, q, g, has_grp, pop, req,
               use_gang: bool, use_prop: bool, preds_on: bool) -> torch.Tensor:
    """-> pick i32[1] (N: no feasible node).  ``q``/``g`` are i32 or i64
    [1], ``has_grp``/``pop`` bool[1], ``req`` f32[R], all on the device.
    CPU tensors take the plain version; CUDA tensors launch the kernel once
    through a plan of its own."""
    if cand.device.type == "cpu":
        return canon_pick_plain(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail,
                                queue_alloc, node_ports, node_num_tasks, q, g, has_grp, pop, req,
                                use_gang, use_prop, preds_on)
    return CanonPickPlan(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                         node_ports, node_num_tasks, use_gang, use_prop,
                         preds_on)(q, g, has_grp, pop, req)


canon_pick.launches = 0
