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
CUDA source: csrc/canon_pick.cu (eligibility in csrc/canon.cuh).
"""
from __future__ import annotations

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .build import I, P
from .segment_sum import segment_sum_plain

EPS = DEVICE_EPSILON

# C signature of csrc/canon_pick.cu
SIGNATURES = {
    "kat_canon_pick": (
        P, P, P, P, P, P, P, P, P, I, I, I, I, P, P, P, P, P, P, P, P, I, P, P, P, P, P,
        P, P, P, I, I, I, P, P,
    ),
}


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


def canon_pick(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
               node_ports, node_num_tasks, q, g, has_grp, pop, req,
               use_gang: bool, use_prop: bool, preds_on: bool) -> torch.Tensor:
    """-> pick i32[1] (N: no feasible node).  ``q``/``g`` are i32[1],
    ``has_grp``/``pop`` bool[1], ``req`` f32[R], all on the device.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    args = (st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
            node_ports, node_num_tasks, q, g, has_grp, pop, req, use_gang, use_prop, preds_on)
    if cand.device.type == "cpu":
        return canon_pick_plain(*args)
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"canon_pick: tensors on {dev}")
    checks = [
        (cand, torch.bool), (rank_nj, torch.float32), (cum_nq, torch.float32),
        (ctx.cj, torch.int32), (ctx.cq, torch.int32), (ctx.deserved_c, torch.float32),
        (job_ready_cnt, torch.int32), (min_avail, torch.int32), (queue_alloc, torch.float32),
        (st.rv_block_start, torch.int32), (ctx.cres, torch.float32), (q, torch.int32),
        (g, torch.int32), (has_grp, torch.bool), (pop, torch.bool), (req, torch.float32),
        (st.class_fit, torch.bool), (st.node_klass, torch.int32), (st.node_valid, torch.bool),
        (st.node_unsched, torch.bool), (st.node_max_tasks, torch.int32),
        (node_num_tasks, torch.int32), (node_ports, torch.int32), (st.group_klass, torch.int32),
        (st.group_ports, torch.int32),
    ]
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"canon_pick.arg{i}", dev)
    N, R = st.num_nodes, ctx.cres.shape[1]
    pick = torch.full((1,), N, dtype=torch.int32, device=dev)
    fn = build.bind("canon_pick", "kat_canon_pick", SIGNATURES)
    build.check(fn(
        build.ptr(cand), build.ptr(rank_nj), build.ptr(cum_nq), build.ptr(ctx.cj),
        build.ptr(ctx.cq), build.ptr(ctx.deserved_c), build.ptr(job_ready_cnt),
        build.ptr(min_avail), build.ptr(queue_alloc), R, cum_nq.shape[1], int(use_gang),
        int(use_prop), build.ptr(st.rv_block_start), build.ptr(ctx.cres), build.ptr(q),
        build.ptr(g), build.ptr(has_grp), build.ptr(pop), build.ptr(req),
        build.ptr(st.class_fit), st.class_fit.shape[1], build.ptr(st.node_klass),
        build.ptr(st.node_valid), build.ptr(st.node_unsched), build.ptr(st.node_max_tasks),
        build.ptr(node_num_tasks), build.ptr(node_ports), build.ptr(st.group_klass),
        build.ptr(st.group_ports), N, node_ports.shape[1], int(preds_on), build.ptr(pick),
        build.stream(),
    ), "canon_pick")
    canon_pick.launches += 1
    return pick


canon_pick.launches = 0
