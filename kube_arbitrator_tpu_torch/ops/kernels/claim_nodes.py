"""K6 ``claim_nodes``: the node half of one preempt turn's claim.

Replaces the middle of the reference's ops/preempt.py:_apply_claim
(:439-803): per-node claim capacity over the turn's victims (uniform
victim chunks or the mixed-size bound, the trailing under-covered claim,
pod and host-port clamps), the int32 prefix fill ``p`` of the turn's
budget in node order, preempt's statement gate ``keep`` and, per victim,
the covering-prefix evict rule.  The per-node aggregates are inputs:
``node_victims`` / ``totfree`` summed by K4 in slot order, ``vmax`` /
``vmin`` by an order-free max / min.  The turn's scalars (``g``,
``budget``, ``has_grp``, ``was_ready``, ``need``) stay on the device.
With pod affinity (``pa``: K11's ok mask and the K12 shaping of the
claim capacity, the reference's :513-516 and :604-606) the kernel runs in
two launches with K12 between them: the capacity, then the scan, fill
and evict rule over the shaped capacity.
CUDA source: csrc/claim_nodes.cu.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .admit_chunk import copies_fit, to_i32
from .build import I, P

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG

# C signature of csrc/claim_nodes.cu
SIGNATURES = {
    "kat_claim_nodes": (
        P, P, P, P, P, P, P, P, P, P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, P,
        I, I, I, I, I, I, I, I, P, P, I, P, P, P, P, P, P, P, P,
    ),
}


def claim_nodes_plain(st, node_victims, totfree, vmax, vmin, node_ports, node_num_tasks,
                      victims, vnode, vres, node_rank, node_cum,
                      g, req, budget, has_grp, was_ready, need, s_max, preempt_mode, preds_on,
                      pa=None):
    """The plain version, the reference's arithmetic op for op."""
    cap, full, chunk_m, node_uniform = claim_caps_plain(
        st, node_victims, totfree, vmax, vmin, node_ports, node_num_tasks, g, req, s_max,
        preds_on, None if pa is None else pa[0],
    )
    if pa is not None:
        cap = pa[1](cap)
    return claim_fill_plain(st, cap, full, chunk_m, node_uniform, victims, vnode, vres,
                            node_rank, node_cum, req, budget, has_grp, was_ready, need,
                            preempt_mode)


def claim_caps_plain(st, node_victims, totfree, vmax, vmin, node_ports, node_num_tasks, g, req,
                     s_max, preds_on, pa_ok):
    """Per-node claim capacity (i32[N]) and the values the evict rule
    reads: full claims, victims per claim chunk, uniform-victim flag."""
    if preds_on:
        klass = st.group_klass[g].to(torch.int64)
        static_ok = (
            st.class_fit[klass][:, st.node_klass.to(torch.int64)][0]
            & st.node_valid & ~st.node_unsched
        )
        gports = st.group_ports[g][0]
        ports_ok = ((gports[None, :] & node_ports) == 0).all(dim=-1)
        pods_head = st.node_max_tasks - node_num_tasks
        ok = static_ok & ports_ok & (pods_head > 0)
        has_ports = (gports != 0).any()
    else:
        pods_head = torch.full_like(node_num_tasks, s_max)
        ok = st.node_valid
        has_ports = torch.zeros((), dtype=torch.bool, device=req.device)
    if pa_ok is not None:
        ok = ok & pa_ok
    ok = ok & (node_victims > 0)
    weak_ok = ~(totfree < req[None, :]).all(dim=-1)
    reqpos = req[None, :] > 0
    nvf = node_victims.to(torch.float32)
    node_uniform = ((vmax - vmin) <= EPS).all(dim=-1) & (node_victims > 0)
    full_mixed = copies_fit(totfree, req)
    m_per_dim = torch.where(reqpos, torch.ceil((req[None, :] - EPS) / vmax.clamp(min=1e-30)), 1.0)
    m_per_dim = torch.where(reqpos & (vmax <= EPS), BIG, m_per_dim)
    chunk_m = m_per_dim.amax(dim=-1).clamp(min=1.0)
    full_uniform = torch.floor(nvf / chunk_m)
    full = torch.where(node_uniform, full_uniform, full_mixed).clamp(max=float(s_max))
    rem_uniform = (nvf - full * chunk_m).clamp(min=0.0)[:, None] * vmax
    rem_mixed = (totfree - full[:, None] * req[None, :]).clamp(min=0.0)
    remaining = torch.where(node_uniform[:, None], rem_uniform, rem_mixed)
    weak_rem = ~(remaining < req[None, :]).all(dim=-1)
    partial_mixed = (reqpos & (rem_mixed > EPS)).any(dim=-1)
    partial_uniform = nvf > full * chunk_m
    partial = (torch.where(node_uniform, partial_uniform, partial_mixed) & weak_rem) | (full < 1.0)
    cap = torch.minimum(full + partial.to(torch.float32), nvf)
    cap = torch.minimum(cap, pods_head.to(torch.float32))
    cap = torch.where(has_ports, cap.clamp(max=1.0), cap)
    cap = torch.where(ok & weak_ok, cap, 0.0)
    return to_i32(cap.clamp(min=0.0)), full, chunk_m, node_uniform


def claim_fill_plain(st, cap, full, chunk_m, node_uniform, victims, vnode, vres, node_rank,
                     node_cum, req, budget, has_grp, was_ready, need, preempt_mode):
    """The scan, fill, statement gate and evict rule over ``cap``."""
    cum = torch.cumsum(cap, 0, dtype=torch.int32)
    placed_pre = torch.minimum(budget, cum[-1:])
    p = torch.minimum((placed_pre - (cum - cap)).clamp(min=0), cap)
    if preempt_mode:
        keep = ~(has_grp & ~was_ready & (placed_pre < budget) & (placed_pre < need))
    else:
        keep = torch.ones_like(has_grp)
    placed_total = torch.where(keep, placed_pre, 0)
    p = p * keep.to(torch.int32)
    use_partial = p > to_i32(full)
    needed = torch.where(use_partial[:, None], BIG, p.to(torch.float32)[:, None] * req[None, :] - EPS)
    rank_needed = torch.where(use_partial, float(st.num_tasks), p.to(torch.float32) * chunk_m)
    vn = torch.where(victims, vnode, 0).to(torch.int64)
    c_excl = node_cum - torch.where(victims[:, None], vres, 0.0)
    cum_rule = (c_excl < needed[vn]).any(dim=-1) | (node_rank < p[vn])
    rank_rule = node_rank.to(torch.float32) < rank_needed[vn]
    evict = victims & torch.where(node_uniform[vn], rank_rule, cum_rule) & (p[vn] > 0)
    placed = torch.cat([placed_total, placed_pre]).to(torch.int32)
    return p.to(torch.int32), cum, placed, evict


def claim_nodes(
    st,
    node_victims: torch.Tensor,    # i32[N]
    totfree: torch.Tensor,         # f32[N, R]
    vmax: torch.Tensor,            # f32[N, R] (-BIG where no victim)
    vmin: torch.Tensor,            # f32[N, R] (BIG where no victim)
    node_ports: torch.Tensor,      # i32[N, W]
    node_num_tasks: torch.Tensor,  # i32[N]
    victims: torch.Tensor,         # bool[P] this turn's victims
    vnode: torch.Tensor,           # i32[P]
    vres: torch.Tensor,            # f32[P, R] panel resreq (unmasked)
    node_rank: torch.Tensor,       # i32[P] in-(node, queue) exclusive victim rank
    node_cum: torch.Tensor,        # f32[P, R] in-(node, queue) inclusive victim cum
    g: torch.Tensor,               # i64/i32[1] claimant group
    req: torch.Tensor,             # f32[R]
    budget: torch.Tensor,          # i32[1] phase-shaped budget
    has_grp: torch.Tensor,         # bool[1]
    was_ready: torch.Tensor,       # bool[1]
    need: torch.Tensor,            # i32[1] tasks to gang readiness
    s_max: int,
    preempt_mode: bool,            # phase 1 (the statement gate) vs phase 2
    preds_on: bool,
    pa: Optional[Tuple[torch.Tensor, Callable]] = None,  # (ok bool[N], caps -> shaped caps)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (p i32[N], cum i32[N], [placed_total, placed_pre] i32[2],
    evict bool[P]).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (twice, around ``pa``'s shaping, with pod
    affinity)."""
    args = (st, node_victims, totfree, vmax, vmin, node_ports, node_num_tasks, victims,
            vnode, vres, node_rank, node_cum, g, req, budget, has_grp, was_ready, need,
            s_max, preempt_mode, preds_on, pa)
    if totfree.device.type == "cpu":
        return claim_nodes_plain(*args)
    dev = totfree.device
    if dev.type != "cuda":
        raise ValueError(f"claim_nodes: tensors on {dev}")
    N, R = totfree.shape
    Pn = victims.shape[0]
    W = node_ports.shape[1]
    g32 = g.to(torch.int32).contiguous()
    checks = [
        (node_victims, torch.int32), (totfree, torch.float32), (vmax, torch.float32),
        (vmin, torch.float32), (node_ports, torch.int32), (node_num_tasks, torch.int32),
        (victims, torch.bool), (vnode, torch.int32), (vres, torch.float32),
        (node_rank, torch.int32), (node_cum, torch.float32), (req, torch.float32),
        (budget, torch.int32), (has_grp, torch.bool), (was_ready, torch.bool),
        (need, torch.int32), (st.class_fit, torch.bool), (st.node_klass, torch.int32),
        (st.node_valid, torch.bool), (st.node_unsched, torch.bool),
        (st.node_max_tasks, torch.int32), (st.group_klass, torch.int32),
        (st.group_ports, torch.int32),
    ]
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"claim_nodes.arg{i}", dev)
    if (vmax.shape != (N, R) or vmin.shape != (N, R) or vres.shape != (Pn, R)
            or node_cum.shape != (Pn, R) or req.shape != (R,)):
        raise ValueError("claim_nodes: node/panel shapes disagree")
    full_s = torch.empty(N, dtype=torch.float32, device=dev)
    chunk_s = torch.empty(N, dtype=torch.float32, device=dev)
    unif_s = torch.empty(N, dtype=torch.bool, device=dev)
    p = torch.empty(N, dtype=torch.int32, device=dev)
    cum = torch.empty(N, dtype=torch.int32, device=dev)
    placed = torch.empty(2, dtype=torch.int32, device=dev)
    evict = torch.empty(Pn, dtype=torch.bool, device=dev)
    fn = build.bind("claim_nodes", "kat_claim_nodes", SIGNATURES)
    pa_ok = None
    if pa is not None:
        pa_ok = pa[0]
        build.require(pa_ok, torch.bool, "claim_nodes.pa_ok", dev)

    def launch(phase, cap_in=None):
        build.check(fn(
            build.ptr(g32), build.ptr(req), build.ptr(budget), build.ptr(has_grp),
            build.ptr(was_ready), build.ptr(need), build.ptr(node_victims), build.ptr(totfree),
            build.ptr(vmax), build.ptr(vmin), build.ptr(st.class_fit), st.class_fit.shape[1],
            build.ptr(st.node_klass), build.ptr(st.node_valid), build.ptr(st.node_unsched),
            build.ptr(st.node_max_tasks), build.ptr(node_ports), build.ptr(node_num_tasks),
            build.ptr(st.group_klass), build.ptr(st.group_ports), build.ptr(victims),
            build.ptr(vnode), build.ptr(vres), build.ptr(node_rank), build.ptr(node_cum),
            Pn, N, R, W, s_max, st.num_tasks, int(preempt_mode), int(preds_on),
            build.ptr(pa_ok), build.ptr(cap_in), phase,
            build.ptr(full_s), build.ptr(chunk_s), build.ptr(unif_s), build.ptr(p),
            build.ptr(cum), build.ptr(placed), build.ptr(evict), build.stream(),
        ), "claim_nodes")
        claim_nodes.launches += 1

    if pa is None:
        launch(0)
    else:
        launch(1)
        shaped = pa[1](p).contiguous()
        build.require(shaped, torch.int32, "claim_nodes.shaped_caps", dev)
        launch(2, shaped)
    return p, cum, placed, evict


claim_nodes.launches = 0
