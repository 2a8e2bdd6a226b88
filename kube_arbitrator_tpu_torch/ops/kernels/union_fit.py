"""K14 ``union_fit``: each panel row's first feasible reclaim node, from
the round products with the row's own queue subtracted.

Replaces the reference's ops/preempt.py:_union_minus_own (:2609-2620)
and ``_fit_feasible`` (:2058) with the first-fit pick: one row for the
batched engine's thin turn, the RP rows of a speculation window for the
optimistic engine.  Per row r (queue ``q[r]``, group ``g[r]``, request
``req[r]``, ``has_grp[r]``, ``pop[r]``) and node n: the union sums
``pn[n]`` minus the (node, queue) segment total read at the segment's
last slot (binary search of ``n * (Q + 1) + q[r]`` in the ascending
``skey``), then the node screens, ``vic_cnt > 0`` and the weak
``allRes.Less`` screen.  Returns pick i32[rows]: the first feasible
node, N where none is.

The subtraction associates differently from the sequential walk's
direct per-node sum; it is exact while the sums of integral device
units stay below 2^24 (the reference's engines share the caveat).
CUDA source: csrc/union_fit.cu.
"""
from __future__ import annotations

import torch

from . import build
from .build import I, P

ROW_CHUNK = 64  # rows the plain version screens at once

# C signature of csrc/union_fit.cu
SIGNATURES = {
    "kat_union_fit": (
        P, P, P, I, I, I, P, P, P, P, P, I, P, I, P, P, P, P, P, P, P, P, I, I, I, P, P,
    ),
}


def union_minus_own(skey, segcum, pn, q, num_queues):
    """(vic_cnt f32[S, N], vic_res f32[S, N, R]) for the queues ``q``
    i64[S]: the reference's ``_union_minus_own`` per row."""
    N = pn.shape[0]
    Vp = skey.shape[0]
    nodes = torch.arange(N, dtype=torch.int64, device=pn.device)
    keys = (nodes[None, :] * (num_queues + 1) + q[:, None]).to(torch.int32)
    pos = torch.searchsorted(skey, keys, right=True) - 1
    posc = pos.clamp(0, Vp - 1)
    hit = (pos >= 0) & (skey[posc] == keys)
    own = torch.where(hit[..., None], segcum[posc], 0.0)
    return pn[None, :, 0] - own[..., 0], pn[None, :, 1:] - own[..., 1:]


def union_fit_plain(st, skey, segcum, pn, q, g, has_grp, pop, req, node_ports, node_num_tasks,
                    preds_on):
    """The plain version, ROW_CHUNK rows at a time: ``union_minus_own``,
    the reference's ``_fit_feasible`` per row, first feasible node."""
    N, Q = st.num_nodes, st.num_queues
    i64 = torch.int64
    nodes = torch.arange(N, dtype=torch.int32, device=pn.device)
    out = torch.full((q.shape[0],), N, dtype=torch.int32, device=pn.device)
    nk = st.node_klass.to(i64)
    for r0 in range(0, q.shape[0], ROW_CHUNK):
        sl = slice(r0, r0 + ROW_CHUNK)
        gg = g[sl].to(i64)
        vic_cnt, vic_res = union_minus_own(skey, segcum, pn, q[sl].to(i64), Q)
        if preds_on:
            node_ok = (st.class_fit[st.group_klass[gg].to(i64)][:, nk]
                       & st.node_valid[None, :] & ~st.node_unsched[None, :])
            g_ports = st.group_ports[gg]
            node_ok = node_ok & ((g_ports[:, None, :] & node_ports[None]) == 0).all(dim=-1)
            node_ok = node_ok & (st.node_max_tasks - node_num_tasks > 0)[None, :]
        else:
            node_ok = st.node_valid[None, :].expand(gg.shape[0], N)
        weak_ok = ~(vic_res < req[sl][:, None, :]).all(dim=-1)
        feas = node_ok & (vic_cnt > 0) & weak_ok & pop[sl, None] & has_grp[sl, None]
        out[sl] = torch.where(feas, nodes[None, :], N).amin(dim=-1).to(torch.int32)
    return out


def union_fit(st, skey, segcum, pn, q, g, has_grp, pop, req, node_ports, node_num_tasks,
              preds_on: bool) -> torch.Tensor:
    """-> pick i32[rows].  ``q``/``g`` i32[rows], ``has_grp``/``pop``
    bool[rows], ``req`` f32[rows, R]; ``skey`` i32[Vp], ``segcum``
    f32[Vp, R+1] and ``pn`` f32[N, R+1] from K13.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    args = (st, skey, segcum, pn, q, g, has_grp, pop, req, node_ports, node_num_tasks, preds_on)
    if pn.device.type == "cpu":
        return union_fit_plain(*args)
    dev = pn.device
    if dev.type != "cuda":
        raise ValueError(f"union_fit: tensors on {dev}")
    checks = [
        (skey, torch.int32), (segcum, torch.float32), (pn, torch.float32), (q, torch.int32),
        (g, torch.int32), (has_grp, torch.bool), (pop, torch.bool), (req, torch.float32),
        (st.class_fit, torch.bool), (st.node_klass, torch.int32), (st.node_valid, torch.bool),
        (st.node_unsched, torch.bool), (st.node_max_tasks, torch.int32),
        (node_num_tasks, torch.int32), (node_ports, torch.int32), (st.group_klass, torch.int32),
        (st.group_ports, torch.int32),
    ]
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"union_fit.arg{i}", dev)
    rows = q.shape[0]
    N, R = st.num_nodes, pn.shape[1] - 1
    if req.shape != (rows, R) or g.shape != (rows,) or pop.shape != (rows,):
        raise ValueError("union_fit: rows must be q/g/has_grp/pop [rows], req [rows, R]")
    pick = torch.full((rows,), N, dtype=torch.int32, device=dev)
    fn = build.bind("union_fit", "kat_union_fit", SIGNATURES)
    build.check(fn(
        build.ptr(skey), build.ptr(segcum), build.ptr(pn), R, st.num_queues, skey.shape[0],
        build.ptr(q), build.ptr(g), build.ptr(has_grp), build.ptr(pop), build.ptr(req), rows,
        build.ptr(st.class_fit), st.class_fit.shape[1], build.ptr(st.node_klass),
        build.ptr(st.node_valid), build.ptr(st.node_unsched), build.ptr(st.node_max_tasks),
        build.ptr(node_num_tasks), build.ptr(node_ports), build.ptr(st.group_klass),
        build.ptr(st.group_ports), N, node_ports.shape[1], int(preds_on), build.ptr(pick),
        build.stream(),
    ), "union_fit")
    union_fit.launches += 1
    return pick


union_fit.launches = 0
