"""K14 ``union_fit``: each panel row's first feasible reclaim node, from
the round products with the row's own queue subtracted.

Replaces the reference's ops/preempt.py:_union_minus_own (:2609-2620)
and ``_fit_feasible`` (:2058) with the first-fit pick: one row for the
batched engine's thin turn, the RP rows of a speculation window for the
optimistic engine.  Per row r (queue ``q[r]``, group ``g[r]``, request
``req[r]``, ``has_grp[r]``, ``pop[r]``) and node n: the union sums
``pn[n]`` minus the (node, queue) segment total read at the segment's
last slot (the last slot whose key ``n * (Q + 1) + q[r]`` is at most the
row's in the ascending ``skey``), then the node screens, ``vic_cnt > 0``
and the weak ``allRes.Less`` screen.  The pick is the first feasible
node, N where none is.

The plain version searches the whole ``skey`` as the reference does;
the kernel searches only the node's canon block, which finds the same
slot (tests/test_torch_gate_fit_plans.py holds the two searches equal).  The
subtraction associates differently from the sequential walk's direct
per-node sum; it is exact while the sums of integral device units stay
below 2^24 (the reference's engines share the caveat).

:class:`UnionFitPlan` binds one engine call's launches once (a launch
passes only the rows, and the optimistic window's ``ctl``);
:func:`union_fit` is the same through a throwaway plan.  CUDA source:
csrc/union_fit.cu.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .build import P
from .canon_pick import WIDE
from .window_gate import START, TRIP

ROW_CHUNK = 64  # rows the plain version screens at once
MAX_R = 8       # csrc/union_fit.cu's MAX_R
MAX_PW = 32     # csrc/union_fit.cu's MAX_PW

# C signature of csrc/union_fit.cu: (static, call, stream)
SIGNATURES = {"kat_union_fit": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/union_fit.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "class_fit", "node_klass", "node_valid", "node_unsched", "node_max_tasks",
        "node_num_tasks", "node_ports", "group_klass", "group_ports", "skey", "bstart", "pn",
        "segcum", "pick",
    )] + [(n, ctypes.c_int) for n in ("CN", "PW", "preds_on", "R", "Q", "N", "rows")]


class _Call(ctypes.Structure):
    """csrc/union_fit.cu's Call: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("q", "g", "has_grp", "pop", "req", "ctl")] + [
        (n, ctypes.c_int) for n in ("q_wide", "g_wide")]


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


def in_window(ctl, rows: int):
    """bool[rows]: the window's rows below the round's trip
    (``ctl[START] + r < ctl[TRIP]``)."""
    pos = torch.arange(rows, device=ctl.device) + ctl[START]
    return pos < ctl[TRIP]


class UnionFitPlan:
    """K14's launches over one opt-in engine call.

    Built once per ``_reclaim_canon_batched`` / ``_reclaim_canon_optimistic``
    call beside K13's plan: it checks the dtypes and shapes once and
    binds the node screens, ``skey``, the pack's block starts, K13's
    plan-owned ``pn`` / ``segcum``, ``node_ports`` and ``node_num_tasks``
    (K8 changes both in place), the plan's own ``pick`` i32[rows] and the
    predicates flag, and keeps the stream current when it was built.
    Every bound tensor must be updated IN PLACE between launches: a
    launch reads whatever they hold then.  ``pick`` is OVERWRITTEN by
    the next launch (every row, N where none is feasible): the window's
    K15, or the turn's K8, consumes it first.  CPU tensors take the plain
    version, into the same owned ``pick``."""

    def __init__(self, st, skey, segcum, pn, node_ports, node_num_tasks, preds_on: bool,
                 rows: int):
        self.st = st
        self.state = (skey, segcum, pn, node_ports, node_num_tasks)
        self.preds_on = bool(preds_on)
        self.rows = rows
        dev = pn.device
        self.dev = dev
        N = st.num_nodes
        self.pick = torch.full((rows,), N, dtype=torch.int32, device=dev)
        self.first = True
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"union_fit: tensors on {dev}")
        Vp = skey.shape[0]
        C = pn.shape[1]
        R = C - 1
        PW = node_ports.shape[1]
        checks = [
            (skey, torch.int32, (Vp,)), (segcum, torch.float32, (Vp, C)),
            (pn, torch.float32, (N, C)), (st.rv_block_start, torch.int32, (N + 1,)),
            (st.class_fit, torch.bool, None), (st.node_klass, torch.int32, (N,)),
            (st.node_valid, torch.bool, (N,)), (st.node_unsched, torch.bool, (N,)),
            (st.node_max_tasks, torch.int32, (N,)), (node_num_tasks, torch.int32, (N,)),
            (node_ports, torch.int32, (N, PW)), (st.group_klass, torch.int32, None),
            (st.group_ports, torch.int32, None),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"union_fit.arg{i}", dev)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"union_fit.arg{i}: shape {tuple(t.shape)}, want {shape}")
        if st.group_ports.dim() != 2 or st.group_ports.shape[1] != PW:
            raise ValueError("union_fit: group_ports must be i32[G, PW]")
        if not 1 <= R <= MAX_R or PW > MAX_PW:
            raise ValueError(f"union_fit: R = {R}, PW = {PW}; want 1 <= R <= {MAX_R}, "
                             f"PW <= {MAX_PW}")
        p = build.ptr
        self.static = _Static(
            p(st.class_fit), p(st.node_klass), p(st.node_valid), p(st.node_unsched),
            p(st.node_max_tasks), p(node_num_tasks), p(node_ports), p(st.group_klass),
            p(st.group_ports), p(skey), p(st.rv_block_start), p(pn), p(segcum), p(self.pick),
            st.class_fit.shape[1], PW, int(preds_on), R, st.num_queues, N, rows,
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.call = _Call()
        self.call_ptr = ctypes.addressof(self.call)
        self.fn = build.bind("union_fit", "kat_union_fit", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, q: torch.Tensor, g: torch.Tensor, has_grp: torch.Tensor,
                 pop: torch.Tensor, req: torch.Tensor, ctl=None) -> torch.Tensor:
        """-> ``self.pick`` i32[rows] for the rows ``q`` / ``g`` (i32 or
        i64 [rows]), ``has_grp`` / ``pop`` bool[rows] and ``req`` f32[rows,
        R] (f32[R] when rows is 1); with ``ctl`` (the window's, i32), a
        row at or past ``ctl[START] + r >= ctl[TRIP]`` does not pop.  All
        on the plan's device."""
        if self.dev.type == "cpu":
            if ctl is not None:
                pop = pop & in_window(ctl, self.rows)
            skey, segcum, pn, node_ports, node_num_tasks = self.state
            self.pick.copy_(union_fit_plain(self.st, skey, segcum, pn, q, g, has_grp, pop,
                                            req.reshape(self.rows, -1), node_ports,
                                            node_num_tasks, self.preds_on))
            return self.pick
        c = self.call
        c.q_wide, c.g_wide = WIDE.get(q.dtype, -1), WIDE.get(g.dtype, -1)
        if c.q_wide < 0 or c.g_wide < 0:
            raise TypeError(f"union_fit: q / g dtypes {q.dtype} / {g.dtype}, want i32 or i64")
        if self.first:  # the rows keep their types and shapes all engine call
            self._check(q, g, has_grp, pop, req, ctl)
            self.first = False
        c.q, c.g, c.has_grp = q.data_ptr(), g.data_ptr(), has_grp.data_ptr()
        c.pop, c.req, c.ctl = pop.data_ptr(), req.data_ptr(), build.ptr(ctl)
        build.check(self.fn(self.static_ptr, self.call_ptr, self.stream), "union_fit")
        build.launched(union_fit)
        return self.pick

    def _check(self, q, g, has_grp, pop, req, ctl):
        rows, R = self.rows, self.state[2].shape[1] - 1
        for name, x, dt in (("has_grp", has_grp, torch.bool), ("pop", pop, torch.bool),
                            ("req", req, torch.float32), ("q", q, q.dtype), ("g", g, g.dtype)):
            build.require(x, dt, f"union_fit.{name}", self.dev)
        if ctl is not None:
            build.require(ctl, torch.int32, "union_fit.ctl", self.dev)
        if q.shape != (rows,) or g.shape != (rows,) or has_grp.shape != (rows,) \
                or pop.shape != (rows,) or req.numel() != rows * R:
            raise ValueError(f"union_fit: rows must be q / g / has_grp / pop [{rows}], "
                             f"req [{rows}, {R}]")


def union_fit(st, skey, segcum, pn, q, g, has_grp, pop, req, node_ports, node_num_tasks,
              preds_on: bool) -> torch.Tensor:
    """-> pick i32[rows].  ``q``/``g`` i32 or i64 [rows], ``has_grp``/
    ``pop`` bool[rows], ``req`` f32[rows, R]; ``skey`` i32[Vp], ``segcum``
    f32[Vp, R+1] and ``pn`` f32[N, R+1] from K13.  CPU tensors take the
    plain version; CUDA tensors launch the kernel once through a plan of
    its own."""
    if pn.device.type == "cpu":
        return union_fit_plain(st, skey, segcum, pn, q, g, has_grp, pop, req, node_ports,
                               node_num_tasks, preds_on)
    return UnionFitPlan(st, skey, segcum, pn, node_ports, node_num_tasks, preds_on,
                        q.shape[0])(q, g, has_grp, pop, req)


union_fit.launches = 0
