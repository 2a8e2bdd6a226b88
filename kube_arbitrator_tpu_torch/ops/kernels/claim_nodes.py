"""K6 ``claim_nodes``: the node half of one preempt turn's claim.

Replaces the middle of the reference's ops/preempt.py:_apply_claim
(:439-803): the per-node victim aggregates (the victim count and resreq
sums in slot order, the order-free max / min: :func:`claim_aggregates`),
the claim capacity over them (uniform victim chunks or the mixed-size
bound, the trailing under-covered claim, pod and host-port clamps), the
int32 prefix fill ``p`` of the turn's budget in node order, preempt's
statement gate ``keep``, per victim the covering-prefix evict rule, and
the evicted resreq ``freed`` per node in slot order.  The turn's scalars
(``g``, ``budget``, ``has_grp``, ``was_ready``, ``need``) stay on the
device.  With pod affinity (``pa``: K11's ok mask and the K12 shaping of
the claim capacity, the reference's :513-516 and :604-606) a turn is two
launches with K12 between them: the capacity, then the scan, fill, evict
rule and freed over the shaped capacity.

:class:`ClaimNodesPlan` binds a preempt round loop's launches once (the
pack, the victim view, K11's and K12's plans, its own outputs); a launch
passes only the turn's tensors.  CUDA source: csrc/claim_nodes.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...cache.snapshot import DEVICE_EPSILON
from . import build
from .admit_chunk import copies_fit, to_i32
from .build import I, P
from .canon_pick import WIDE
from .segment_sum import segment_sum

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG
MAX_R = 8  # csrc/claim_nodes.cu's MAX_R: resources a launch holds

# C signatures of csrc/claim_nodes.cu: (static, call, stream); the grid of N nodes
SIGNATURES = {"kat_claim_nodes": (P, P, P), "kat_claim_nodes_grid": (I, I)}


class _Static(ctypes.Structure):
    """csrc/claim_nodes.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "class_fit", "node_klass", "node_valid", "node_unsched", "node_max_tasks", "group_klass",
        "group_ports", "perm", "seg_start", "vres", "pa_ok", "p", "cum", "placed", "evict",
        "freed", "full_s", "chunk_s", "unif_s", "agg_nv", "agg_tot", "agg_max", "agg_min",
        "words",
    )] + [(n, ctypes.c_int) for n in (
        "CN", "N", "R", "W", "T", "s_max", "preempt_mode", "preds_on", "grid")]


class _Call(ctypes.Structure):
    """csrc/claim_nodes.cu's Call: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "g", "req", "budget", "has_grp", "was_ready", "need", "victims", "node_rank", "node_cum",
        "node_ports", "node_num_tasks",
    )] + [(n, ctypes.c_int) for n in ("g_wide", "phase")] + [("seq", ctypes.c_uint)]


def claim_aggregates(vnode, node_order, vres, victims, N: int):
    """(node_victims i32[N], totfree f32[N, R], vmax, vmin f32[N, R]): the
    reference's per-node aggregates of the turn's victims — the count and
    the resreq sums in slot order (K4 over the view's node order, the
    reference's scatter-add order) and the order-free max / min (-BIG /
    BIG where a node has no victim).  The card's K6 launch computes them
    itself (in the same order); this is their plain version."""
    R = vres.shape[1]
    masked = torch.where(victims[:, None], vres, 0.0)
    agg = segment_sum(torch.cat([victims.to(torch.float32)[:, None], masked], dim=1), vnode, N,
                      order=node_order)
    vsel = torch.where(victims, vnode, N).to(torch.int64)[:, None].expand(-1, R)
    vmax = torch.full((N + 1, R), -BIG, dtype=torch.float32, device=vres.device)
    vmax.scatter_reduce_(0, vsel, torch.where(victims[:, None], vres, -BIG), "amax")
    vmin = torch.full((N + 1, R), BIG, dtype=torch.float32, device=vres.device)
    vmin.scatter_reduce_(0, vsel, torch.where(victims[:, None], vres, BIG), "amin")
    return (agg[:, 0].to(torch.int32), agg[:, 1:].contiguous(), vmax[:N].contiguous(),
            vmin[:N].contiguous())


def claim_nodes_plain(st, vnode, node_order, vres, victims, node_rank, node_cum, node_ports,
                      node_num_tasks, g, req, budget, has_grp, was_ready, need, s_max,
                      preempt_mode, preds_on, pa=None):
    """The plain version, the reference's arithmetic op for op: -> (p
    i32[N], cum i32[N], [placed_total, placed_pre] i32[2], evict bool[P],
    freed f32[N, R])."""
    N = st.num_nodes
    aggs = claim_aggregates(vnode, node_order, vres, victims, N)
    cap, full, chunk_m, node_uniform = claim_caps_plain(
        st, *aggs, node_ports, node_num_tasks, g, req, s_max, preds_on,
        None if pa is None else pa[0],
    )
    if pa is not None:
        cap = pa[1](cap)
    p, cum, placed, evict = claim_fill_plain(st, cap, full, chunk_m, node_uniform, victims, vnode,
                                             vres, node_rank, node_cum, req, budget, has_grp,
                                             was_ready, need, preempt_mode)
    freed = segment_sum(torch.where(evict[:, None], vres, 0.0), vnode, N, order=node_order)
    return p, cum, placed, evict, freed


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


class ClaimNodesPlan:
    """K6's launches over one preempt round loop (one phase of a preempt
    action: ``_rounds`` / ``_rounds_batched``).

    Built once where the loop starts: it checks the pack's and the victim
    view's tensors once, binds them (with K11's plan-owned ok mask where
    ``pa`` = (PaFitPlan, PaShapePlan) is given) in a struct the kernel
    reads, keeps the stream current when it was built, and owns its
    outputs ``p``, ``cum``, ``placed``, ``evict``, ``freed``, its
    scratch and its count words
    (zeroed once; each launch stamps its number).  A launch passes only
    the turn's tensors, reads ``g`` as i32 or i64, casts, checks and
    allocates nothing: one launch a turn, two under pod affinity with
    K12 shaping ``p`` between them (the caller launches K11 first).  Its
    outputs are OVERWRITTEN by the next launch: a turn consumes them
    before the next turn.  CPU tensors take the plain version, into the
    same owned outputs.

    ``aggregates`` exists only for the tests that hold the kernel's folded
    per-node victim aggregates against :func:`claim_aggregates`: the plan
    then also owns ``aggs`` (count, sums, max, min) and the kernel writes
    them.  No caller of the port sets it."""

    launches = 0  # K6 launches, counted where a launch is issued

    def __init__(self, st, view, s_max: int, preempt_mode: bool, preds_on: bool,
                 pa: Optional[tuple] = None, aggregates: bool = False):
        N, (Pn, R) = st.num_nodes, view.resreq.shape
        dev = view.resreq.device
        self.st, self.s_max, self.preempt_mode, self.preds_on = st, s_max, preempt_mode, preds_on
        self.pa = pa
        self.vnode, self.node_order, self.vres = view.node, view.node_order, view.resreq
        i32, f32 = torch.int32, torch.float32
        self.p = torch.zeros(N, dtype=i32, device=dev)
        self.cum = torch.zeros(N, dtype=i32, device=dev)
        self.placed = torch.zeros(2, dtype=i32, device=dev)
        self.evict = torch.zeros(Pn, dtype=torch.bool, device=dev)  # slots of no node stay False
        self.freed = torch.zeros((N, R), dtype=f32, device=dev)
        self.aggs = None
        if aggregates:
            self.aggs = (torch.zeros(N, dtype=i32, device=dev),
                         *(torch.zeros((N, R), dtype=f32, device=dev) for _ in range(3)))
        self.dev, self.first = dev, True
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"claim_nodes: tensors on {dev}")
        if not 1 <= R <= MAX_R:
            raise ValueError(f"claim_nodes: {R} resources, the kernel holds 1 to {MAX_R}")
        perm, seg_start = view.node_order
        W = st.group_ports.shape[1]
        checks = [
            (st.class_fit, torch.bool, None), (st.node_klass, i32, (N,)),
            (st.node_valid, torch.bool, (N,)), (st.node_unsched, torch.bool, (N,)),
            (st.node_max_tasks, i32, (N,)), (st.group_klass, i32, None),
            (st.group_ports, i32, None), (perm, i32, (Pn,)), (seg_start, i32, (N + 1,)),
            (view.resreq, f32, (Pn, R)),
        ]
        if pa is not None:
            checks.append((pa[0].fit.ok, torch.bool, (N,)))
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"claim_nodes.arg{i}", dev)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"claim_nodes.arg{i}: shape {tuple(t.shape)}, want {shape}")
        self.full_s = torch.empty(N, dtype=f32, device=dev)
        self.chunk_s = torch.empty(N, dtype=f32, device=dev)
        self.unif_s = torch.empty(N, dtype=torch.bool, device=dev)
        grid = build.bind("claim_nodes", "kat_claim_nodes_grid", SIGNATURES)(N, R)
        if grid <= 0:
            raise RuntimeError("claim_nodes: no launch grid for this card")
        self.words = torch.zeros(grid, dtype=torch.int64, device=dev)
        ptr = build.ptr
        aggs = self.aggs or (None,) * 4
        self.static = _Static(
            ptr(st.class_fit), ptr(st.node_klass), ptr(st.node_valid), ptr(st.node_unsched),
            ptr(st.node_max_tasks), ptr(st.group_klass), ptr(st.group_ports), ptr(perm),
            ptr(seg_start), ptr(view.resreq), ptr(None if pa is None else pa[0].fit.ok),
            ptr(self.p), ptr(self.cum), ptr(self.placed), ptr(self.evict), ptr(self.freed),
            ptr(self.full_s), ptr(self.chunk_s), ptr(self.unif_s), *(ptr(a) for a in aggs),
            ptr(self.words), st.class_fit.shape[1], N, R, W, st.num_tasks, s_max,
            int(preempt_mode), int(preds_on), grid,
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.call = _Call()
        self.call_ptr = ctypes.addressof(self.call)
        self.fn = build.bind("claim_nodes", "kat_claim_nodes", SIGNATURES)
        self.stream = build.stream()

    @property
    def outputs(self) -> Tuple[torch.Tensor, ...]:
        return self.p, self.cum, self.placed, self.evict, self.freed

    def __call__(self, victims, node_rank, node_cum, node_ports, node_num_tasks, g, req, budget,
                 has_grp, was_ready, need) -> Tuple[torch.Tensor, ...]:
        """One turn: ``victims`` bool[P], ``node_rank`` i32[P], ``node_cum``
        f32[P, R], ``node_ports`` i32[N, W], ``node_num_tasks`` i32[N], ``g``
        i32 / i64 [1], ``req`` f32[R], ``budget`` / ``need`` i32[1],
        ``has_grp`` / ``was_ready`` bool[1] -> (p i32[N], cum i32[N],
        [placed_total, placed_pre] i32[2], evict bool[P], freed f32[N, R]),
        the plan's own tensors."""
        if self.dev.type == "cpu":
            pa = None if self.pa is None else (self.pa[0].fit.ok, self.pa[1])
            got = claim_nodes_plain(
                self.st, self.vnode, self.node_order, self.vres, victims, node_rank, node_cum,
                node_ports, node_num_tasks, g, req, budget, has_grp, was_ready, need, self.s_max,
                self.preempt_mode, self.preds_on, pa)
            for out, x in zip(self.outputs, got):
                out.copy_(x)
            if self.aggs is not None:
                for out, x in zip(self.aggs, claim_aggregates(self.vnode, self.node_order,
                                                              self.vres, victims, len(self.p))):
                    out.copy_(x)
            return self.outputs
        c = self.call
        c.g_wide = WIDE.get(g.dtype, -1)
        if c.g_wide < 0:
            raise TypeError(f"claim_nodes: g dtype {g.dtype}, want i32 or i64")
        if self.first:  # a turn's tensors keep their types all round loop
            self._check_turn(victims, node_rank, node_cum, node_ports, node_num_tasks, g, req,
                             budget, has_grp, was_ready, need)
            self.first = False
        c.g, c.req, c.budget = g.data_ptr(), req.data_ptr(), budget.data_ptr()
        c.has_grp, c.was_ready, c.need = has_grp.data_ptr(), was_ready.data_ptr(), need.data_ptr()
        c.victims, c.node_rank, c.node_cum = victims.data_ptr(), node_rank.data_ptr(), \
            node_cum.data_ptr()
        c.node_ports, c.node_num_tasks = node_ports.data_ptr(), node_num_tasks.data_ptr()
        if self.pa is None:
            self._launch(0)
        else:
            self._launch(1)
            self.pa[1](self.p)  # K12 shapes the claim capacity in place
            self._launch(2)
        return self.outputs

    def _launch(self, phase: int) -> None:
        c = self.call
        c.phase = phase
        c.seq = c.seq % 0xFFFFFFFF + 1  # 1, 2, ..., never 0 (the zeroed words' number)
        build.check(self.fn(self.static_ptr, self.call_ptr, self.stream), "claim_nodes")
        build.launched(ClaimNodesPlan)

    def _check_turn(self, victims, node_rank, node_cum, node_ports, node_num_tasks, g, req,
                    budget, has_grp, was_ready, need) -> None:
        N, (Pn, R) = len(self.p), self.vres.shape
        W = self.st.group_ports.shape[1]
        checks = [
            (victims, torch.bool, (Pn,)), (node_rank, torch.int32, (Pn,)),
            (node_cum, torch.float32, (Pn, R)), (node_ports, torch.int32, (N, W)),
            (node_num_tasks, torch.int32, (N,)), (g, g.dtype, None), (req, torch.float32, (R,)),
            (budget, torch.int32, None), (has_grp, torch.bool, None),
            (was_ready, torch.bool, None), (need, torch.int32, None),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"claim_nodes.turn{i}", self.dev)
            if (shape is None and t.numel() < 1) or (shape is not None and tuple(t.shape) != shape):
                raise ValueError(f"claim_nodes.turn{i}: shape {tuple(t.shape)}")

