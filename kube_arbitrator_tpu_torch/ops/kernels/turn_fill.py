"""K10 ``turn_fill``: one immediate-path turn's fill, node writeback and
task decode.

Replaces the second half of ops/allocate.py:_process_queue (:623-706) of
the reference: ``use_rel`` from the idle row's sum, the exact int32
prefix fill in packing order, ``p`` scattered back to node order into
node_idle / node_releasing / node_num_tasks / node_ports (in place), the
slot -> node map and the decode of the group's pending tasks by rank
(task_status / task_node, in place).  Returns the turn's placed count
and fallback flag on the device.

:class:`TurnFillPlan` binds an immediate action's launches once (a
launch passes the turn's g, req and budget) and picks the decode's
route when bound: ``by_group`` (the group's placed tasks found through a
group -> task index in rank order, built and checked on the device once
per plan) or ``walk`` (the whole task axis, for a pack whose ranks fail
the check).  :func:`turn_fill` is the same through a throwaway plan.
CUDA source: csrc/turn_fill.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...api.types import TaskStatus
from . import build
from .build import I, P

ALLOCATED = int(TaskStatus.ALLOCATED)
PIPELINED = int(TaskStatus.PIPELINED)

# C signatures of csrc/turn_fill.cu
SIGNATURES = {
    "kat_turn_fill": (P, P, I, P, P, P),  # static, g, g_wide, req, budget, stream
    # task_group, task_group_rank, task_valid, T, G, gstart, gidx, hits, bad, stream
    "kat_turn_fill_index": (P, P, P, I, I, P, P, P, P, P),
}
VARIANTS = ("by_group", "walk")  # csrc/turn_fill.cu's V_* values, in order
# the walk route keeps an int a node in shared memory
WALK_MAX_N = 49_152


class _Static(ctypes.Structure):
    """csrc/turn_fill.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "k_rows", "nperm", "group_ports", "group_placed", "idle", "rel", "node_ports",
        "node_num_tasks", "task_group", "task_group_rank", "task_valid", "task_status",
        "task_node", "node_of_slot", "gstart", "gidx", "placed", "use_rel",
    )] + [(n, ctypes.c_int) for n in (
        "N", "R", "W", "T", "s_max", "best_effort", "preds_on", "variant")]


def group_index_plain(task_group: torch.Tensor, task_group_rank: torch.Tensor,
                      task_valid: torch.Tensor, G: int) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(gstart i32[G + 1], gidx i32[T], ok): the valid tasks of each group
    0..G-1 in rank order — task ``gidx[gstart[g] + r]`` is group g's task
    of rank r — and whether every index slot is written exactly once
    (each group's ranks are 0..n-1, each once).  ``gidx`` is zeros where
    not ``ok``."""
    T = task_group.shape[0]
    member = task_valid & (task_group >= 0) & (task_group < G)
    t = torch.nonzero(member).reshape(-1)
    g = task_group[t].to(torch.int64)
    r = task_group_rank[t].to(torch.int64)
    counts = torch.bincount(g, minlength=G)[:G]
    gstart = torch.zeros(G + 1, dtype=torch.int64, device=task_group.device)
    gstart[1:] = torch.cumsum(counts, 0)
    pos = gstart[g] + r
    ok = bool(((r >= 0) & (r < counts[g])).all()) and torch.unique(pos).numel() == pos.numel()
    gidx = torch.zeros(T, dtype=torch.int32, device=task_group.device)
    if ok:
        gidx[pos] = t.to(torch.int32)
    return gstart.to(torch.int32), gidx, ok


def turn_fill_plain(st, k, nperm, g, req, budget, group_placed, node_idle, node_releasing,
                    node_ports, node_num_tasks, task_status, task_node, s_max, best_effort,
                    preds_on):
    """The plain version: the reference's fill and decode op for op,
    writing the node and task state in place."""
    N = k.shape[1]
    dev = k.device
    gi = g.reshape(-1)[:1].to(torch.int64)
    k_idle, k_rel = k[0], k[1]
    use_rel = (k_idle.sum() == 0) & (budget > 0)
    if best_effort:
        use_rel = torch.zeros_like(use_rel)
    k_eff = torch.where(use_rel, k_rel, k_idle)
    cum = torch.cumsum(k_eff, 0, dtype=torch.int32)
    placed_total = torch.minimum(budget, cum[-1:]).to(torch.int32)
    p_p = torch.minimum((placed_total - (cum - k_eff)).clamp(min=0), k_eff)
    if nperm is None:
        p = p_p
    else:
        p = torch.zeros_like(p_p).scatter_(0, nperm.to(torch.int64), p_p)
    pf = p.to(torch.float32)[:, None] * req[None, :]
    node_idle.copy_(torch.where(use_rel, node_idle, node_idle - pf))
    node_releasing.copy_(torch.where(use_rel, node_releasing - pf, node_releasing))
    if preds_on:
        gports = st.group_ports[gi][0]
        has_ports = (gports != 0).any()
        node_ports.copy_(torch.where(((p > 0) & has_ports)[:, None], node_ports | gports,
                                     node_ports))
    node_num_tasks.add_(p)
    slots = torch.arange(s_max, dtype=torch.int32, device=dev)
    node_of_slot = torch.searchsorted(cum, slots, right=True, out_int32=True)
    if nperm is not None:
        node_of_slot = nperm[node_of_slot.clamp(0, N - 1).to(torch.int64)]
    slot_of_task = st.task_group_rank - group_placed[gi]
    assigned = ((st.task_group == g.reshape(-1)[:1]) & (slot_of_task >= 0)
                & (slot_of_task < placed_total) & st.task_valid)
    tnode = node_of_slot[slot_of_task.clamp(0, s_max - 1).to(torch.int64)]
    new_status = torch.where(use_rel, PIPELINED, ALLOCATED).to(torch.int32)
    task_status.copy_(torch.where(assigned, new_status, task_status))
    task_node.copy_(torch.where(assigned, tnode, task_node))
    return placed_total, use_rel.reshape(1)


def build_group_index(st) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gstart i32[G + 1], gidx i32[T], bad i32[1]): the group -> task
    index of the card pack ``st`` in rank order, built in one launch;
    ``bad`` counts the ranks that fail its check (the by_group route is
    legal when it is 0).  Nothing is read on the host."""
    dev = st.task_group.device
    T, G = st.task_group.shape[0], st.group_ports.shape[0]
    for name, t, dt in (("task_group", st.task_group, torch.int32),
                        ("task_group_rank", st.task_group_rank, torch.int32),
                        ("task_valid", st.task_valid, torch.bool)):
        build.require(t, dt, f"turn_fill.{name}", dev)
    gstart = torch.empty(G + 1, dtype=torch.int32, device=dev)
    gidx = torch.empty(max(T, 1), dtype=torch.int32, device=dev)
    hits = torch.empty(max(T, 1), dtype=torch.int32, device=dev)
    bad = torch.empty(1, dtype=torch.int32, device=dev)
    fn = build.bind("turn_fill", "kat_turn_fill_index", SIGNATURES)
    p = build.ptr
    build.check(fn(p(st.task_group), p(st.task_group_rank), p(st.task_valid), T, G,
                   p(gstart), p(gidx), p(hits), p(bad), build.stream()), "turn_fill_index")
    turn_fill.variants["index"] += 1
    return gstart, gidx, bad


class TurnFillPlan:
    """K10's launches over one immediate action.

    Built once per action beside K9's plan (``allocate._turn_plans``):
    it binds K9's plan-owned capacity rows ``k`` and order ``nperm`` (K12
    shapes ``k`` in place before each launch), ``group_placed``, the node
    arrays, ``task_status`` / ``task_node``, the pack's group ports and
    task columns, ``s_max`` and the flags, checks them once and keeps the
    stream current when it was built.  Every bound tensor is updated IN
    PLACE between launches (K9 and K12 write ``k`` / ``nperm``, K10 the
    node and task state, ``_process_queue`` ``group_placed``).  A launch
    passes the turn's ``g`` (i32 or i64), ``req`` and ``budget``.  Its
    ``placed`` / ``use_rel`` are the plan's own tensors, OVERWRITTEN by
    the next launch: the turn's aggregate commit consumes them in stream
    order first.  The slot -> node map is plan scratch.

    The route (``variant``, default: ``by_group`` when the pack's group
    ranks pass the index check, else ``walk``) is chosen here, at one
    host read of the check; ``variant="walk"`` forces the walk and builds
    no index.  ``index`` = (gstart, gidx, ok) is an index the caller built
    with :func:`build_group_index` and whose check it read itself (the
    cycle reads it through its host-read seam, ops/steps.py); the plan
    then reads nothing.  CPU tensors take :func:`turn_fill_plain` in
    either route, into the same owned outputs."""

    def __init__(self, st, k, nperm, group_placed, node_idle, node_releasing, node_ports,
                 node_num_tasks, task_status, task_node, s_max: int, best_effort: bool,
                 preds_on: bool, variant: Optional[str] = None, index=None):
        if variant is not None and variant not in VARIANTS:
            raise ValueError(f"turn_fill: variant {variant!r}")
        dev = k.device
        self.st, self.dev = st, dev
        self.rows = (k, nperm)
        self.state = (group_placed, node_idle, node_releasing, node_ports, node_num_tasks,
                      task_status, task_node)
        self.s_max, self.best_effort, self.preds_on = s_max, bool(best_effort), bool(preds_on)
        if s_max < 1:
            raise ValueError("turn_fill: s_max must be at least 1")
        self.placed = torch.zeros(1, dtype=torch.int32, device=dev)
        self.use_rel = torch.zeros(1, dtype=torch.bool, device=dev)
        self.first = True
        N, R = node_idle.shape
        T = task_status.shape[0]
        G = st.group_ports.shape[0]
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"turn_fill: tensors on {dev}")
        self.gstart = self.gidx = None
        ok = False
        if variant != "walk":
            if dev.type == "cpu":  # the route's name only: the CPU decodes the plain way
                ok = group_index_plain(st.task_group, st.task_group_rank, st.task_valid, G)[2]
            else:
                if index is None:
                    gstart, gidx, bad = build_group_index(st)
                    index = (gstart, gidx, int(bad) == 0)  # the plan's one host read
                self.gstart, self.gidx, ok = index
        if variant == "by_group" and not ok:
            raise ValueError("turn_fill: the pack's group ranks fail the index check")
        self.variant = variant or ("by_group" if ok else "walk")
        if dev.type == "cpu":
            return
        if self.variant == "walk" and N > WALK_MAX_N:
            raise ValueError(f"turn_fill: {N} nodes exceed the walk route's {WALK_MAX_N}")
        W = node_ports.shape[1]
        checks = [
            (k, torch.int32, (2, N)), (group_placed, torch.int32, (G,)),
            (node_idle, torch.float32, (N, R)), (node_releasing, torch.float32, (N, R)),
            (node_ports, torch.int32, (N, W)), (node_num_tasks, torch.int32, (N,)),
            (task_status, torch.int32, (T,)), (task_node, torch.int32, (T,)),
            (st.group_ports, torch.int32, (G, W)), (st.task_group, torch.int32, (T,)),
            (st.task_group_rank, torch.int32, (T,)), (st.task_valid, torch.bool, (T,)),
        ] + ([(nperm, torch.int32, (N,))] if nperm is not None else [])
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"turn_fill.arg{i}", dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"turn_fill.arg{i}: shape {tuple(t.shape)}, want {shape}")
        self.node_of_slot = torch.empty(s_max, dtype=torch.int32, device=dev)
        p = build.ptr
        self.static = _Static(
            p(k), p(nperm), p(st.group_ports), p(group_placed), p(node_idle), p(node_releasing),
            p(node_ports), p(node_num_tasks), p(st.task_group), p(st.task_group_rank),
            p(st.task_valid), p(task_status), p(task_node), p(self.node_of_slot), p(self.gstart),
            p(self.gidx), p(self.placed), p(self.use_rel),
            N, R, W, T, s_max, int(best_effort), int(preds_on), VARIANTS.index(self.variant),
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("turn_fill", "kat_turn_fill", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, g: torch.Tensor, req: torch.Tensor, budget: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (``self.placed`` i32[1], ``self.use_rel`` bool[1]) for the
        turn of group ``g`` (i32 or i64 [1]) with ``req`` f32[R] and
        ``budget`` i32[1]; the node and task state written in place."""
        k, nperm = self.rows
        if self.dev.type == "cpu":
            placed, use_rel = turn_fill_plain(self.st, k, nperm, g, req, budget, *self.state,
                                              self.s_max, self.best_effort, self.preds_on)
            self.placed.copy_(placed)
            self.use_rel.copy_(use_rel)
        else:
            if g.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"turn_fill: group dtype {g.dtype}")
            if self.first:  # the turn's row and budget keep their types all action
                R = self.state[1].shape[1]
                build.require(req, torch.float32, "turn_fill.req", self.dev)
                build.require(budget, torch.int32, "turn_fill.budget", self.dev)
                if req.shape != (R,) or budget.numel() != 1 or g.device != self.dev:
                    raise ValueError("turn_fill: req must be f32[R], budget i32[1], g on the card")
                self.first = False
            build.check(self.fn(self.static_ptr, g.data_ptr(), int(g.dtype == torch.int64),
                                req.data_ptr(), budget.data_ptr(), self.stream), "turn_fill")
            build.launched(turn_fill)
            turn_fill.variants[self.variant] += 1
        return self.placed, self.use_rel


def turn_fill(
    st,
    k: torch.Tensor,               # i32[2, N] idle / releasing capacity, packing order
    nperm: Optional[torch.Tensor],  # i32[N] node at each position, or None
    g: torch.Tensor,               # i32/i64[1]
    req: torch.Tensor,             # f32[R]
    budget: torch.Tensor,          # i32[1]
    group_placed: torch.Tensor,    # i32[G] (read: the group's tasks placed before)
    node_idle: torch.Tensor,       # f32[N, R], updated in place
    node_releasing: torch.Tensor,  # f32[N, R], updated in place
    node_ports: torch.Tensor,      # i32[N, W], updated in place
    node_num_tasks: torch.Tensor,  # i32[N], updated in place
    task_status: torch.Tensor,     # i32[T], updated in place
    task_node: torch.Tensor,       # i32[T], updated in place
    s_max: int,
    best_effort: bool,
    preds_on: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (placed_total i32[1], use_rel bool[1]).  CPU tensors take the
    plain version; CUDA tensors launch the kernel once through a plan of
    its own (its route as :class:`TurnFillPlan` picks it)."""
    if k.device.type == "cpu":
        return turn_fill_plain(st, k, nperm, g, req, budget, group_placed, node_idle,
                               node_releasing, node_ports, node_num_tasks, task_status,
                               task_node, s_max, best_effort, preds_on)
    return TurnFillPlan(st, k, nperm, group_placed, node_idle, node_releasing, node_ports,
                        node_num_tasks, task_status, task_node, s_max, best_effort,
                        preds_on)(g, req, budget)


turn_fill.launches = 0
# launches by route, and the index builds (one per plan not forced to walk)
turn_fill.variants = dict.fromkeys(VARIANTS + ("index",), 0)
