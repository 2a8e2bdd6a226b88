"""K1 ``admit_chunk``: the node-admission chain of one chunk of selected
queue turns.

Replaces ops/allocate.py:_round_batched.slot_body (:793-951) with
``_node_capacity`` / ``_copies_fit`` (:335-353), the chain the deleted
Pallas kernel ``ops/pallas_admit.py`` fused.  The chunk's slots run in
order; each computes per-node copy capacity (idle, or releasing when
nothing idle-fits), fills ``min(budget, sum k)`` copies in node order,
and writes the node state and row g of the [G, N] count matrices back in
place.  Node positions come from the full node axis, or from the slot's
class row of the pruned panel (entries equal to N are padding).

:class:`AdmitPlan` holds one action's launches: it checks the node state,
the count matrices and the panel once, builds the kernel's fixed
arguments once and reuses its output buffers, so a launch passes only
the chunk's slot rows.  :func:`launch_shape` picks the CTAs (one, or a
cluster of up to 8 over a long node axis) and threads by the positions a
slot scans.  :func:`admit_chunk` is one plan's one launch.
CUDA source: csrc/admit_chunk.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...cache.snapshot import DEVICE_EPSILON, SnapshotTensors
from . import build
from .build import P

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG

# A cluster of MAX_CLUSTER CTAs splits the node axis when one slot scans
# more positions than this.  Measured on one H100 (chip_smoke.py phase 1,
# the allocate world's recorded launch, 8 slots, device time; PERF.md):
# at 1,280 positions one CTA took 39.5 us and clusters of 2-8 CTAs
# 50-54 us; at 2,560 one CTA 58.4 us and a cluster of 8 50.5 us (640
# threads a CTA; 58.9 us with launch_shape's 160); at 10,240 one CTA
# 210.0 us, clusters of 2 / 4 / 8 129.7 / 86.1 / 63.1 us.
ONE_CTA_MAX_POSITIONS = 2048
MAX_CLUSTER = 8  # csrc/admit_chunk.cu's MAX_CLUSTER (the portable cluster size)
# positions a CTA keeps in shared memory (3 int32 each; 192 KB of 227)
CACHE_POSITIONS = 16_384


class _Static(ctypes.Structure):
    """csrc/admit_chunk.cu's Static: the fixed arguments of an action."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "group_klass", "panel", "class_fit", "node_klass", "node_valid", "node_unsched",
        "node_max_tasks", "idle", "rel", "ports", "num_tasks", "gn_a", "gn_p", "placed_v",
        "use_rel_v",
    )] + [(n, ctypes.c_int) for n in (
        "NC", "CN", "N", "R", "W", "s_max", "S", "best_effort", "preds_on", "cluster",
        "threads", "cache_positions",
    )]


# C signature of csrc/admit_chunk.cu
# (static, n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s, stream)
SIGNATURES = {"kat_admit_chunk": (P, P, P, P, P, P, P, P)}
VARIANTS = ("panel", "panel_cluster", "full", "full_cluster")


def launch_shape(positions: int) -> Tuple[int, int]:
    """(CTAs in the cluster, threads per CTA) for a slot that scans
    ``positions`` node positions: one CTA up to ONE_CTA_MAX_POSITIONS,
    else a cluster of MAX_CLUSTER CTAs splitting the axis; threads for
    about two positions a lane (640 for 1,280 positions beat 1,024 on the
    card), 32 to 1024."""
    ctas = 1 if positions <= ONE_CTA_MAX_POSITIONS else MAX_CLUSTER
    per_cta = -(-max(positions, 1) // ctas)
    return ctas, min(1024, 32 * max(1, -(-per_cta // 64)))


def variant_name(panel: bool, ctas: int) -> str:
    return ("panel" if panel else "full") + ("_cluster" if ctas > 1 else "")


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: truncation toward zero, saturating
    at the int32 range, NaN -> 0 (a bare ``.to(int32)`` of an
    out-of-range float is undefined)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=3.0e38, neginf=-3.0e38)
    big = x >= 2147483648.0
    small = x < -2147483648.0
    y = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    y = torch.where(big, 2147483647, y)
    return torch.where(small, -2147483648, y).to(torch.int32)


def copies_fit(avail: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """f32[M]: floor(min over requested dims of (avail + EPS) / req),
    at least 0 — the raw per-node copy count before clamps."""
    per_r = torch.where(req[None, :] > 0, (avail + EPS) / req.clamp(min=1e-30)[None, :], BIG)
    return torch.floor(per_r.amin(dim=-1)).clamp(min=0.0)


def node_capacity(
    avail: torch.Tensor,      # f32[M, R] idle or releasing
    req: torch.Tensor,        # f32[R]
    ok: torch.Tensor,         # bool[M]
    pods_head: torch.Tensor,  # i32[M]
    single_per_node: bool,
) -> torch.Tensor:
    """i32[M]: copies of ``req`` placeable per node."""
    k = torch.minimum(copies_fit(avail, req), pods_head.to(torch.float32))
    if single_per_node:
        k = k.clamp(max=1.0)
    k = torch.where(ok, k, 0.0)
    return to_i32(k.clamp(min=0.0))


def admit_chunk_plain(
    st, node_idle, node_releasing, node_ports, node_num_tasks, gn_a, gn_p,
    n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s, panel,
    s_max, best_effort, preds_on,
):
    """The plain version: the reference's slot body, one slot at a time,
    writing back only the nodes that receive copies (the others would
    subtract an exact zero)."""
    N = st.num_nodes
    S = g_sel.shape[0]
    dev = node_idle.device
    placed_v = torch.zeros(S, dtype=torch.int32, device=dev)
    use_rel_v = torch.zeros(S, dtype=torch.bool, device=dev)
    for i in range(int(n_slots.reshape(-1)[0])):
        g = int(g_sel[i])
        req = req_s[i]
        budget = int(budget_s[i])
        has_ports = preds_on and bool(has_ports_s[i])
        if panel is not None:
            node_idx = panel[int(st.group_klass[g])].to(torch.int64)
            valid_k = node_idx < N
            idxc = node_idx.clamp(max=N - 1)
            num_r = node_num_tasks[idxc]
            if preds_on:
                ports_ok = ((ports_s[i][None, :] & node_ports[idxc]) == 0).all(dim=-1)
                pods_head = st.node_max_tasks[idxc] - num_r
                ok = valid_k & ports_ok & (pods_head > 0)
            else:
                pods_head = torch.full_like(num_r, s_max)
                ok = valid_k
        else:
            node_idx = torch.arange(N, device=dev)
            idxc = node_idx
            if preds_on:
                static_ok = (
                    st.class_fit[int(st.group_klass[g])][st.node_klass.to(torch.int64)]
                    & st.node_valid & ~st.node_unsched
                )
                ports_ok = ((ports_s[i][None, :] & node_ports) == 0).all(dim=-1)
                pods_head = st.node_max_tasks - node_num_tasks
                ok = static_ok & ports_ok & (pods_head > 0)
            else:
                pods_head = torch.full_like(node_num_tasks, s_max)
                ok = st.node_valid
        use_rel = False
        if best_effort:
            k = torch.where(ok, pods_head.clamp(max=1 if has_ports else s_max), 0).to(torch.int32)
        else:
            k = node_capacity(node_idle[idxc], req, ok, pods_head, has_ports)
            use_rel = int(k.sum()) == 0 and budget > 0
            if use_rel:
                k = node_capacity(node_releasing[idxc], req, ok, pods_head, has_ports)
        cum = torch.cumsum(k, 0, dtype=torch.int32)
        placed_total = min(budget, int(cum[-1]))
        p = torch.minimum((placed_total - (cum - k)).clamp(min=0), k)
        hit = torch.nonzero(p > 0).reshape(-1)
        nodes, pp = node_idx[hit], p[hit]
        avail = node_releasing if use_rel else node_idle
        avail[nodes] = avail[nodes] - pp.to(torch.float32)[:, None] * req[None, :]
        node_num_tasks[nodes] = node_num_tasks[nodes] + pp
        if has_ports:
            node_ports[nodes] = node_ports[nodes] | ports_s[i][None, :]
        gn = gn_p if use_rel else gn_a
        gn[g, nodes] = gn[g, nodes] + pp
        placed_v[i] = placed_total
        use_rel_v[i] = use_rel
    return placed_v, use_rel_v


class AdmitPlan:
    """K1's launches over one allocate action.

    Built once per action from the node state it updates in place, the
    [G, N] count matrices (``gn_p`` None on the backfill pass), the
    pruned panel (or None: the full node axis) and the action's flags; it
    checks them once and, for CUDA tensors, builds the kernel's fixed
    arguments and the outputs it reuses: a launch's (placed_v,
    use_rel_v) are overwritten by the next launch, so a caller consumes
    them (in stream order) before it.  ``launch`` forces (CTAs, threads);
    the default is :func:`launch_shape` of the positions a slot scans.
    The plan keeps the stream current when it was built."""

    def __init__(self, st: SnapshotTensors, node_idle, node_releasing, node_ports,
                 node_num_tasks, gn_a, gn_p, panel, s_max: int, best_effort: bool,
                 preds_on: bool, slots: int, launch: Optional[Tuple[int, int]] = None):
        dev = node_idle.device
        self.st, self.dev = st, dev
        self.state = (node_idle, node_releasing, node_ports, node_num_tasks, gn_a, gn_p)
        self.panel, self.s_max = panel, s_max
        self.best_effort, self.preds_on, self.slots = best_effort, preds_on, slots
        self.variant = None
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"admit_chunk: tensors on {dev}")
        if gn_p is None and not best_effort:
            raise ValueError("admit_chunk: the allocate pass needs gn_p")
        checks = [
            (node_idle, torch.float32, "node_idle"),
            (node_releasing, torch.float32, "node_releasing"),
            (node_ports, torch.int32, "node_ports"), (node_num_tasks, torch.int32, "node_num_tasks"),
            (gn_a, torch.int32, "gn_a"), (st.group_klass, torch.int32, "group_klass"),
            (st.class_fit, torch.bool, "class_fit"), (st.node_klass, torch.int32, "node_klass"),
            (st.node_valid, torch.bool, "node_valid"), (st.node_unsched, torch.bool, "node_unsched"),
            (st.node_max_tasks, torch.int32, "node_max_tasks"),
        ]
        if gn_p is not None:
            checks.append((gn_p, torch.int32, "gn_p"))
        if panel is not None:
            checks.append((panel, torch.int32, "panel"))
        for t, dt, name in checks:
            build.require(t, dt, f"admit_chunk.{name}", dev)
        N, R = node_idle.shape
        W = node_ports.shape[1]
        if slots > 1024 or gn_a.shape[1] != N or node_releasing.shape != (N, R):
            raise ValueError("admit_chunk: slot/node shapes disagree")
        positions = N if panel is None else panel.shape[1]
        ctas, threads = launch or launch_shape(positions)
        if not 1 <= ctas <= MAX_CLUSTER or threads % 32 or not 32 <= threads <= 1024:
            raise ValueError(f"admit_chunk: launch {(ctas, threads)}")
        self.variant = variant_name(panel is not None, ctas)
        self.placed_v = torch.zeros(slots, dtype=torch.int32, device=dev)
        self.use_rel_v = torch.zeros(slots, dtype=torch.bool, device=dev)
        # n_slots is read on the device: launch n points at counts[n]
        self.counts = torch.arange(slots + 1, dtype=torch.int32, device=dev)
        ptr = build.ptr
        self.static = _Static(
            ptr(st.group_klass), ptr(panel), ptr(st.class_fit), ptr(st.node_klass),
            ptr(st.node_valid), ptr(st.node_unsched), ptr(st.node_max_tasks), ptr(node_idle),
            ptr(node_releasing), ptr(node_ports), ptr(node_num_tasks), ptr(gn_a), ptr(gn_p),
            ptr(self.placed_v), ptr(self.use_rel_v),
            0 if panel is None else panel.shape[1], st.class_fit.shape[1], N, R, W, s_max,
            slots, int(best_effort), int(preds_on), ctas, threads, CACHE_POSITIONS,
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("admit_chunk", "kat_admit_chunk", SIGNATURES)
        self.stream = build.stream()
        self.slot_shapes = None

    def __call__(self, n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s):
        """Run the first ``n_slots`` slots (a host int, or an i32[1] on
        the plan's device) -> (placed_v i32[S], use_rel_v bool[S])."""
        if self.dev.type == "cpu":
            if not isinstance(n_slots, torch.Tensor):
                n_slots = torch.tensor([n_slots], dtype=torch.int32)
            return admit_chunk_plain(self.st, *self.state, n_slots, g_sel, req_s, budget_s,
                                     ports_s, has_ports_s, self.panel, self.s_max,
                                     self.best_effort, self.preds_on)
        if self.slot_shapes is None:  # the slot rows keep their types all action
            self._check_slots(n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s)
        if isinstance(n_slots, torch.Tensor):
            ns = n_slots.data_ptr()
        else:
            ns = self.counts.data_ptr() + 4 * n_slots
        build.check(self.fn(self.static_ptr, ns, g_sel.data_ptr(), req_s.data_ptr(),
                            budget_s.data_ptr(), ports_s.data_ptr(), has_ports_s.data_ptr(),
                            self.stream), "admit_chunk")
        build.launched(admit_chunk)
        admit_chunk.variants[self.variant] += 1
        return self.placed_v, self.use_rel_v

    def _check_slots(self, n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s):
        S = self.slots
        N, R = self.state[0].shape
        W = self.state[2].shape[1]
        for t, dt, shape, name in (
            (g_sel, torch.int32, (S,), "g_sel"), (req_s, torch.float32, (S, R), "req_s"),
            (budget_s, torch.int32, (S,), "budget_s"), (ports_s, torch.int32, (S, W), "ports_s"),
            (has_ports_s, torch.bool, (S,), "has_ports_s"),
        ):
            build.require(t, dt, f"admit_chunk.{name}", self.dev)
            if t.shape != shape:
                raise ValueError(f"admit_chunk.{name}: shape {tuple(t.shape)}, want {shape}")
        if isinstance(n_slots, torch.Tensor):
            build.require(n_slots, torch.int32, "admit_chunk.n_slots", self.dev)
        elif not 0 <= n_slots <= S:
            raise ValueError(f"admit_chunk: n_slots {n_slots} outside [0, {S}]")
        self.slot_shapes = True


def admit_chunk(
    st: SnapshotTensors,
    node_idle: torch.Tensor,       # f32[N, R], updated in place
    node_releasing: torch.Tensor,  # f32[N, R], updated in place
    node_ports: torch.Tensor,      # i32[N, W], updated in place
    node_num_tasks: torch.Tensor,  # i32[N], updated in place
    gn_a: torch.Tensor,            # i32[G, N], updated in place
    gn_p: Optional[torch.Tensor],  # i32[G, N] (None on the backfill pass)
    n_slots: torch.Tensor,         # i32[1]: slots of this chunk to run
    g_sel: torch.Tensor,           # i32[S] selected group per slot
    req_s: torch.Tensor,           # f32[S, R]
    budget_s: torch.Tensor,        # i32[S]
    ports_s: torch.Tensor,         # i32[S, W]
    has_ports_s: torch.Tensor,     # bool[S]
    panel: Optional[torch.Tensor],  # i32[K, NC] pruned panel, or None
    s_max: int,
    best_effort: bool,
    preds_on: bool,
    launch: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one chunk's slots; returns (placed_v i32[S], use_rel_v bool[S]).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one :class:`AdmitPlan`'s one launch; ``launch`` as there)."""
    plan = AdmitPlan(st, node_idle, node_releasing, node_ports, node_num_tasks, gn_a, gn_p,
                     panel, s_max, best_effort, preds_on, g_sel.shape[0], launch)
    return plan(n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s)


admit_chunk.launches = 0
admit_chunk.variants = dict.fromkeys(VARIANTS, 0)
