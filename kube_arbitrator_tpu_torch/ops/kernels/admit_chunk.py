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
CUDA source: csrc/admit_chunk.cu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...cache.snapshot import DEVICE_EPSILON, SnapshotTensors
from . import build
from .build import I, P

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG

# C signature of csrc/admit_chunk.cu
SIGNATURES = {
    "kat_admit_chunk": (
        P, P, P, P, P, P, P, P, I, P, I, P, P, P, P, P, P, P, P, P, P,
        P, P, I, I, I, I, I, I, P,
    ),
}


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one chunk's slots; returns (placed_v i32[S], use_rel_v bool[S]).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    args = (
        st, node_idle, node_releasing, node_ports, node_num_tasks, gn_a, gn_p,
        n_slots, g_sel, req_s, budget_s, ports_s, has_ports_s, panel,
        s_max, best_effort, preds_on,
    )
    if node_idle.device.type == "cpu":
        return admit_chunk_plain(*args)
    dev = node_idle.device
    if dev.type != "cuda":
        raise ValueError(f"admit_chunk: tensors on {dev}")
    if gn_p is None and not best_effort:
        raise ValueError("admit_chunk: the allocate pass needs gn_p")
    checks = [
        (node_idle, torch.float32, "node_idle"), (node_releasing, torch.float32, "node_releasing"),
        (node_ports, torch.int32, "node_ports"), (node_num_tasks, torch.int32, "node_num_tasks"),
        (gn_a, torch.int32, "gn_a"), (n_slots, torch.int32, "n_slots"),
        (g_sel, torch.int32, "g_sel"), (req_s, torch.float32, "req_s"),
        (budget_s, torch.int32, "budget_s"), (ports_s, torch.int32, "ports_s"),
        (has_ports_s, torch.bool, "has_ports_s"), (st.group_klass, torch.int32, "group_klass"),
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
    S = g_sel.shape[0]
    if S > 1024 or req_s.shape != (S, R) or ports_s.shape != (S, W) or gn_a.shape[1] != N:
        raise ValueError("admit_chunk: slot/node shapes disagree")
    NC = 0 if panel is None else panel.shape[1]
    # slots past n_slots are not run: they read as placing nothing
    placed_v = torch.zeros(S, dtype=torch.int32, device=dev)
    use_rel_v = torch.zeros(S, dtype=torch.bool, device=dev)
    fn = build.bind("admit_chunk", "kat_admit_chunk", SIGNATURES)
    build.check(fn(
        build.ptr(n_slots), build.ptr(g_sel), build.ptr(req_s), build.ptr(budget_s),
        build.ptr(ports_s), build.ptr(has_ports_s), build.ptr(st.group_klass),
        build.ptr(panel), NC, build.ptr(st.class_fit), st.class_fit.shape[1],
        build.ptr(st.node_klass), build.ptr(st.node_valid), build.ptr(st.node_unsched),
        build.ptr(st.node_max_tasks), build.ptr(node_idle), build.ptr(node_releasing),
        build.ptr(node_ports), build.ptr(node_num_tasks), build.ptr(gn_a), build.ptr(gn_p),
        build.ptr(placed_v), build.ptr(use_rel_v), N, R, W, s_max,
        int(best_effort), int(preds_on), build.stream(),
    ), "admit_chunk")
    admit_chunk.launches += 1
    return placed_v, use_rel_v


admit_chunk.launches = 0
