"""K9 ``turn_caps``: one immediate-path turn's per-node copy capacity and
node packing order.

Replaces the first half of ops/allocate.py:_process_queue (:585-643) of
the reference, with ``_node_capacity`` / ``_copies_fit`` (:335-353): ok
from the static class fit, host ports, pod headroom and K11's mask; the
idle and releasing capacity rows (backfill: the pod headroom, one copy
for a host-port group); under binpack / spread the packing order, a
stable sort of ±dominant used share with invalid nodes at BIG.  Both
rows come back in packing order.  CUDA source: csrc/turn_caps.cu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from . import build
from .admit_chunk import node_capacity
from .build import I, P

BIG = 3.0e38  # rounds to the reference's float32 BIG
POLICIES = {"first_fit": 0, "binpack": 1, "spread": 2}
MAX_SORT_NODES = 16_384  # one block sorts the padded power of two in shared memory

# C signature of csrc/turn_caps.cu
SIGNATURES = {
    "kat_turn_caps": (P, P, P, P, P, P, P, P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                      P, P, P),
}


def packing_order(st, node_idle: torch.Tensor, policy: str) -> torch.Tensor:
    """i64[N]: the nodeorder policy's packing order — a stable ascending
    sort of -/+ the node's dominant used share, invalid nodes at BIG.
    ``+ 0.0`` turns the idle node's -0.0 into +0.0 (the reference's sort
    compares them equal; a radix sort on float bits would not)."""
    F = NUM_FAIR_RESOURCES
    total = st.node_alloc[:, :F]
    used = (total - node_idle[:, :F]).clamp(min=0.0)
    share = torch.where(total > 0, used / total.clamp(min=1e-30),
                        torch.where(used > 0, 1.0, 0.0)).amax(dim=-1)
    score = -share if policy == "binpack" else share
    key = torch.where(st.node_valid, score, BIG) + 0.0
    return torch.sort(key, stable=True).indices


def turn_caps_plain(st, node_idle, node_releasing, node_ports, node_num_tasks, g, req, pa_ok,
                    s_max, best_effort, preds_on, policy):
    """The plain version: the reference's turn prologue op for op."""
    gi = g.reshape(-1)[:1].to(torch.int64)
    if preds_on:
        klass = st.group_klass[gi].to(torch.int64)
        static_ok = (st.class_fit[klass][:, st.node_klass.to(torch.int64)][0]
                     & st.node_valid & ~st.node_unsched)
        gports = st.group_ports[gi][0]
        ports_ok = ((gports[None, :] & node_ports) == 0).all(dim=-1)
        pods_head = st.node_max_tasks - node_num_tasks
        ok = static_ok & ports_ok & (pods_head > 0)
        hp = (gports != 0).any()
    else:
        pods_head = torch.full_like(node_num_tasks, s_max)
        ok = st.node_valid
        hp = torch.zeros((), dtype=torch.bool, device=node_idle.device)
    if pa_ok is not None:
        ok = ok & pa_ok
    if best_effort:
        k_idle = torch.where(ok, torch.minimum(pods_head, torch.where(hp, 1, s_max)), 0)
        k_rel = torch.zeros_like(k_idle)
    else:
        k_idle = _capacity(node_idle, req, ok, pods_head, hp)
        k_rel = _capacity(node_releasing, req, ok, pods_head, hp)
    k = torch.stack([k_idle, k_rel]).to(torch.int32)
    if policy == "first_fit":
        return k, None
    nperm = packing_order(st, node_idle, policy)
    return k[:, nperm].contiguous(), nperm.to(torch.int32)


def _capacity(avail, req, ok, pods_head, has_ports):
    """node_capacity with a device-side host-port flag."""
    return torch.where(has_ports, node_capacity(avail, req, ok, pods_head, True),
                       node_capacity(avail, req, ok, pods_head, False))


def turn_caps(
    st,
    node_idle: torch.Tensor,       # f32[N, R]
    node_releasing: torch.Tensor,  # f32[N, R]
    node_ports: torch.Tensor,      # i32[N, W]
    node_num_tasks: torch.Tensor,  # i32[N]
    g: torch.Tensor,               # i32/i64[1] the turn's group
    req: torch.Tensor,             # f32[R]
    pa_ok: Optional[torch.Tensor],  # bool[N] K11's mask, or None
    s_max: int,
    best_effort: bool,
    preds_on: bool,
    policy: str,                   # first_fit, binpack or spread
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (k i32[2, N]: the idle and releasing capacity rows in packing
    order, nperm i32[N] or None under first-fit).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if policy not in POLICIES:
        raise ValueError(f"turn_caps: policy {policy!r}")
    args = (st, node_idle, node_releasing, node_ports, node_num_tasks, g, req, pa_ok, s_max,
            best_effort, preds_on, policy)
    if node_idle.device.type == "cpu":
        return turn_caps_plain(*args)
    dev = node_idle.device
    if dev.type != "cuda":
        raise ValueError(f"turn_caps: tensors on {dev}")
    N, R = node_idle.shape
    W = node_ports.shape[1]
    if policy != "first_fit" and N > MAX_SORT_NODES:
        raise ValueError(f"turn_caps: {N} nodes exceed the one-block sort's {MAX_SORT_NODES}")
    g32 = g.reshape(-1)[:1].to(torch.int32).contiguous()
    checks = [
        (node_idle, torch.float32), (node_releasing, torch.float32), (node_ports, torch.int32),
        (node_num_tasks, torch.int32), (req, torch.float32), (st.node_alloc, torch.float32),
        (st.class_fit, torch.bool), (st.node_klass, torch.int32), (st.node_valid, torch.bool),
        (st.node_unsched, torch.bool), (st.node_max_tasks, torch.int32),
        (st.group_klass, torch.int32), (st.group_ports, torch.int32),
    ] + ([(pa_ok, torch.bool)] if pa_ok is not None else [])
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"turn_caps.arg{i}", dev)
    if req.shape != (R,) or node_releasing.shape != (N, R) or st.node_alloc.shape != (N, R):
        raise ValueError("turn_caps: node/request shapes disagree")
    P2 = 1 << max(0, (N - 1).bit_length())
    k = torch.empty((2, N), dtype=torch.int32, device=dev)
    nperm = None if policy == "first_fit" else torch.empty(N, dtype=torch.int32, device=dev)
    fn = build.bind("turn_caps", "kat_turn_caps", SIGNATURES)
    p = build.ptr
    build.check(fn(
        p(g32), p(req), p(node_idle), p(node_releasing), p(st.node_alloc), p(node_ports),
        p(node_num_tasks), p(st.class_fit), st.class_fit.shape[1], p(st.node_klass),
        p(st.node_valid), p(st.node_unsched), p(st.node_max_tasks), p(st.group_klass),
        p(st.group_ports), p(pa_ok), N, R, NUM_FAIR_RESOURCES, W, s_max, int(best_effort),
        int(preds_on), POLICIES[policy], P2, p(k), p(nperm), build.stream(),
    ), "turn_caps")
    turn_caps.launches += 1
    return k, nperm


turn_caps.launches = 0
