"""K9 ``turn_caps``: one immediate-path turn's per-node copy capacity and
node packing order.

Replaces the first half of ops/allocate.py:_process_queue (:585-643) of
the reference, with ``_node_capacity`` / ``_copies_fit`` (:335-353): ok
from the static class fit, host ports, pod headroom and K11's mask; the
idle and releasing capacity rows (backfill: the pod headroom, one copy
for a host-port group); under binpack / spread the packing order, a
stable sort of ±dominant used share with invalid nodes at BIG.  Both
rows come back in packing order.

On the card the order is a stable LSD radix sort of the key's
order-preserving int32 image (:func:`radix_key`; :func:`lsd_sort_plain`
is the function the kernel computes, held against the reference's
lexsort by the tests).  :class:`TurnCapsPlan` binds an action's launches
once; :func:`turn_caps_variant` picks the card's route by policy and N:
``first_fit`` (no order, one pass), ``one_cta`` (N up to
``ONE_CTA_MAX_N``: one launch whose last CTA sorts the keys in shared
memory and writes the rows) or
``tiles`` (any larger N: keys and capacities, K19's tiled sort, the
gather; three launches).  CUDA source: csrc/turn_caps.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from . import build
from .admit_chunk import node_capacity
from .build import I, P
from .stable_sort import workspace_words

BIG = 3.0e38  # rounds to the reference's float32 BIG
POLICIES = {"first_fit": 0, "binpack": 1, "spread": 2}
VARIANTS = ("first_fit", "one_cta", "tiles")  # csrc/turn_caps.cu's V_* values, in order
# the one-CTA sort keeps 16 B a node in shared memory (two ping-pong pairs
# of key and node) beside its 33 KB of digit counts: csrc/turn_caps.cu's
# ONE_CTA_MAX_N
ONE_CTA_MAX_N = 12_288

# C signature of csrc/turn_caps.cu: (static, g, g_wide, req, pa_ok, stream)
SIGNATURES = {"kat_turn_caps": (P, P, I, P, P, P)}


class _Static(ctypes.Structure):
    """csrc/turn_caps.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "idle", "rel", "alloc", "node_ports", "node_num_tasks", "class_fit", "node_klass",
        "node_valid", "node_unsched", "node_max_tasks", "group_klass", "group_ports", "k_out",
        "nperm_out", "kc", "keys", "sort_scratch", "ws", "ticket",
    )] + [(n, ctypes.c_int) for n in (
        "ws_words", "CN", "N", "R", "F", "W", "s_max", "best_effort", "preds_on", "policy",
        "variant",
    )]


def turn_caps_variant(policy: str, n: int) -> str:
    """The card's route for a turn of ``policy`` over ``n`` nodes."""
    if policy not in POLICIES:
        raise ValueError(f"turn_caps: policy {policy!r}")
    if policy == "first_fit":
        return "first_fit"
    return "one_cta" if n <= ONE_CTA_MAX_N else "tiles"


def radix_key(key: torch.Tensor) -> torch.Tensor:
    """i32 image of an f32 key whose signed order is the float order
    (the bits, the 31 low ones flipped for a negative float).  -0.0 maps
    below +0.0: canonicalise first (``key + 0.0``)."""
    bits = key.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def lsd_sort_plain(keys: torch.Tensor) -> torch.Tensor:
    """i64[n]: the stable ascending order of i32 ``keys`` as the kernel
    computes it — four stable 8-bit digit passes of ``key ^ 0x80000000``,
    least significant first, a pass skipped when every key shares its
    digit.  Ties keep index order."""
    u = keys.to(torch.int64) + 2**31  # the unsigned image
    perm = torch.arange(keys.shape[0], device=keys.device)
    for shift in (0, 8, 16, 24):
        d = (u[perm] >> shift) & 0xFF
        if d.numel() == 0 or bool((d == d[0]).all()):
            continue
        perm = perm[torch.sort(d, stable=True).indices]
    return perm


def packing_key_f32(st, node_idle: torch.Tensor, policy: str) -> torch.Tensor:
    """f32[N]: the nodeorder policy's sort key — -/+ the node's dominant
    used share, invalid nodes at BIG.  ``+ 0.0`` turns the idle node's
    -0.0 into +0.0 (the reference's sort compares them equal; a radix
    sort on float bits would not)."""
    from ..common import dominant_share  # ops.common imports this package

    share = dominant_share((st.node_alloc - node_idle).clamp(min=0.0), st.node_alloc)
    score = -share if policy == "binpack" else share
    return torch.where(st.node_valid, score, BIG) + 0.0


def packing_order(st, node_idle: torch.Tensor, policy: str) -> torch.Tensor:
    """i64[N]: the nodeorder policy's packing order, a stable ascending
    sort of :func:`packing_key_f32`."""
    return torch.sort(packing_key_f32(st, node_idle, policy), stable=True).indices


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


class TurnCapsPlan:
    """K9's launches over one immediate action on its node state.

    Built once per action from the node state the turns read (and K10
    updates in place), the action's flags and policy: it checks the
    tensors once, binds the kernel's fixed arguments, keeps the stream
    current when it was built, raises the one-CTA kernel's shared-memory
    limit once per process, and owns the outputs and scratch.  A launch
    passes the group (i32 or i64, read as either on the device), the
    request row and K11's mask: no cast, no allocation.  Its (k, nperm)
    are the plan's own tensors, OVERWRITTEN by the next launch: the turn
    consumes them (K12 shapes ``k`` in place, K10 reads it) in stream
    order before the next turn.
    ``variant`` forces a route of :data:`VARIANTS` (default:
    :func:`turn_caps_variant`).  CPU tensors take the plain version, into
    the same owned outputs."""

    def __init__(self, st, node_idle, node_releasing, node_ports, node_num_tasks, s_max: int,
                 best_effort: bool, preds_on: bool, policy: str, variant: Optional[str] = None):
        if policy not in POLICIES:
            raise ValueError(f"turn_caps: policy {policy!r}")
        dev = node_idle.device
        self.st, self.dev = st, dev
        self.state = (node_idle, node_releasing, node_ports, node_num_tasks)
        self.s_max, self.best_effort, self.preds_on, self.policy = s_max, best_effort, preds_on, policy
        self.first = True
        N, R = node_idle.shape
        self.variant = variant or turn_caps_variant(policy, N)
        if self.variant not in VARIANTS or (self.variant == "first_fit") != (policy == "first_fit"):
            raise ValueError(f"turn_caps: variant {self.variant!r} under {policy}")
        if self.variant == "one_cta" and N > ONE_CTA_MAX_N:
            raise ValueError(f"turn_caps: {N} nodes exceed the one-CTA sort's {ONE_CTA_MAX_N}")
        # device launches a call: the tiled route makes three
        self.per_call = 3 if self.variant == "tiles" else 1
        sort = self.variant != "first_fit"
        self.k = torch.empty((2, N), dtype=torch.int32, device=dev)
        self.nperm = torch.empty(N, dtype=torch.int32, device=dev) if sort else None
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"turn_caps: tensors on {dev}")
        W = node_ports.shape[1]
        checks = [
            (node_idle, torch.float32), (node_releasing, torch.float32), (node_ports, torch.int32),
            (node_num_tasks, torch.int32), (st.node_alloc, torch.float32),
            (st.class_fit, torch.bool), (st.node_klass, torch.int32), (st.node_valid, torch.bool),
            (st.node_unsched, torch.bool), (st.node_max_tasks, torch.int32),
            (st.group_klass, torch.int32), (st.group_ports, torch.int32),
        ]
        for i, (t, dt) in enumerate(checks):
            build.require(t, dt, f"turn_caps.arg{i}", dev)
        if node_releasing.shape != (N, R) or st.node_alloc.shape != (N, R):
            raise ValueError("turn_caps: node shapes disagree")
        self.kc = torch.empty((2, N), dtype=torch.int32, device=dev) if sort else None
        tiles = self.variant == "tiles"
        self.keys = torch.empty(N, dtype=torch.int32, device=dev) if sort else None
        # the one-CTA route's ticket: zero now, and again after every launch
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev) if sort else None
        self.sort_scratch = torch.empty(4 * N, dtype=torch.int32, device=dev) if tiles else None
        ws_words = workspace_words(N, 4, 256) if tiles else 0
        self.ws = torch.empty(ws_words, dtype=torch.int32, device=dev) if tiles else None
        p = build.ptr
        self.static = _Static(
            p(node_idle), p(node_releasing), p(st.node_alloc), p(node_ports), p(node_num_tasks),
            p(st.class_fit), p(st.node_klass), p(st.node_valid), p(st.node_unsched),
            p(st.node_max_tasks), p(st.group_klass), p(st.group_ports), p(self.k),
            p(self.nperm), p(self.kc), p(self.keys), p(self.sort_scratch), p(self.ws),
            p(self.ticket), ws_words, st.class_fit.shape[1], N, R, NUM_FAIR_RESOURCES, W, s_max,
            int(best_effort), int(preds_on), POLICIES[policy], VARIANTS.index(self.variant),
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("turn_caps", "kat_turn_caps", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, g: torch.Tensor, req: torch.Tensor, pa_ok: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (k i32[2, N]: the idle and releasing capacity rows in
        packing order, nperm i32[N] or None under first-fit)."""
        if self.dev.type == "cpu":
            k, nperm = turn_caps_plain(self.st, *self.state, g, req, pa_ok, self.s_max,
                                       self.best_effort, self.preds_on, self.policy)
            self.k.copy_(k)
            if nperm is not None:
                self.nperm.copy_(nperm)
            return self.k, self.nperm
        if g.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"turn_caps: group dtype {g.dtype}")
        if self.first:  # the turn's rows keep their types all action
            R = self.state[0].shape[1]
            build.require(req, torch.float32, "turn_caps.req", self.dev)
            if req.shape != (R,):
                raise ValueError(f"turn_caps.req: shape {tuple(req.shape)}, want ({R},)")
            if pa_ok is not None:
                build.require(pa_ok, torch.bool, "turn_caps.pa_ok", self.dev)
            if g.device != self.dev:
                raise ValueError(f"turn_caps: group on {g.device}")
            self.first = False
        build.check(self.fn(self.static_ptr, g.data_ptr(), int(g.dtype == torch.int64),
                            req.data_ptr(), 0 if pa_ok is None else pa_ok.data_ptr(),
                            self.stream), "turn_caps")
        build.launched(turn_caps, self.per_call)
        turn_caps.variants[self.variant] += 1
        return self.k, self.nperm


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
    variant: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (k i32[2, N]: the idle and releasing capacity rows in packing
    order, nperm i32[N] or None under first-fit), through a plan of its
    own (fresh outputs).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``variant`` as :class:`TurnCapsPlan`)."""
    if policy not in POLICIES:
        raise ValueError(f"turn_caps: policy {policy!r}")
    if node_idle.device.type == "cpu":
        return turn_caps_plain(st, node_idle, node_releasing, node_ports, node_num_tasks, g, req,
                               pa_ok, s_max, best_effort, preds_on, policy)
    plan = TurnCapsPlan(st, node_idle, node_releasing, node_ports, node_num_tasks, s_max,
                        best_effort, preds_on, policy, variant)
    return plan(g, req, pa_ok)


turn_caps.launches = 0
turn_caps.variants = dict.fromkeys(VARIANTS, 0)
