"""K17 ``queue_order``: a round's queue order and its active-queue count,
the keys' build included (B3).

Replaces the reference's queue order (ops/allocate.py:1026-1043; its
twins ops/preempt.py:893-908, :1871, :2246-2259) as ops/allocate.queue_perm
asks for it.  From ``q_active`` bool[Q], ``queue_alloc`` f32[Q, R] and
the session's ``deserved`` f32[Q, R]: each queue's proportion share
(``fairness.queue_shares``: the largest safe share over the NUM_FAIR
columns), the key stack of :func:`queue_keys_plain` (the inactive flag,
``ordering.queue_order_keys`` with BIG on inactive queues) and
(perm i64[Q], nq i32[]): perm equals
``jnp.lexsort(tuple(reversed(keys)))`` (key 0 primary, ties by index;
-0.0 equals +0.0, NaN after every number) and nq = sum(q_active), a
device scalar.  Nothing is read back to the host.

:class:`QueueOrderPlan` binds an action's launches once (one launch a
round, no torch op around it); :func:`queue_order` is the same through a
throwaway plan.  The plain version is the composition queue_perm ran
before the kernel built the keys: :func:`queue_keys_plain`, then
:func:`queue_order_plain`.  CUDA source: csrc/queue_order.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from ..ordering import queue_order_keys, queue_share_key_count
from . import build
from .build import P

BIG = 3.0e38  # rounds to the reference's float32 BIG
MAX_KEYS = 16  # the key stack's height, the inactive flag included
VARIANTS = ("staged", "global")  # csrc/queue_order.cu's V_* values, in order
# the staged route keeps one u64 key a queue in shared memory
STAGED_MAX_Q = 25_600

# C signature of csrc/queue_order.cu: (static, q_active, queue_alloc, stream)
SIGNATURES = {"kat_queue_order": (P, P, P, P)}


class _Static(ctypes.Structure):
    """csrc/queue_order.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("deserved", "uid", "perm", "nq")] + [
        (n, ctypes.c_int) for n in ("Q", "R", "F", "use_share", "variant")]


def queue_order_variant(Q: int) -> str:
    """The card's route for ``Q`` queues."""
    return "staged" if Q <= STAGED_MAX_Q else "global"


def queue_keys_plain(tiers, q_active, queue_alloc, deserved, queue_uid_rank) -> torch.Tensor:
    """f32[K, Q]: the round's key stack as the reference builds it — the
    inactive flag, then the tiered queue keys over the proportion share
    (``fairness.queue_shares``, subnormals flushed as ``common.safe_share``
    flushes them) with BIG on inactive queues."""
    from ..common import dominant_share  # ops.common imports this package

    q_share = dominant_share(queue_alloc, deserved)
    keys = [torch.where(q_active, k, BIG) for k in queue_order_keys(tiers, q_share, queue_uid_rank)]
    keys.insert(0, torch.where(q_active, 0.0, 1.0))
    return torch.stack([k.to(torch.float32) for k in keys])


def queue_order_plain(keys: torch.Tensor, q_active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sorts of the key stack, least significant key first."""
    perm = torch.arange(keys.shape[1], device=keys.device)
    for k in keys.flip(0):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm, q_active.sum(dtype=torch.int32)


class QueueOrderPlan:
    """K17's launches over one action (or one run of rounds on one
    session) for ``tiers`` against the session's ``deserved`` f32[Q, R]
    and the pack's ``queue_uid_rank`` i32[Q].

    Built once where the round loop starts: it checks those tensors and
    the key count once (S proportion share keys from ``tiers``, K = S +
    2 <= MAX_KEYS), binds them, keeps the stream current when it was
    built and owns the outputs.  A launch passes ``q_active`` and
    ``queue_alloc`` (checked at the first launch; their types and shapes
    hold all action): no cast, no stack, no memset, no allocation.  Its
    (perm, nq) are the plan's own tensors, OVERWRITTEN by the next
    launch: the round consumes them (its turns read ``perm``) before the
    next round's launch.  ``variant`` forces a route of
    :data:`VARIANTS` (default: :func:`queue_order_variant`).  CPU
    tensors take the plain version (into the same owned outputs)."""

    def __init__(self, tiers, deserved: torch.Tensor, queue_uid_rank: torch.Tensor,
                 variant: Optional[str] = None):
        S = queue_share_key_count(tiers)
        if S + 2 > MAX_KEYS:
            raise ValueError(f"queue_order: {S + 2} keys, at most {MAX_KEYS}")
        if deserved.dim() != 2 or deserved.shape[1] < NUM_FAIR_RESOURCES:
            raise ValueError(f"queue_order: deserved must be f32[Q, R >= {NUM_FAIR_RESOURCES}]")
        Q, R = deserved.shape
        if queue_uid_rank.shape != (Q,):
            raise ValueError("queue_order: queue_uid_rank must be [Q] with deserved's Q")
        dev = deserved.device
        self.tiers, self.deserved, self.uid = tiers, deserved, queue_uid_rank
        self.dev, self.shape, self.first = dev, (Q, R), True
        self.variant = variant or queue_order_variant(Q)
        if self.variant not in VARIANTS or (self.variant == "staged" and Q > STAGED_MAX_Q):
            raise ValueError(f"queue_order: variant {self.variant!r} at Q = {Q}")
        self.perm = torch.empty(Q, dtype=torch.int64, device=dev)
        self.nq = torch.empty((), dtype=torch.int32, device=dev)
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"queue_order: tensors on {dev}")
        build.require(deserved, torch.float32, "queue_order.deserved", dev)
        build.require(queue_uid_rank, torch.int32, "queue_order.queue_uid_rank", dev)
        p = build.ptr
        self.static = _Static(p(deserved), p(queue_uid_rank), p(self.perm), p(self.nq), Q, R,
                              NUM_FAIR_RESOURCES, int(S > 0), VARIANTS.index(self.variant))
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("queue_order", "kat_queue_order", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, q_active: torch.Tensor, queue_alloc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (perm i64[Q], nq i32[]) of the round whose active queues
        are ``q_active`` bool[Q] at allocations ``queue_alloc`` f32[Q, R]."""
        if self.dev.type == "cpu":
            keys = queue_keys_plain(self.tiers, q_active, queue_alloc, self.deserved, self.uid)
            perm, nq = queue_order_plain(keys, q_active)
            self.perm.copy_(perm)
            self.nq.copy_(nq)
            return self.perm, self.nq
        if self.first:
            build.require(q_active, torch.bool, "queue_order.q_active", self.dev)
            build.require(queue_alloc, torch.float32, "queue_order.queue_alloc", self.dev)
            if q_active.shape != self.shape[:1] or queue_alloc.shape != self.shape:
                raise ValueError(f"queue_order: q_active {tuple(q_active.shape)} / queue_alloc "
                                 f"{tuple(queue_alloc.shape)}, want [Q] / [Q, R] = {self.shape}")
            self.first = False
        build.check(self.fn(self.static_ptr, q_active.data_ptr(), queue_alloc.data_ptr(),
                            self.stream), "queue_order")
        build.launched(queue_order)
        return self.perm, self.nq


def queue_order(tiers, q_active: torch.Tensor, queue_alloc: torch.Tensor, deserved: torch.Tensor,
                queue_uid_rank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm i64[Q], nq i32[]) of one round, through a plan of its own
    (fresh outputs).  CPU tensors take the plain version; CUDA tensors
    launch the kernel once."""
    return QueueOrderPlan(tiers, deserved, queue_uid_rank)(q_active, queue_alloc)


queue_order.launches = 0
