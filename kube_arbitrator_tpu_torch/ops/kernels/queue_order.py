"""K17 ``queue_order``: a round's queue order and its active-queue count.

Replaces the reference's queue lexsort (ops/allocate.py:1026-1043;
ops/preempt.py:893-908, :1871, :2246-2259) as ops/allocate.queue_perm
builds it: the key stack f32[K, Q] (the inactive flag first, then
``queue_order_keys`` with BIG on inactive queues) and ``q_active``
bool[Q] -> (perm i64[Q], nq i32[]): perm equals
``jnp.lexsort(tuple(reversed(keys)))`` (key 0 primary, ties by index;
-0.0 equals +0.0, NaN after every number) and nq = sum(q_active), a
device scalar.  Nothing is read back to the host.  CUDA source:
csrc/queue_order.cu (rank by counting).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .build import I, P

MAX_KEYS = 16  # csrc/queue_order.cu's MAX_K

# C signature of csrc/queue_order.cu
SIGNATURES = {"kat_queue_order": (P, I, I, P, P, P, P)}


def queue_order_plain(keys: torch.Tensor, q_active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sorts, least significant key first."""
    perm = torch.arange(keys.shape[1], device=keys.device)
    for k in keys.flip(0):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm, q_active.sum(dtype=torch.int32)


def queue_order(keys: torch.Tensor, q_active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 keys [K, Q], bool q_active [Q] -> (i64[Q], i32[]).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if keys.dtype != torch.float32 or keys.dim() != 2 or not 1 <= keys.shape[0] <= MAX_KEYS:
        raise TypeError(f"queue_order: keys must be f32[K, Q] with 1 <= K <= {MAX_KEYS}")
    if q_active.dtype != torch.bool or q_active.shape != keys.shape[1:]:
        raise ValueError("queue_order: q_active must be bool[Q] with keys' Q")
    if keys.device.type == "cpu":
        return queue_order_plain(keys, q_active)
    if keys.device.type != "cuda" or q_active.device != keys.device:
        raise ValueError(f"queue_order: tensors on {keys.device} / {q_active.device}")
    keys = keys.contiguous()
    q_active = q_active.contiguous()
    K, Q = keys.shape
    perm = torch.empty(Q, dtype=torch.int64, device=keys.device)
    nq = torch.empty((), dtype=torch.int32, device=keys.device)
    fn = build.bind("queue_order", "kat_queue_order", SIGNATURES)
    build.check(fn(build.ptr(keys), K, Q, build.ptr(q_active), build.ptr(perm), build.ptr(nq),
                   build.stream()), "queue_order")
    queue_order.launches += 1
    return perm, nq


queue_order.launches = 0
