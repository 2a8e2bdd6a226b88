"""Fairness kernels: DRF dominant shares, proportion water-filling and
the DRF equilibrium levels (the port of kube_arbitrator_tpu/ops/
fairness.py:28-213).

Every sum here feeds a decision, so each goes through K4 in row order
(``ordered_sum`` / ``segment_sum``): the same order on the CPU and on
the card.
"""
from __future__ import annotations

import torch

from .common import BIG, EPS, dominant_share, fair, is_empty_res, ordered_sum, segment_sum
from .steps import read, stepped


def drf_shares(job_alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """[J] dominant shares from [J, R] allocations and [R] cluster total."""
    return dominant_share(job_alloc, total[None, :])


@stepped
def proportion_deserved(
    queue_weight: torch.Tensor,   # f32[Q]
    queue_request: torch.Tensor,  # f32[Q, R] allocated + pending demand
    total: torch.Tensor,          # f32[R] cluster total minus others' usage
    queue_valid: torch.Tensor,    # bool[Q]
) -> torch.Tensor:
    """Water-filled deserved[Q, R]: at most Q+1 iterations, each capping
    >= 1 queue at its request or consuming the remainder.  The fit-only
    trailing axes get BIG deserved.  The loop condition is read on the
    host through the seam (ops/steps.py): the total weight's sign, then
    whether the remainder is empty, each iteration."""
    R_full = queue_request.shape[1]
    request = fair(queue_request)
    remaining = fair(total).clone()
    Q = queue_weight.shape[0]
    deserved = torch.zeros_like(request)
    met = ~queue_valid
    i = 0
    while True:
        active_w = torch.where(met, 0.0, queue_weight)
        total_w = ordered_sum(active_w)
        if i >= Q + 1:
            break
        (weighted,) = yield from read(total_w > 0)
        if not weighted:
            break
        (empty,) = yield from read(is_empty_res(remaining))
        if empty:
            break
        frac = torch.where(total_w > 0, active_w / total_w.clamp(min=1e-30), 0.0)
        new_deserved = deserved + frac[:, None] * remaining[None, :]
        # a queue meets when deserved no longer epsilon-fits under request
        newly_met = ~met & ~(new_deserved < request + EPS).all(dim=-1)
        capped = torch.minimum(new_deserved, request)
        new_deserved = torch.where(newly_met[:, None], capped, new_deserved)
        granted = ordered_sum(new_deserved - deserved)
        remaining = (remaining - granted).clamp(min=0.0)
        met = met | newly_met
        deserved = new_deserved
        i += 1
    pad = torch.full((Q, R_full - deserved.shape[1]), BIG, device=deserved.device)
    return torch.cat([deserved, pad], dim=1)


def drf_equilibrium_level(
    job_share0: torch.Tensor,    # f32[J]
    job_delta: torch.Tensor,     # f32[J] per-task dominant-share increment
    job_mean_req: torch.Tensor,  # f32[J, R]
    job_pending: torch.Tensor,   # i32[J]
    eligible: torch.Tensor,      # bool[J]
    headroom: torch.Tensor,      # f32[R]
    iters: int = 30,
) -> torch.Tensor:
    """Scalar fair level λ*: the highest common dominant share all
    eligible jobs can be raised to within the cluster headroom (a
    throughput floor for the turn budgets, never a correctness bound).
    Bisection on the device, no host reads."""
    pend = job_pending.to(torch.float32)
    delta = job_delta.clamp(min=1e-9)

    def feasible(lam):
        k = torch.floor((lam - job_share0) / delta)
        k = torch.minimum(k.clamp(min=0.0), pend)
        k = torch.where(eligible, k, 0.0)
        usage = ordered_sum(k[:, None] * job_mean_req)
        return (usage <= headroom + EPS).all()

    dev = job_share0.device
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.ones((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def drf_equilibrium_levels_per_job(
    job_share0: torch.Tensor,     # f32[J]
    job_delta: torch.Tensor,      # f32[J]
    job_mean_req: torch.Tensor,   # f32[J, R]
    job_pending: torch.Tensor,    # i32[J]
    eligible: torch.Tensor,       # bool[J]
    headroom: torch.Tensor,       # f32[R]
    job_queue: torch.Tensor,      # i32[J]
    queue_headroom: torch.Tensor,  # f32[Q, F] deserved - alloc, UNCLAMPED
    iters: int = 30,
) -> torch.Tensor:
    """Per-JOB level: min(global λ*, the job's queue λ*_q), where λ*_q
    bounds each queue's cohort by its own fair-dim headroom.  The
    per-queue usage sum goes through K4."""
    lam_g = drf_equilibrium_level(
        job_share0, job_delta, job_mean_req, job_pending, eligible, headroom, iters
    )
    Q = queue_headroom.shape[0]
    jq = job_queue.to(torch.int64)
    pend = job_pending.to(torch.float32)
    delta = job_delta.clamp(min=1e-9)
    mean_fair = fair(job_mean_req)

    def feasible(lam_q):  # bool[Q]: the queue's overused gate still open
        k = torch.floor((lam_q[jq] - job_share0) / delta)
        k = torch.minimum(k.clamp(min=0.0), pend)
        k = torch.where(eligible, k, 0.0)
        usage = segment_sum(k[:, None] * mean_fair, job_queue, Q)
        return (usage <= queue_headroom - EPS).any(dim=-1)

    dev = job_share0.device
    lo = torch.zeros(Q, dtype=torch.float32, device=dev)
    hi = torch.ones(Q, dtype=torch.float32, device=dev)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.minimum(lam_g, lo[jq])


def queue_shares(queue_alloc: torch.Tensor, deserved: torch.Tensor) -> torch.Tensor:
    """[Q] proportion share = max_r allocated/deserved."""
    return dominant_share(queue_alloc, deserved)


def overused(queue_alloc: torch.Tensor, deserved: torch.Tensor) -> torch.Tensor:
    """[Q] OverusedFn: deserved epsilon-LessEqual allocated over the fair
    resource set."""
    return (fair(deserved) < fair(queue_alloc) + EPS).all(dim=-1)
