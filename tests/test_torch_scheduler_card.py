"""The port's Scheduler on the card against the same Scheduler on the CPU
(the CPU tests against the JAX package are in
tests/test_torch_scheduler.py).  Needs a CUDA card and skips without
one; imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest -m cuda tests/test_torch_scheduler_card.py``.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke as smoke
from kube_arbitrator_tpu_torch.api.types import TaskStatus
from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
from kube_arbitrator_tpu_torch.framework import Scheduler, SchedulerConfig, TorchDecider
from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS


def cycles(device, world, actions, n, churn, burst_after):
    """Phase 10's loop on ``device``: each cycle's record and upload
    mode, the invariants checked after each actuation."""
    set_sticky_buckets(True)
    sim = generate_cluster(**world)
    sched = Scheduler(sim, config=SchedulerConfig(actions=actions, tiers=DEFAULT_TIERS),
                      decider=TorchDecider(device), arena=True)
    out = []
    for c in range(1, n + 1):
        result = sched.run_once()
        smoke.sched_invariants(sim, result, TaskStatus)
        out.append((smoke.cycle_record(result), sched.decider.last_mode))
        smoke.between_cycles(sim, TaskStatus, world, c, churn, burst_after)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
def test_scheduler_card_equals_cpu(which):
    """Phase 10's worlds cut to 2k tasks x 200 nodes: the card decides
    every cycle as the CPU does, cycle 1 uploading in full and the later
    cycles deltas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    if which == "a":
        world, actions, churn, burst = smoke.SCHED_A, ("allocate", "backfill"), smoke.SCHED_CHURN, None
    else:
        world, actions, churn, burst = (smoke.SCHED_B, smoke.EVICT_ACTIONS, 0.0,
                                         smoke.SCHED_B_BURST_AFTER)
    world = dict(world, num_nodes=200, num_jobs=20)
    card = cycles(torch.device("cuda"), world, actions, 3, churn, burst)
    cpu = cycles("cpu", world, actions, 3, churn, burst)
    assert card == cpu
    assert [mode for _, mode in card] == ["full", "delta", "delta"]
