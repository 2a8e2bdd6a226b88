"""B15 and the decision pool on the card, against the same on the CPU
(the CPU tests against the JAX package are tests/test_torch_batched_cycle.py
and tests/test_torch_pool.py).  Needs a CUDA card and skips without one;
imports no JAX, so it runs on the card's machine:
``python -m pytest --noconftest -m cuda tests/test_torch_pool_card.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import warnings

import pytest
import torch

from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy, set_sticky_buckets
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.framework import Scheduler, TorchDecider
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import steps
from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_ACTIONS
from kube_arbitrator_tpu_torch.rpc import DecisionPool, PoolClient

FULL = ("reclaim", "allocate", "backfill", "preempt")
OPT = ("reclaim_optimistic", "allocate", "backfill", "preempt")
# world -> (build_synthetic_arrays arguments, seeds, actions)
WORLDS = {
    "allocate": (dict(tasks=2000, nodes=200, queues=4, tasks_per_job=50, running_fraction=0.0,
                      fit_fraction=1.5), (0, 1, 2), DEFAULT_ACTIONS),
    "evictive": (dict(tasks=2000, nodes=200, queues=4, tasks_per_job=50, running_fraction=0.5,
                      fit_fraction=1.5), (0, 1), FULL),
    "pod_affinity": (dict(tasks=1000, nodes=100, queues=4, tasks_per_job=50, running_fraction=0.3,
                          fit_fraction=1.0, pod_affinity=True), (9, 53), FULL),
    "reclaim_optimistic": (dict(tasks=2000, nodes=200, queues=8, tasks_per_job=20,
                                running_fraction=0.5, fit_fraction=1.25), (1, 2), OPT),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _arrays(name, seed):
    kw, _, _ = WORLDS[name]
    kw = dict(kw)
    return build_synthetic_arrays(kw.pop("tasks"), kw.pop("nodes"), kw.pop("queues"),
                                  kw.pop("tasks_per_job"), seed, **kw)[0]


def _equal(a, b):
    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_batch_on_card_equals_alone_and_cpu(cuda_device, name):
    """Each tenant's batched decisions on the card == its own cycle on the
    card == its cycle on the CPU; the batch reads as its longest tenant,
    and every synchronising CUDA call of the batch is one of those reads."""
    _, seeds, actions = WORLDS[name]
    arrays = [_arrays(name, s) for s in seeds]
    card = [from_numpy(a, cuda_device) for a in arrays]
    reads = []
    for p in card:
        before = steps.host_reads[0]
        port_cycle.schedule_cycle(p, actions=actions)
        reads.append(steps.host_reads[0] - before)
    torch.cuda.synchronize()
    before = steps.host_reads[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            batched = port_cycle.batched_schedule_cycle(card, actions=actions)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    batch_reads = steps.host_reads[0] - before
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    assert batch_reads == max(reads)
    assert len(syncs) == batch_reads, collections.Counter(syncs)
    assert all(f.split(":")[0].endswith("kube_arbitrator_tpu_torch/ops/steps.py") for f in syncs)
    for a, p, b in zip(arrays, card, batched):
        alone = port_cycle.schedule_cycle(p, actions=actions)
        cpu = port_cycle.schedule_cycle(from_numpy(a, "cpu"), actions=actions)
        assert _equal(b, alone) and _equal(b, cpu)


@pytest.mark.cuda
def test_threaded_pool_on_card_matches_independent_runs(cuda_device):
    """2 replicas x 4 tenants on threads on the card: binds equal the
    tenants' independent runs on the card, and a launch stacked 2 or
    more."""
    set_sticky_buckets(True)

    def world(i):
        return generate_cluster(num_nodes=64, num_jobs=8, tasks_per_job=8, num_queues=2,
                                seed=100 + i)

    def bound(sim):
        return {t.uid: t.node_name for j in sim.cluster.jobs.values() for t in j.tasks.values()}

    pool = DecisionPool(replicas=2, threaded=True, min_fill=4, batch_delay_s=0.25,
                        device=cuda_device)
    sims = [world(i) for i in range(4)]
    scheds = [Scheduler(s, decider=PoolClient(pool, f"t{i}"), arena=True)
              for i, s in enumerate(sims)]
    threads = [threading.Thread(target=lambda s=s: s.run(max_cycles=3, until_idle=False))
               for s in scheds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pool.close()
    refs = [world(i) for i in range(4)]
    for r in refs:
        Scheduler(r, decider=TorchDecider(cuda_device), arena=True).run(max_cycles=3,
                                                                        until_idle=False)
    assert [bound(s) for s in sims] == [bound(r) for r in refs]
    assert all(len(s.history) == 3 for s in scheds)
    sizes = [e["batch"] for e in pool.decision_log if e["outcome"] in ("served", "resent")]
    assert max(sizes) >= 2, sizes
