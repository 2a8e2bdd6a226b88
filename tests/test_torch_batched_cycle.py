"""B15, the port's batched launch (``ops/cycle.batched_schedule_cycle``),
and the host-read seam under it (``ops/steps.py``), held against the
port's own sequential cycles and against the JAX package.

Each world's packs come from the reference's host code (or the port's
generator, pod affinity); the port runs them on the CPU (the kernels'
plain versions).  Device units are integers and every total stays under
2^24, so every CycleDecisions field must be equal bit for bit
(tolerance: none): the batch against each tenant's own
``schedule_cycle`` (its plain version), and against the reference's
``schedule_cycle`` on JAX-CPU.  The reference cycles are computed once a
module, one compile per world's shape and actions.

The seam: a single cycle makes exactly the host reads it made before
the seam (``BEFORE``: the reads of the tree before it, counted by the
same tensor-conversion counter at ops/{fairness,allocate,preempt,cycle}.py),
all of them through ops/steps.py; a batch makes as many as its longest
tenant.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import steps

FULL = ("reclaim", "allocate", "backfill", "preempt")
OPT = ("reclaim_optimistic", "allocate", "backfill", "preempt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU cycles are thousands of small torch ops: one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def ref_pack(arrays):
    return ref_snapshot.SnapshotTensors(
        **{k: v for k, v in arrays.items() if k != "rv_window"}, rv_window=arrays["rv_window"])


def _synth(seed, running, tasks=1000, nodes=100, queues=4, per_job=50, fit=1.5):
    return ref_synth(num_tasks=tasks, num_nodes=nodes, num_queues=queues, tasks_per_job=per_job,
                     seed=seed, running_fraction=running, fit_fraction=fit).tensors


def _pa(seed):
    return ref_pack(build_synthetic_arrays(1000, 100, num_queues=4, tasks_per_job=50, seed=seed,
                                           running_fraction=0.3, fit_fraction=1.0,
                                           pod_affinity=True)[0])


# world -> (tenants' reference packs, actions); one shape a world
WORLDS = {
    # three allocate tenants, each running its own number of rounds
    "allocate": (lambda: [_synth(s, 0.0) for s in (0, 1, 2)], ref_ord.DEFAULT_ACTIONS),
    # the evictive class: the canon reclaim walk and the batched preempt
    "evictive": (lambda: [_synth(s, 0.5) for s in (0, 1)], FULL),
    # pod affinity: the immediate path, _reclaim_fast and preempt's turn loop
    "pod_affinity": (lambda: [_pa(9), _pa(53)], FULL),
    # the optimistic reclaim engine (one host read a speculation window)
    "reclaim_optimistic": (lambda: [_synth(s, 0.5, 2000, 200, 8, 20, 1.25) for s in (1, 2)], OPT),
}
# each tenant's host reads in one cycle before the seam (same counter)
BEFORE = {
    "allocate": [31, 25, 29],
    "evictive": [37, 28],
    "pod_affinity": [33, 33],
    "reclaim_optimistic": [95, 96],
}


@functools.lru_cache(maxsize=None)
def world(name):
    """(reference packs, port packs, actions, reference decisions)."""
    make, actions = WORLDS[name]
    refs = make()
    ports = [from_numpy(pack_arrays(st), "cpu") for st in refs]
    want = [ref_cycle.schedule_cycle(st, tiers=ref_ord.DEFAULT_TIERS, actions=actions)
            for st in refs]
    return refs, ports, actions, want


def assert_decisions_equal(want, got, ctx=""):
    for f in dataclasses.fields(got):
        a = np.asarray(getattr(want, f.name))
        b = getattr(got, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx}{f.name}: {a.dtype}{a.shape}"
        assert np.array_equal(a, b), f"{ctx}{f.name} diverged"


class RawReads:
    """Counts tensor -> host conversions by the file of the calling frame
    (ops/kernels' plain versions excluded)."""

    FILES = ("fairness.py", "allocate.py", "preempt.py", "cycle.py", "steps.py")
    METHODS = ("tolist", "item", "__bool__", "__int__", "__index__", "__float__")

    def __init__(self, monkeypatch):
        self.by_file = {}
        for name in self.METHODS:
            monkeypatch.setattr(torch.Tensor, name, self._wrap(getattr(torch.Tensor, name)))

    def _wrap(self, orig):
        def counted(t, *args):
            code = sys._getframe(1).f_code
            base = os.path.basename(code.co_filename)
            if base in self.FILES and "kernels" not in code.co_filename:
                self.by_file[base] = self.by_file.get(base, 0) + 1
            return orig(t, *args)
        return counted


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_batch_equals_sequential_and_reference(name):
    """Every tenant's batched decisions == its own schedule_cycle == the
    reference's, on every CycleDecisions field."""
    _, ports, actions, want = world(name)
    batched = port_cycle.batched_schedule_cycle(ports, actions=actions)
    assert len(batched) == len(ports)
    for i, (p, w, b) in enumerate(zip(ports, want, batched)):
        alone = port_cycle.schedule_cycle(p, actions=actions)
        assert_decisions_equal(w, alone, f"{name} tenant {i} alone: ")
        assert_decisions_equal(w, b, f"{name} tenant {i} batched: ")
    assert sum(int(d.bind_count) for d in batched) > 0
    if actions != ref_ord.DEFAULT_ACTIONS:
        assert sum(int(d.evict_count) for d in batched) > 0, "the evictive world evicted nothing"


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_seam_reads_single_unchanged_batch_longest(name, monkeypatch):
    """A single cycle reads exactly as before the seam, every read through
    ops/steps.py; a batch reads as often as its longest tenant."""
    _, ports, actions, _ = world(name)
    raw = RawReads(monkeypatch)
    single = []
    for p in ports:
        raw.by_file.clear()
        before = steps.host_reads[0]
        port_cycle.schedule_cycle(p, actions=actions)
        single.append(steps.host_reads[0] - before)
        assert raw.by_file == {"steps.py": single[-1]}, raw.by_file
    assert single == BEFORE[name]
    before = steps.host_reads[0]
    port_cycle.batched_schedule_cycle(ports, actions=actions)
    assert steps.host_reads[0] - before == max(single) < sum(single)


def test_batch_with_a_tenant_that_finishes_early():
    """Tenants of different lengths: in the allocate world the second
    tenant's cycle reads least (its allocate runs fewest rounds), so it
    finishes while the others still read; put first in the batch, it and
    the others still decide what each decides alone."""
    _, ports, actions, want = world("allocate")
    counts = []
    for p in ports:
        before = steps.host_reads[0]
        port_cycle.schedule_cycle(p, actions=actions)
        counts.append(steps.host_reads[0] - before)
    assert counts[1] < min(counts[0], counts[2])
    before = steps.host_reads[0]
    mixed = port_cycle.batched_schedule_cycle([ports[1], ports[0], ports[2]], actions=actions)
    assert steps.host_reads[0] - before == max(counts)
    for w, b, ctx in zip((want[1], want[0], want[2]), mixed, ("t1", "t0", "t2")):
        assert_decisions_equal(w, b, f"{ctx}: ")


def test_seam_drive_and_drive_many():
    """drive / drive_many on toy generators: values come back per tensor
    (scalars for 0-d tensors, lists otherwise), floats are refused, and
    drive_many serves each step of all generators with one read."""
    def gen(k):
        total = 0
        for i in range(k):
            a, v = yield from steps.read(torch.tensor(i), torch.tensor([i, i + 1]))
            total += a + sum(v)
        return total

    assert steps.drive(gen(3)) == sum(i + 2 * i + 1 for i in range(3))
    before = steps.host_reads[0]
    assert steps.drive_many([gen(1), gen(4), gen(0)]) == [1, 22, 0]
    assert steps.host_reads[0] - before == 4
    with pytest.raises(TypeError, match="float"):
        steps.drive(steps.read(torch.tensor(1.5)))
    with pytest.raises(TypeError, match="float"):
        steps.drive_many([steps.read(torch.tensor(1.5))])


def test_batch_refuses_packs_on_two_devices():
    _, ports, actions, _ = world("allocate")
    fake = dataclasses.replace(ports[1], task_resreq=ports[1].task_resreq.to("meta"))
    with pytest.raises(ValueError, match="packs on"):
        port_cycle.batched_schedule_cycle([ports[0], fake], actions=actions)
