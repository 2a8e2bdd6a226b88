"""The port's synthetic world under the priority mix (cache/synth.py
``priority_mix``): with the mix off the arrays are the reference
generator's; with it on the world is well formed, and the evictive cycle
decides it equal to the JAX package in every CycleDecisions field, with
preempt's phase 2 evicting and at least one gated round.

The reference has no priority mix: it gets the port's arrays through
``dataclasses.replace`` of its own SnapshotTensors."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu_torch import cli
from kube_arbitrator_tpu_torch.api.types import TaskStatus
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import PRIORITIES, build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle

FULL = ("reclaim", "allocate", "backfill", "preempt")
# the priority-mix evictive world at the CPU's size: 16 queues, half the
# jobs running, capacity 0.75 of the demand (integral at this seed)
MIX_5K = dict(num_tasks=5000, num_nodes=500, num_queues=16, tasks_per_job=100, seed=44,
              running_fraction=0.5, fit_fraction=0.75)
RUNNING, PENDING = int(TaskStatus.RUNNING), int(TaskStatus.PENDING)


def _ref_pack(arrays, kw):
    """The reference's SnapshotTensors carrying the port's arrays."""
    base = ref_synth(**{k: v for k, v in kw.items() if k != "priority_mix"}).tensors
    return dataclasses.replace(base, **arrays)


@pytest.mark.parametrize("kw", [
    dict(num_tasks=1000, num_nodes=100, num_queues=8, tasks_per_job=50, seed=7),
    dict(num_tasks=5000, num_nodes=500, num_queues=16, tasks_per_job=100, seed=44,
         running_fraction=0.5, fit_fraction=0.75),
    dict(num_tasks=2000, num_nodes=200, num_queues=4, tasks_per_job=37, seed=3,
         running_fraction=0.3, gang_fraction=0.8),
])
def test_mix_off_keeps_the_reference_arrays(kw):
    """``priority_mix=False`` (and the default) build the reference
    generator's arrays, bit for bit and dtype for dtype."""
    ref = ref_synth(**kw).tensors
    for arrays in (build_synthetic_arrays(**kw)[0],
                   build_synthetic_arrays(**kw, priority_mix=False)[0]):
        for name, a in arrays.items():
            a, b = np.asarray(a), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_mix_world_is_well_formed():
    a, _ = build_synthetic_arrays(**MIX_5K, priority_mix=True)
    valid = a["task_valid"]
    lo, hi = PRIORITIES
    for name, mask in (("task_priority", valid), ("group_priority", a["group_valid"]),
                       ("job_priority", a["job_valid"])):
        v = a[name][mask]
        assert v.min() >= lo and v.max() <= hi and len(np.unique(v)) == hi - lo + 1, name
    status, group = a["task_status"], a["task_group"]
    pend = valid & (status == PENDING)
    run = valid & (status == RUNNING)
    # every pending task is in its job's one group, which shares its priority
    assert (group[pend] >= 0).all() and (group[run] == -1).all()
    g = group[pend]
    assert np.array_equal(a["task_priority"][pend], a["group_priority"][g])
    assert np.array_equal(a["group_job"][g], a["task_job"][pend])
    G = int(a["group_valid"].sum())
    assert np.array_equal(np.bincount(g, minlength=G)[:G], a["group_size"][:G])
    for k in range(G):
        members = np.nonzero(pend & (group == k))[0]
        assert np.array_equal(np.sort(a["task_group_rank"][members]), np.arange(len(members)))
        assert a["group_uid_rank"][k] == a["task_uid_rank"][members].min()
    # some jobs run and have a pending tail that outranks a running task
    tail_jobs = np.intersect1d(a["task_job"][run], a["task_job"][pend])
    assert len(tail_jobs) > 0
    outranked = [j for j in tail_jobs
                 if a["task_priority"][run & (a["task_job"] == j)].min()
                 < a["group_priority"][:G][a["group_job"][:G] == j][0]]
    assert outranked
    # node accounting is exact over the running tasks
    N = a["node_valid"].shape[0]
    used = np.zeros((N, a["task_resreq"].shape[1]), np.float64)
    np.add.at(used, a["task_node"][run], a["task_resreq"][run].astype(np.float64))
    assert np.array_equal(a["node_idle"], (a["node_alloc"] - used).astype(np.float32) * a["node_valid"][:, None])
    assert np.array_equal(a["node_num_tasks"], np.bincount(a["task_node"][run], minlength=N))


def test_mix_world_matches_reference_with_phase2_and_gated_rounds():
    """The 5k x 500 priority-mix world under the evictive actions: every
    CycleDecisions field equals the JAX package's; preempt evicts in
    phase 2 and gates at least one round."""
    arrays, _ = build_synthetic_arrays(**MIX_5K, priority_mix=True)
    cap = arrays["node_alloc"][arrays["node_valid"]]
    assert np.array_equal(cap, np.round(cap)), "node capacities must be integral"
    ref = ref_cycle.schedule_cycle(_ref_pack(arrays, MIX_5K), actions=FULL)
    stats = {}
    port = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"), actions=FULL, stats=stats)
    for f in dataclasses.fields(port):
        a, b = np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    phases = np.bincount(port.evict_phase.numpy()[port.evict_mask.numpy()], minlength=4)
    assert phases[1] > 0 and phases[2] > 0 and phases[3] > 0, phases
    assert stats["rounds_gated.preempt"] > 0, stats


def test_cli_priority_mix(capsys):
    """``--priority-mix`` reaches the world through decide_world; it does
    not combine with ``--pod-affinity``."""
    assert cli.main(["--tasks", "2000", "--nodes", "200", "--queues", "16", "--cycles", "1",
                     "--running-fraction", "0.5", "--actions", ",".join(FULL),
                     "--priority-mix", "--device", "cpu", "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"] == "cpu" and row["binds"] > 0 and "rounds_gated.preempt" in row["rounds"]
    with pytest.raises(ValueError, match="pick one"):
        cli.decide_world(1000, 100, device="cpu", pod_affinity=True, priority_mix=True)
    r = cli.decide_world(1000, 100, device="cpu", running_fraction=0.5, priority_mix=True)
    assert torch.equal(r["pack"].task_priority, torch.from_numpy(build_synthetic_arrays(
        1000, 100, 8, 100, 42, running_fraction=0.5, priority_mix=True)[0]["task_priority"]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mix_world_card_equals_cpu(cuda_device):
    """The 5k x 500 priority-mix world decided on the card (K19 sorting
    its victim layouts) equals the CPU in every CycleDecisions field."""
    kw = dict(tasks=MIX_5K["num_tasks"], nodes=MIX_5K["num_nodes"], queues=MIX_5K["num_queues"],
              tasks_per_job=MIX_5K["tasks_per_job"], seed=MIX_5K["seed"],
              running_fraction=MIX_5K["running_fraction"], fit_fraction=MIX_5K["fit_fraction"],
              actions=FULL, priority_mix=True)
    gpu, cpu = cli.decide_world(device=cuda_device, **kw), cli.decide_world(device="cpu", **kw)
    for f in dataclasses.fields(cpu["decisions"]):
        assert torch.equal(getattr(gpu["decisions"], f.name).cpu(), getattr(cpu["decisions"], f.name)), f.name
    assert gpu["rounds"] == cpu["rounds"]
