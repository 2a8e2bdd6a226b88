"""The PyTorch port's scheduling cycle held against the JAX package.

The same pack (made by the reference's host code) goes through
``kube_arbitrator_tpu.ops.cycle.schedule_cycle`` on JAX-CPU and through
the port's ``schedule_cycle`` on the CPU (the kernels' plain versions).
Device units are integers here and every total stays under 2^24, so
every sum is exact whatever its order: each CycleDecisions field must be
equal bit for bit (tolerance: none).
"""
import dataclasses

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import TaskStatus
from kube_arbitrator_tpu.api.info import Taint, Toleration
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot, generate_cluster
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord

GB = 1024**3


def pack_arrays(st):
    """The reference pack's fields as numpy arrays."""
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def tiers_pair(spec):
    """(reference tiers, port tiers) from [[(plugin, {flags})...], ...]."""
    def build(mod):
        return tuple(
            mod.Tier(plugins=tuple(mod.PluginOption.of(n, **kw) for n, kw in tier))
            for tier in spec
        )
    return build(ref_ord), build(port_ord)


def assert_decisions_equal(ref, port, ctx=""):
    for f in dataclasses.fields(port):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(port, f.name).numpy()
        assert a.dtype == b.dtype, f"{ctx}{f.name}: dtype {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape, f"{ctx}{f.name}: shape {a.shape} vs {b.shape}"
        diff = np.nonzero(a.reshape(a.shape[0], -1) != b.reshape(b.shape[0], -1))[0] if a.ndim else []
        assert np.array_equal(a, b), f"{ctx}{f.name} diverged at rows {list(diff[:5])}"


def run_both(st, ref_tiers=ref_ord.DEFAULT_TIERS, port_tiers=port_ord.DEFAULT_TIERS):
    ref = ref_cycle.schedule_cycle(st, tiers=ref_tiers)
    port = port_cycle.schedule_cycle(from_numpy(pack_arrays(st), "cpu"), tiers=port_tiers)
    assert_decisions_equal(ref, port)
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_worlds_match_reference(seed):
    # fit_fraction 1.5 over 50-task jobs on 100 nodes keeps every node
    # capacity an integer in device units (exact sums)
    kw = dict(num_tasks=1000, num_nodes=100, num_queues=4, tasks_per_job=50,
              seed=seed, running_fraction=0.2, fit_fraction=1.5)
    st = ref_synth(**kw).tensors
    arrays, _ = build_synthetic_arrays(**kw)
    for name, a in arrays.items():
        assert np.array_equal(np.asarray(getattr(st, name)), a), f"synth field {name}"
    ref, port = run_both(st)
    assert int(port.bind_count) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("queues,running", [(3, 0.2), (8, 0.5)])
def test_random_clusters_match_reference(seed, queues, running):
    """The reference's random property worlds (tests/test_cycle.py):
    gangs, GPU profiles, running tasks, several weighted queues."""
    sim = generate_cluster(
        num_nodes=16, num_jobs=8, tasks_per_job=10, num_queues=queues, seed=seed,
        node_cpu_milli=16000, node_memory=32 * GB, node_gpu_milli=4000,
        running_fraction=running,
    )
    ref, port = run_both(build_snapshot(sim.cluster).tensors)
    assert int(port.bind_count) > 0


def _ports_world():
    sim = SimCluster()
    sim.add_queue("q")
    for n in range(3):
        sim.add_node(f"n{n}", cpu_milli=8000, memory=16 * GB)
    a = sim.add_job("web", queue="q")
    for i in range(5):
        sim.add_task(a, 500, GB, name=f"web{i}", host_ports=(8080,))
    b = sim.add_job("api", queue="q")
    for i in range(4):
        sim.add_task(b, 500, GB, name=f"api{i}", host_ports=(8080, 9090))
    c = sim.add_job("plain", queue="q")
    for i in range(6):
        sim.add_task(c, 1000, GB, name=f"plain{i}")
    return sim


def _class_fit_world():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("gpu0", cpu_milli=8000, memory=16 * GB, gpu_milli=2000,
                 labels={"pool": "gpu"}, taints=(Taint("gpu", "yes"),))
    sim.add_node("gpu1", cpu_milli=8000, memory=16 * GB, gpu_milli=2000,
                 labels={"pool": "gpu"}, taints=(Taint("gpu", "yes"),))
    sim.add_node("gen0", cpu_milli=4000, memory=8 * GB, labels={"pool": "gen"})
    sim.add_node("cordon", cpu_milli=4000, memory=8 * GB, unschedulable=True)
    tol = (Toleration(key="gpu", operator="Equal", value="yes"),)
    j = sim.add_job("train", queue="q")
    for i in range(5):
        sim.add_task(j, 2000, 2 * GB, 1000, name=f"train{i}",
                     node_selector={"pool": "gpu"}, tolerations=tol)
    k = sim.add_job("web", queue="q")
    for i in range(6):
        sim.add_task(k, 1000, GB, name=f"web{i}")
    m = sim.add_job("picky", queue="q")
    sim.add_task(m, 500, GB, name="picky0", node_selector={"pool": "gen"})
    return sim


def _backfill_world():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=1000, memory=GB, max_tasks=4)
    sim.add_node("n2", cpu_milli=1000, memory=GB, max_tasks=3)
    j = sim.add_job("big", queue="q")
    sim.add_task(j, 1000, GB, name="big0")
    sim.add_task(j, 1000, GB, name="big1")
    be = sim.add_job("be", queue="q")
    for i in range(7):
        sim.add_task(be, 0, 0, name=f"be{i}")
    bp = sim.add_job("be-ports", queue="q")
    for i in range(3):
        sim.add_task(bp, 0, 0, name=f"bep{i}", host_ports=(7000,))
    return sim


def _unready_gang_world():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=2000, memory=4 * GB)
    sim.add_node("n2", cpu_milli=1000, memory=4 * GB)
    g = sim.add_job("gang", queue="q", min_available=4, creation_ts=1)
    for i in range(4):
        sim.add_task(g, 1000, GB, name=f"g{i}")
    s = sim.add_job("solo", queue="q", min_available=1, creation_ts=2)
    sim.add_task(s, 500, GB, name="s0")
    return sim


def _overused_world():
    sim = SimCluster()
    sim.add_queue("qa", weight=2)
    sim.add_queue("qb", weight=1)
    sim.add_queue("qc", weight=1)
    for n in range(3):
        sim.add_node(f"n{n}", cpu_milli=8000, memory=16 * GB)
    for q, name in (("qa", "a"), ("qb", "b"), ("qc", "c")):
        for jn in range(2):
            j = sim.add_job(f"{name}{jn}", queue=q, creation_ts=jn)
            for i in range(12):
                sim.add_task(j, 1000, GB * (1 + jn), name=f"{name}{jn}-{i}")
    return sim


def _releasing_world():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=2000, memory=2 * GB)
    sim.add_node("n2", cpu_milli=1000, memory=GB)
    old = sim.add_job("old", queue="q")
    sim.add_task(old, 1000, GB, status=TaskStatus.RELEASING, node="n1", name="dying0")
    sim.add_task(old, 1000, GB, status=TaskStatus.RELEASING, node="n2", name="dying1")
    sim.add_task(old, 1000, GB, status=TaskStatus.RUNNING, node="n1", name="busy")
    j = sim.add_job("new", queue="q", min_available=2)
    for i in range(3):
        sim.add_task(j, 1000, GB, name=f"new{i}")
    return sim


SCENARIOS = {
    "host_ports": _ports_world,
    "class_fit": _class_fit_world,
    "backfill": _backfill_world,
    "unready_alloc": _unready_gang_world,
    "overused_clamp": _overused_world,
    "releasing_fallback": _releasing_world,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_match_reference(name):
    st = build_snapshot(SCENARIOS[name]().cluster).tensors
    ref, port = run_both(st)
    status = port.task_status.numpy()
    if name == "releasing_fallback":
        assert (status == int(TaskStatus.PIPELINED)).any()
    if name == "unready_alloc":
        assert port.unready_alloc.numpy().any()
    if name == "backfill":
        assert port.bind_mask.numpy().sum() == 7  # the two nodes hold 4 + 3 pods


def test_non_default_tiers_match_reference():
    """drf's job order ahead of gang, predicates off."""
    spec = [
        [("drf", {}), ("priority", {})],
        [("gang", {}), ("predicates", {"predicate_disabled": True}), ("proportion", {})],
    ]
    ref_tiers, port_tiers = tiers_pair(spec)
    assert port_alloc._drf_before_gang(port_tiers)
    for make in (_class_fit_world, _overused_world, _unready_gang_world):
        st = build_snapshot(make().cluster).tensors
        run_both(st, ref_tiers, port_tiers)


STATE_FIELDS = (
    "task_status", "task_node", "node_idle", "node_releasing", "node_ports",
    "node_num_tasks", "job_alloc", "queue_alloc", "job_ready_cnt",
    "group_placed", "group_unfit",
)


def _panel_world(pool_a: int, open_tasks: bool):
    """64 nodes; ``pool_a`` of them labelled pool=a and 8 pool=b.  Tasks
    select a pool, so the largest class's feasible set is ``pool_a`` —
    unless ``open_tasks`` adds selector-free tasks (feasible everywhere)."""
    sim = SimCluster()
    sim.add_queue("q1")
    sim.add_queue("q2")
    for n in range(64):
        labels = {"pool": "a"} if n < pool_a else ({"pool": "b"} if n < pool_a + 8 else {})
        sim.add_node(f"n{n:02d}", cpu_milli=4000 + 1000 * (n % 3), memory=8 * GB, max_tasks=6,
                     labels=labels)
    for jn in range(6):
        j = sim.add_job(f"j{jn}", queue=f"q{1 + jn % 2}", min_available=jn % 3, creation_ts=jn)
        pool = "a" if jn % 2 == 0 else "b"
        for i in range(7):
            sim.add_task(j, 1500, 2 * GB, name=f"j{jn}-{i}", node_selector={"pool": pool})
    be = sim.add_job("be", queue="q1")
    for i in range(5):
        sim.add_task(be, 0, 0, name=f"be{i}", node_selector={"pool": "b"})
    if open_tasks:
        o = sim.add_job("open", queue="q2")
        for i in range(9):
            sim.add_task(o, 1000, GB, name=f"open{i}")
    return sim


@pytest.mark.parametrize(
    "pool_a,open_tasks,tier",
    [(8, False, "N//8"), (24, False, "N//4"), (8, True, "full")],
)
def test_pruned_panel_tiers_match_reference(pool_a, open_tasks, tier):
    st = build_snapshot(_panel_world(pool_a, open_tasks).cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    tiers = ref_ord.DEFAULT_TIERS
    ptiers = port_ord.DEFAULT_TIERS
    sess, state = ref_cycle.open_session(st, tiers)
    psess, pstate = port_cycle.open_session(pst, ptiers)
    N = pst.num_nodes
    # the panel tier this world reaches (N is padded to 128; 64 real nodes)
    feas = port_alloc._prune_feasible(pst, pstate, ptiers, False)
    cmax = int(feas.sum(dim=1).max())
    got = "N//8" if cmax <= N // 8 else ("N//4" if cmax <= N // 4 else "full")
    assert got == tier, (cmax, N)
    for best_effort in (False, True):
        state = ref_alloc.allocate_action(
            st, sess, state, tiers, best_effort_pass=best_effort, prune=True, prune_floor=8,
        )
        pstate = port_alloc.allocate_action(
            pst, psess, pstate, ptiers, best_effort_pass=best_effort, prune=True, prune_floor=8,
        )
        for f in STATE_FIELDS:
            a, b = np.asarray(getattr(state, f)), getattr(pstate, f).numpy()
            assert np.array_equal(a, b), f"best_effort={best_effort}: {f} diverged"
        assert int(state.rounds) == pstate.rounds
    assert (pstate.task_status.numpy() == int(TaskStatus.ALLOCATED)).sum() > 10


def test_unported_paths_raise():
    st = build_snapshot(_ports_world().cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        port_cycle.schedule_cycle(pst, actions=("reclaim", "allocate"))
    binpack = (port_ord.Tier(plugins=(port_ord.PluginOption.of(
        "nodeorder", arguments=(("policy", "binpack"),)),)),)
    with pytest.raises(NotImplementedError, match="slice 4"):
        port_cycle.schedule_cycle(pst, tiers=binpack)
    sess, state = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
    with pytest.raises(NotImplementedError):
        port_alloc.allocate_action(pst, sess, state, port_ord.DEFAULT_TIERS, turn_batch=False)
    assert torch.equal(state.node_idle, pst.node_idle)
