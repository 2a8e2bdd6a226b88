"""The port's evictive actions (preempt, reclaim) held against the JAX
package.

The same numpy pack goes through the reference (JAX on the CPU, its
default jnp path: ``native_ops=False``) and through the port on the CPU
(the kernels' plain versions).  Resource requests are integers in device
units and every sum stays below 2^24, so every order of float adds gives
the same bits: each compared field must be equal (tolerance: none).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import PodAffinityTerm, TaskStatus
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot, generate_cluster
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.cache.decode import decode_decisions
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre

GB = 1024**3
FULL = ("reclaim", "allocate", "backfill", "preempt")
STATE_FIELDS = (
    "task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed",
    "job_alloc", "queue_alloc", "node_num_tasks", "node_releasing", "node_ports",
    "evict_claimant", "evict_phase", "evict_round",
)


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def tiers_pair(spec):
    """(reference tiers, port tiers) from [[(plugin, {flags})...], ...]."""
    def build(mod):
        return tuple(
            mod.Tier(plugins=tuple(mod.PluginOption.of(n, **kw) for n, kw in tier))
            for tier in spec
        )
    return build(ref_ord), build(port_ord)


DEFAULT_SPEC = [[("priority", {}), ("gang", {})],
                [("drf", {}), ("predicates", {}), ("proportion", {})]]
GANG_PREEMPT_OFF = [[("priority", {}), ("gang", {"preemptable_disabled": True})],
                    DEFAULT_SPEC[1]]
GANG_RECLAIM_OFF = [[("priority", {}), ("gang", {"reclaimable_disabled": True})],
                    DEFAULT_SPEC[1]]


def assert_decisions_equal(ref, port, ctx=""):
    for f in dataclasses.fields(port):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(port, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx}{f.name}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert np.array_equal(a, b), f"{ctx}{f.name} diverged"


def assert_state_equal(ref, port, ctx=""):
    for f in STATE_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert np.array_equal(a, b), f"{ctx}{f} diverged"
    assert int(ref.rounds) == port.rounds, f"{ctx}rounds {int(ref.rounds)} vs {port.rounds}"


def run_both(st, spec=DEFAULT_SPEC, actions=FULL):
    ref_tiers, port_tiers = tiers_pair(spec)
    ref = ref_cycle.schedule_cycle(st, tiers=ref_tiers, actions=actions)
    port = port_cycle.schedule_cycle(from_numpy(pack_arrays(st), "cpu"), tiers=port_tiers,
                                     actions=actions)
    assert_decisions_equal(ref, port)
    return ref, port


# ---------------------------------------------------------------- scenarios
# the worlds of tests/test_preempt.py


def _fill_running(sim, job, node, count, cpu=1000, prio=1):
    for i in range(count):
        sim.add_task(job, cpu, 0, status=TaskStatus.RUNNING, node=node,
                     name=f"{job.uid}-r{i}", priority=prio)


def _one_node_world(a_min=0, b_min=1, b_tasks=8):
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=8000, memory=16 * GB)
    ja = sim.add_job("a", queue="q", min_available=a_min, creation_ts=1)
    _fill_running(sim, ja, "n1", 8)
    jb = sim.add_job("b", queue="q", min_available=b_min, creation_ts=2)
    for i in range(b_tasks):
        sim.add_task(jb, 1000, 0, name=f"b-p{i}")
    return sim


def _intra_job_world():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=2000, memory=4 * GB)
    j = sim.add_job("j", queue="q")
    _fill_running(sim, j, "n1", 2, prio=1)
    sim.add_task(j, 1000, 0, name="hi0", priority=10)
    sim.add_task(j, 1000, 0, name="hi1", priority=10)
    return sim


def _uniform_small_victims_world():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=8000, memory=16 * GB)
    ja = sim.add_job("a", queue="q", creation_ts=1)
    _fill_running(sim, ja, "n1", 4, cpu=2000)
    jb = sim.add_job("b", queue="q", min_available=2, creation_ts=2)
    for i in range(3):
        sim.add_task(jb, 3000, 0, name=f"b-p{i}")
    return sim


def _prop_reclaim_world(big_first):
    sim = SimCluster()
    sim.add_queue("qa", weight=1)
    sim.add_queue("qb", weight=3)
    sim.add_node("n1", cpu_milli=8000, memory=16 * GB)
    sim.add_node("n2", cpu_milli=8000, memory=16 * GB)
    ja = sim.add_job("a", queue="qa", creation_ts=1)
    big_prio, small_prio = (0, 1) if big_first else (1, 0)
    sim.add_task(ja, 6000, 0, status=TaskStatus.RUNNING, node="n1", name="a-big", priority=big_prio)
    sim.add_task(ja, 1000, 0, status=TaskStatus.RUNNING, node="n1", name="a-small",
                 priority=small_prio)
    jb = sim.add_job("b", queue="qb", min_available=1, creation_ts=2)
    for i in range(12):
        sim.add_task(jb, 1000, 0, name=f"b-p{i}")
    return sim


def _preempt_then_reclaim_world():
    sim = SimCluster()
    sim.add_queue("qa")
    sim.add_queue("qb")
    sim.add_node("n0", cpu_milli=2000, memory=8 * GB)
    jv = sim.add_job("victims", queue="qa", min_available=0)
    sim.add_task(jv, 1000, GB, name="v-0", status=TaskStatus.RUNNING, node="n0", priority=0)
    sim.add_task(jv, 1000, GB, name="v-1", status=TaskStatus.RUNNING, node="n0", priority=0)
    jp = sim.add_job("preemptor", queue="qa", min_available=1)
    sim.add_task(jp, 1000, GB, name="p-0", priority=10)
    jc = sim.add_job("claimer", queue="qb", min_available=1)
    sim.add_task(jc, 1000, GB, name="c-0", priority=1)
    return sim


def _two_queue_contention_world(affinity=()):
    sim = SimCluster()
    for name in ("qa", "qb", "qc"):
        sim.add_queue(name, weight=1)
    sim.add_node("n1", cpu_milli=4000, memory=8 * GB)
    ja = sim.add_job("a", queue="qa", creation_ts=1)
    for i in range(4):
        sim.add_task(ja, 1000, GB, status=TaskStatus.RUNNING, node="n1", name=f"a-r{i}", priority=i)
    for name, ts in (("b", 2), ("c", 3)):
        j = sim.add_job(name, queue=f"q{name}", min_available=1, creation_ts=ts)
        sim.add_task(j, 1000, GB, name=f"{name}-p0", labels={"app": "x"} if affinity else None,
                     affinity=affinity)
    return sim


# name -> (world, tiers spec, actions, evictions the reference makes)
SCENARIOS = {
    "gang_decides": (lambda: _one_node_world(), DEFAULT_SPEC, FULL, 8),
    "drf_even_split": (lambda: _one_node_world(), GANG_PREEMPT_OFF, FULL, 4),
    "gang_protects_victims": (lambda: _one_node_world(a_min=6), DEFAULT_SPEC, FULL, 2),
    "statement_discarded": (lambda: _one_node_world(a_min=4, b_min=6, b_tasks=6),
                            DEFAULT_SPEC, FULL, 0),
    "intra_job_phase2": (_intra_job_world, DEFAULT_SPEC, FULL, 2),
    "uniform_small_victims": (_uniform_small_victims_world, DEFAULT_SPEC, FULL, 4),
    "reclaim_prop_big_first": (lambda: _prop_reclaim_world(True), GANG_RECLAIM_OFF,
                               ("reclaim",), 0),
    "reclaim_prop_small_first": (lambda: _prop_reclaim_world(False), GANG_RECLAIM_OFF,
                                 ("reclaim",), 1),
    "preempt_then_reclaim": (_preempt_then_reclaim_world, DEFAULT_SPEC, ("preempt", "reclaim"), 2),
    "two_queues_one_victim_node": (_two_queue_contention_world, DEFAULT_SPEC, ("reclaim",), 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preempt_scenarios_match_reference(name):
    make, spec, actions, n_evicts = SCENARIOS[name]
    ref, port = run_both(build_snapshot(make().cluster).tensors, spec, actions)
    assert int(port.evict_count) == n_evicts
    if name == "intra_job_phase2":
        assert (port.evict_phase.numpy()[port.evict_mask.numpy()] == 2).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_random_evictive_clusters_match_reference(seed):
    """The reference's random reclaim-oracle worlds, full action list."""
    sim = generate_cluster(
        num_nodes=15, num_jobs=10, tasks_per_job=6, num_queues=4, seed=seed,
        node_cpu_milli=6000, node_memory=12 * GB, running_fraction=0.5,
    )
    ref, port = run_both(build_snapshot(sim.cluster).tensors)
    assert int(port.evict_count) > 0


def _actuate(sim, snap, dec):
    """Apply one cycle's decisions; evicted pods terminate before the next."""
    binds, evicts = decode_decisions(snap, dec)
    sim.apply_binds(binds)
    sim.apply_evicts(evicts)
    for e in evicts:
        t = sim.cluster.task_by_uid(e.task_uid)
        sim.cluster.nodes[t.node_name].remove_task(t)
        del sim.cluster.jobs[t.job_uid].tasks[t.uid]
    return binds, evicts


@pytest.mark.parametrize("name,spec,cycles", [
    ("two_cycle_settle", DEFAULT_SPEC, 2),
    ("reclaim_to_deserved", GANG_RECLAIM_OFF, 6),
])
def test_multi_cycle_worlds_match_reference(name, spec, cycles):
    """Cycles actuated one after another (the reference's decisions drive
    the world); every cycle's decisions must be equal."""
    if name == "two_cycle_settle":
        sim = _one_node_world(a_min=4)
    else:
        sim = SimCluster()
        sim.add_queue("qa", weight=1)
        sim.add_queue("qb", weight=1)
        sim.add_node("n1", cpu_milli=8000, memory=16 * GB)
        ja = sim.add_job("a", queue="qa", creation_ts=1)
        _fill_running(sim, ja, "n1", 8)
        jb = sim.add_job("b", queue="qb", min_available=1, creation_ts=2)
        for i in range(8):
            sim.add_task(jb, 1000, 0, name=f"b-p{i}")
    total = 0
    for _ in range(cycles):
        snap = build_snapshot(sim.cluster)
        ref, _port = run_both(snap.tensors, spec)
        _, evicts = _actuate(sim, snap, ref)
        total += len(evicts)
    assert total == 4


# ---------------------------------------------------------------- synthetic


@pytest.fixture
def plain_buckets():
    """The reference's pack buckets without its process-level sticky memo
    (the port has none), restored afterwards."""
    ref_snapshot.set_sticky_buckets(False)
    yield
    ref_snapshot.set_sticky_buckets(True)


@pytest.mark.parametrize("tasks,nodes,queues,seed,fit", [
    (2000, 200, 4, 1, 1.0),
    (5000, 500, 8, 42, 1.25),
])
def test_synthetic_evictive_worlds_match_reference(plain_buckets, tasks, nodes, queues, seed, fit):
    """FULL_ACTIONS on the synthetic generator at a ``fit_fraction`` whose
    node capacities are integral (asserted), so no order of adds can
    differ; the port's own pack equals the reference's field for field,
    the reclaim canon pack included."""
    kw = dict(num_tasks=tasks, num_nodes=nodes, num_queues=queues, tasks_per_job=100, seed=seed,
              running_fraction=0.5, fit_fraction=fit)
    st = ref_synth(**kw).tensors
    arrays, _ = build_synthetic_arrays(**kw)
    ref_arrays = pack_arrays(st)
    for name, a in arrays.items():
        assert np.array_equal(ref_arrays[name], a), f"synth field {name}"
    assert any(k.startswith("rv_") for k in arrays) and arrays["rv_window"] == st.rv_window
    cap = arrays["node_alloc"][arrays["node_valid"]]
    assert np.array_equal(cap, np.round(cap)), "node capacities must be integral"
    ref, port = run_both(st)
    phases = np.bincount(port.evict_phase.numpy()[port.evict_mask.numpy()], minlength=4)
    assert phases[3] > 0
    if tasks == 2000:
        assert phases[1] > 0


def test_scatter_indices_are_unique():
    """The ``.at[].set`` scatters (status, evicted_for, the audit aux) are
    written through the victim panel and the canon pack: their task
    indices must be distinct, so write order cannot matter."""
    st = build_snapshot(generate_cluster(
        num_nodes=15, num_jobs=10, tasks_per_job=6, num_queues=4, seed=0,
        node_cpu_milli=6000, node_memory=12 * GB, running_fraction=0.5,
    ).cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    sess, state = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
    running0 = (state.task_status == int(TaskStatus.RUNNING)) & pst.task_valid
    for P in (pst.num_tasks, int(running0.sum()) + 3):
        view = port_pre._build_view(pst, state, running0, P)
        idx = view.idx[view.valid]
        assert idx.unique().numel() == idx.numel() == int(running0.sum())
    rv = pst.rv_idx[pst.rv_valid]
    assert rv.unique().numel() == rv.numel() > 0


# ---------------------------------------------------------------- reclaim alone


@functools.lru_cache(maxsize=None)
def _ref_reclaim():
    import jax

    tiers = ref_ord.DEFAULT_TIERS
    return (jax.jit(lambda s: ref_cycle.open_session(s, tiers)),
            jax.jit(lambda st, se, s: ref_pre.reclaim_action(st, se, s, tiers)))


@pytest.mark.parametrize("seed", [2, 3])
def test_reclaim_action_alone_matches_reference(seed):
    """``reclaim_action`` on the canon pack, state for state."""
    st = build_snapshot(generate_cluster(
        num_nodes=15, num_jobs=10, tasks_per_job=6, num_queues=4, seed=seed,
        node_cpu_milli=6000, node_memory=12 * GB, running_fraction=0.5,
    ).cluster).tensors
    ref_open, ref_reclaim = _ref_reclaim()
    sess, state = ref_open(st)
    ref = ref_reclaim(st, sess, state)
    pst = from_numpy(pack_arrays(st), "cpu")
    psess, pstate = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
    port = port_pre.reclaim_action(pst, psess, pstate, port_ord.DEFAULT_TIERS)
    assert_state_equal(ref, port, f"reclaim seed={seed}: ")
    assert (port.evict_phase.numpy() == 3).sum() > 0
    assert torch.equal(pstate.task_status, pst.task_status)  # the caller's state is left alone


def test_every_reclaim_engine_decides_equal_to_reference():
    """Every reclaim engine is ported: the opt-in batched and optimistic
    engines and the ``reclaim_optimistic`` action decide equal to the
    reference, an unknown action raises ValueError; a pack without the
    canon pack and a pod-affinity pack take ``_reclaim_fast`` and decide
    equal to the reference."""
    import jax

    sim = _two_queue_contention_world()
    st = build_snapshot(sim.cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    tiers = port_ord.DEFAULT_TIERS
    sess, state = port_cycle.open_session(pst, tiers)
    ref_open, _ = _ref_reclaim()
    for switch in (True, "optimistic"):
        ref = jax.jit(lambda st_, se, s: ref_pre.reclaim_action(
            st_, se, s, ref_ord.DEFAULT_TIERS, turn_batch=switch))(st, *ref_open(st))
        port = port_pre.reclaim_action(pst, sess, state, tiers, turn_batch=switch)
        assert_state_equal(ref, port, f"turn_batch={switch!r}: ")
        assert (port.evict_phase.numpy() == 3).sum() == 2
    run_both(st, actions=("reclaim_optimistic", "allocate"))
    with pytest.raises(ValueError, match="unknown action: reclaim_fastest"):
        port_cycle.schedule_cycle(pst, actions=("reclaim_fastest", "allocate"))
    no_canon = pack_arrays(st)
    for k in ("rv_idx", "rv_valid", "rv_nj_start", "rv_nq_start", "rv_block_start"):
        no_canon[k] = no_canon[k][:0]
    no_canon["rv_window"] = 0
    ref_st = dataclasses.replace(st, **{k: v for k, v in no_canon.items() if k.startswith("rv_")})
    ref_open, ref_reclaim = _ref_reclaim()
    ref = ref_reclaim(ref_st, *ref_open(ref_st))
    port = port_pre.reclaim_action(from_numpy(no_canon, "cpu"), sess, state, tiers)
    assert_state_equal(ref, port, "no canon pack: ")
    assert (port.evict_phase.numpy() == 3).sum() > 0
    # the same world with a pod-affinity term on the claimant
    sim_pa = _two_queue_contention_world(
        affinity=[PodAffinityTerm(match_labels=(("app", "x"),), topology_key="zone", anti=True)])
    st_pa = build_snapshot(sim_pa.cluster).tensors
    assert st_pa.group_anti_terms.shape[1] == 1 and st_pa.rv_idx.shape[0] > 0
    ref = ref_reclaim(st_pa, *ref_open(st_pa))
    pst_pa = from_numpy(pack_arrays(st_pa), "cpu")
    port = port_pre.reclaim_action(pst_pa, *port_cycle.open_session(pst_pa, tiers), tiers)
    assert_state_equal(ref, port, "pod affinity: ")
    assert (port.evict_phase.numpy() == 3).sum() > 0
