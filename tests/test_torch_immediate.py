"""The port's immediate decision path held against the JAX package.

* ``allocate_action(turn_batch=False)`` and backfill under first-fit,
  binpack and spread node order, on a synthetic world and on the
  reference's random ``generate_cluster`` worlds, state for state;
* the nodeorder scenarios of tests/test_predicates_nodeorder.py;
* the port's immediate loop equals its batched round under first-fit;
* the binpack key's -0.0 of an idle node ties with the other idle nodes
  and falls to the node index (invalid nodes last);
* ``reclaim_action`` alone on ``_reclaim_fast``: a pack without the
  canon pack (claim-log decode) and a pod-affinity pack (immediate
  decode);
* K9's plain version against the reference's ``_node_capacity`` and its
  packing ``lexsort``; K9 and K10 (K11 / K12 under pod affinity) turn by
  turn against the reference's ``_process_queue``.

Device units are integers and every sum stays under 2^24 (asserted where
the capacities come from a fit fraction), so every field must be equal
(tolerance: none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import TaskStatus
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot, generate_cluster
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import common as ref_common
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy, pa_enabled
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9

GB = 1024**3
POLICIES = ("first_fit", "binpack", "spread")
ALLOC_FIELDS = (
    "task_status", "task_node", "job_alloc", "queue_alloc", "job_ready_cnt", "group_placed",
    "group_unfit", "node_idle", "node_releasing", "node_ports", "node_num_tasks",
)
RECLAIM_FIELDS = (
    "task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed", "job_alloc",
    "queue_alloc", "node_num_tasks", "node_releasing", "node_ports", "evict_claimant",
    "evict_phase", "evict_round",
)


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def ref_pack(arrays):
    """A reference pack from the port generator's arrays."""
    return ref_snapshot.SnapshotTensors(
        **{k: v for k, v in arrays.items() if k != "rv_window"}, rv_window=arrays["rv_window"])


def _ref_tiers(policy):
    """The reference's default tiers with the nodeorder policy (built
    with its own classes, which its jit hashes as static arguments)."""
    tiers = list(ref_ord.DEFAULT_TIERS)
    if policy != "first_fit":
        opt = ref_ord.PluginOption.of("nodeorder", arguments=(("policy", policy),))
        tiers[1] = ref_ord.Tier(plugins=tiers[1].plugins + (opt,))
    return tuple(tiers)


def assert_state_equal(ref, port, fields, ctx=""):
    for f in fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{ctx}{f} diverged"
    assert int(ref.rounds) == port.rounds, f"{ctx}rounds {int(ref.rounds)} vs {port.rounds}"


def _synth_world():
    arrays, _ = build_synthetic_arrays(2000, 200, num_queues=4, tasks_per_job=50, seed=3,
                                       running_fraction=0.3, fit_fraction=1.0)
    cap = arrays["node_alloc"][arrays["node_valid"]]
    assert np.array_equal(cap, np.round(cap)), "node capacities must be integral"
    return ref_pack(arrays)


def _random_world(seed):
    return build_snapshot(generate_cluster(
        num_nodes=16, num_jobs=8, tasks_per_job=10, num_queues=3, seed=seed,
        node_cpu_milli=16000, node_memory=32 * GB, node_gpu_milli=4000, running_fraction=0.3,
    ).cluster).tensors


WORLDS = {"synth": _synth_world, "random0": lambda: _random_world(0),
          "random1": lambda: _random_world(1)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_immediate_allocate_matches_reference(world, policy):
    st = WORLDS[world]()
    ref_tiers, port_tiers = _ref_tiers(policy), port_ord.with_node_order(policy)
    sess, state = ref_cycle.open_session(st, ref_tiers)
    pst = from_numpy(pack_arrays(st), "cpu")
    psess, pstate = port_cycle.open_session(pst, port_tiers)
    for best_effort in (False, True):
        state = ref_alloc.allocate_action(st, sess, state, ref_tiers,
                                          best_effort_pass=best_effort, turn_batch=False)
        pstate = port_alloc.allocate_action(pst, psess, pstate, port_tiers,
                                            best_effort_pass=best_effort, turn_batch=False)
        assert_state_equal(state, pstate, ALLOC_FIELDS, f"{policy} best_effort={best_effort}: ")
    assert (pstate.task_status.numpy() == int(TaskStatus.ALLOCATED)).sum() > 5


def _three_node_cluster():
    """tests/test_predicates_nodeorder.py's world: n0 half full, n1, n2 empty."""
    sim = SimCluster()
    sim.add_queue("q")
    for n in range(3):
        sim.add_node(f"n{n}", cpu_milli=4000, memory=8 * GB)
    filler = sim.add_job("filler", queue="q")
    sim.add_task(filler, 2000, 4 * GB, status=TaskStatus.RUNNING, node="n0")
    j = sim.add_job("j", queue="q")
    sim.add_task(j, 1000, 2 * GB, name="t0")
    return sim


@pytest.mark.parametrize("policy,expect", [("binpack", {0}), ("spread", {1, 2}),
                                           ("first_fit", {0})])
def test_nodeorder_scenarios_match_reference(policy, expect):
    st = build_snapshot(_three_node_cluster().cluster).tensors
    ref = ref_cycle.schedule_cycle(st, tiers=_ref_tiers(policy))
    port = port_cycle.schedule_cycle(from_numpy(pack_arrays(st), "cpu"),
                                     tiers=port_ord.with_node_order(policy))
    for f in dataclasses.fields(port):
        assert np.array_equal(np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy()), f.name
    t0 = int(np.nonzero(port.bind_mask.numpy())[0][0])
    assert int(port.task_node[t0]) in expect


@pytest.mark.parametrize("seed", [0, 1])
def test_immediate_equals_batched_under_first_fit(seed):
    """Under first-fit the deferred decode pairs tasks with nodes exactly
    as the immediate turn loop does."""
    arrays, _ = build_synthetic_arrays(3000, 300, num_queues=4, tasks_per_job=60, seed=seed,
                                       running_fraction=0.2)
    pst = from_numpy(arrays, "cpu")
    tiers = port_ord.DEFAULT_TIERS
    assert port_alloc._use_deferred_decode(pst, tiers)
    sess, state = port_cycle.open_session(pst, tiers)
    out = {}
    for tb in (None, False):
        s = state
        for best_effort in (False, True):
            s = port_alloc.allocate_action(pst, sess, s, tiers, best_effort_pass=best_effort,
                                           turn_batch=tb)
        out[tb] = s
    for f in ALLOC_FIELDS:
        assert torch.equal(getattr(out[None], f), getattr(out[False], f)), f
    assert (out[False].task_status == int(TaskStatus.ALLOCATED)).sum() > 100


def test_binpack_idle_nodes_tie_by_index():
    """An idle node's binpack key is -0.0: the idle nodes tie and fall to
    the node index, behind the fuller node, with invalid (padding) nodes
    last — the reference's lexsort order."""
    sim = SimCluster()
    sim.add_queue("q")
    for n in range(6):
        sim.add_node(f"n{n}", cpu_milli=4000, memory=8 * GB)
    filler = sim.add_job("filler", queue="q")
    sim.add_task(filler, 1000, 2 * GB, status=TaskStatus.RUNNING, node="n3")
    j = sim.add_job("j", queue="q")
    for i in range(13):
        sim.add_task(j, 1000, 2 * GB, name=f"t{i:02d}")
    st = build_snapshot(sim.cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    order = k9.packing_order(pst, pst.node_idle, "binpack")
    used = jnp.maximum(st.node_alloc - st.node_idle, 0.0)
    score = -ref_common.dominant_share(used, st.node_alloc)
    assert float(jnp.min(jnp.abs(score))) == 0.0 and bool(jnp.signbit(score[0]))  # -0.0 keys
    want = np.asarray(jnp.lexsort((jnp.arange(st.num_nodes),
                                   jnp.where(st.node_valid, score, ref_common.BIG))))
    assert np.array_equal(order.numpy(), want)
    assert order[:6].tolist() == [3, 0, 1, 2, 4, 5]
    ref = ref_cycle.schedule_cycle(st, tiers=_ref_tiers("binpack"))
    port = port_cycle.schedule_cycle(pst, tiers=port_ord.with_node_order("binpack"))
    for f in dataclasses.fields(port):
        assert np.array_equal(np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy()), f.name
    nodes = port.task_node.numpy()[port.bind_mask.numpy()]
    assert nodes.tolist() == [3, 3, 3, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2]


@pytest.mark.parametrize("policy", ["binpack", "spread"])
def test_turn_caps_plain_matches_reference(policy):
    """K9's plain version: both capacity rows against the reference's
    ``_node_capacity`` and the packing order against its lexsort, at a
    mid-cycle node state."""
    st = _synth_world()
    pst = from_numpy(pack_arrays(st), "cpu")
    rng = np.random.default_rng(9)
    N = st.num_nodes
    idle = np.asarray(st.node_idle) * (rng.random((N, 1)) < 0.5)  # some nodes drawn down
    idle = np.where(rng.random((N, 1)) < 0.2, np.asarray(st.node_alloc), idle).astype(np.float32)
    rel = (np.asarray(st.node_alloc) * (rng.random((N, 1)) < 0.3)).astype(np.float32)
    for g in range(0, int(np.asarray(st.group_valid).sum()), 3):
        req = np.asarray(st.group_resreq)[g]
        k, nperm = k9.turn_caps(
            pst, torch.from_numpy(idle), torch.from_numpy(rel), pst.node_ports,
            pst.node_num_tasks, torch.tensor([g]), torch.from_numpy(req), None, 4096,
            False, True, policy)
        ok = (np.asarray(st.class_fit)[np.asarray(st.group_klass)[g], np.asarray(st.node_klass)]
              & np.asarray(st.node_valid) & ~np.asarray(st.node_unsched)
              & (np.asarray(st.node_max_tasks) - np.asarray(st.node_num_tasks) > 0))
        pods = jnp.asarray(np.asarray(st.node_max_tasks) - np.asarray(st.node_num_tasks))
        used = jnp.maximum(jnp.asarray(st.node_alloc) - jnp.asarray(idle), 0.0)
        share = ref_common.dominant_share(used, jnp.asarray(st.node_alloc))
        score = -share if policy == "binpack" else share
        perm = np.asarray(jnp.lexsort((jnp.arange(N), jnp.where(st.node_valid, score,
                                                                ref_common.BIG))))
        for row, avail in ((0, idle), (1, rel)):
            want = np.asarray(ref_alloc._node_capacity(
                jnp.asarray(avail), jnp.asarray(req), jnp.asarray(ok), pods, jnp.array(False)))
            assert np.array_equal(k[row].numpy(), want[perm]), f"group {g} row {row}"
        assert np.array_equal(nperm.numpy(), perm)


@pytest.mark.parametrize("policy,pod_affinity", [("binpack", False), ("spread", True),
                                                 ("first_fit", True)])
def test_turns_match_reference_process_queue(policy, pod_affinity):
    """K9 and K10 (with K11 / K12 under pod affinity), plain, through
    single turns: every queue's turn for two rounds of allocate, then of
    backfill, each against the reference's ``_process_queue`` from the
    same state."""
    arrays, _ = build_synthetic_arrays(2000, 200, num_queues=8, tasks_per_job=50, seed=5,
                                       running_fraction=0.3, fit_fraction=1.0,
                                       pod_affinity=pod_affinity)
    st = ref_pack(arrays)
    pst = from_numpy(arrays, "cpu")
    ref_tiers, port_tiers = _ref_tiers(policy), port_ord.with_node_order(policy)
    sess, state = ref_cycle.open_session(st, ref_tiers)
    psess, pstate = port_cycle.open_session(pst, port_tiers)
    turn = jax.jit(ref_alloc._process_queue, static_argnums=(4, 5, 6))
    pa_on = pa_enabled(pst)
    assert pa_on == pod_affinity
    placed = 0
    for best_effort in (False, True):
        for _ in range(2):
            for q in range(st.num_queues):
                state = turn(jnp.int32(q), st, sess, state, ref_tiers, 4096, best_effort)
                port_alloc._process_queue(torch.tensor([q]), pst, psess, pstate, port_tiers, 4096,
                                          best_effort, policy, True, pa_on)
                ctx = f"best_effort={best_effort} queue {q}: "
                assert_state_equal(state, pstate, ALLOC_FIELDS, ctx)
                assert bool(state.progress) == bool(pstate.progress), f"{ctx}progress"
        placed = int((pstate.task_status == int(TaskStatus.ALLOCATED)).sum())
    assert placed > 50


# ---------------------------------------------------------------- _reclaim_fast


_REF_RECLAIM = {}


def _ref_reclaim(st, tiers):
    fns = _REF_RECLAIM.setdefault(tiers, (
        jax.jit(lambda s: ref_cycle.open_session(s, tiers)),
        jax.jit(lambda s, se, a: ref_pre.reclaim_action(s, se, a, tiers)),
    ))
    sess, state = fns[0](st)
    return fns[1](st, sess, state)


def _stripped(arrays):
    out = dict(arrays)
    for k in ("rv_idx", "rv_valid", "rv_nj_start", "rv_nq_start", "rv_block_start"):
        out[k] = out[k][:0]
    out["rv_window"] = 0
    return out


def _evictive_random(seed):
    return pack_arrays(build_snapshot(generate_cluster(
        num_nodes=15, num_jobs=10, tasks_per_job=6, num_queues=4, seed=seed,
        node_cpu_milli=6000, node_memory=12 * GB, running_fraction=0.5,
    ).cluster).tensors)


RECLAIM_PACKS = {
    "claim_log_random2": lambda: _stripped(_evictive_random(2)),
    "claim_log_random3": lambda: _stripped(_evictive_random(3)),
    "claim_log_synth": lambda: _stripped(build_synthetic_arrays(
        2000, 200, num_queues=4, tasks_per_job=50, seed=1, running_fraction=0.5,
        fit_fraction=1.0)[0]),
    "pod_affinity_synth": lambda: build_synthetic_arrays(
        2000, 200, num_queues=8, tasks_per_job=50, seed=4, running_fraction=0.5,
        fit_fraction=1.0, pod_affinity=True)[0],
}


@pytest.mark.parametrize("name", sorted(RECLAIM_PACKS))
def test_reclaim_fast_alone_matches_reference(name):
    arrays = RECLAIM_PACKS[name]()
    st = ref_pack(arrays)
    tiers = port_ord.DEFAULT_TIERS
    ref = _ref_reclaim(st, ref_ord.DEFAULT_TIERS)
    pst = from_numpy(arrays, "cpu")
    assert (pst.rv_idx.numel() == 0) != name.startswith("pod_affinity")
    psess, pstate = port_cycle.open_session(pst, tiers)
    port = port_pre.reclaim_action(pst, psess, pstate, tiers)
    assert_state_equal(ref, port, RECLAIM_FIELDS, f"{name}: ")
    assert (port.evict_phase.numpy() == 3).sum() > 0
    assert torch.equal(pstate.task_status, pst.task_status)  # the caller's state is left alone


def test_claim_log_key_gate():
    """The deferred claim log's (group, rank) key must fit int32: the
    reference's gate, num_groups * (num_tasks + 1) < 2**31."""
    fits = port_pre._claim_key_fits
    assert fits(32, 2**26 - 2) and not fits(32, 2**26 - 1)
    assert fits(1024, 102_400)
