"""The port's own scheduler loop held against the JAX package's, on the
CPU: ``kube_arbitrator_tpu_torch.framework.Scheduler`` over the port's
``SimCluster`` with ``TorchDecider("cpu")`` against the reference's
``Scheduler`` over its ``SimCluster`` with its ``LocalDecider`` (handed
the host pack, as the port's decider is), with and
without the arena, for 6 cycles with a kubelet step between them
(chip_smoke.py's ``kubelet_step``).  Every cycle must bind and evict
alike and leave equal PodGroup statuses, pod conditions, events and
cluster state; with the arena, equal packs, PackMeta epochs and changed
fields, and ``verify()`` passes on every delta pack (``verify_every=1``).
Packs and decisions are integers or integral device units below 2^24,
so every comparison is exact.

Also: the command line's ``--sim-*`` mode in a subprocess where ``jax``
and ``kube_arbitrator_tpu`` cannot be imported, the default decider
(the card; without CUDA it raises), the loop's error classification,
chip_smoke.py's phase-10 recipe at 5k tasks x 500 nodes (tier 1) and at
full width (slow: it prints the constants phase 10 holds).  The card
twin of the loop is tests/test_torch_scheduler_card.py (no JAX there).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import kube_arbitrator_tpu.cache.arena as ref_arena
import kube_arbitrator_tpu.framework as ref_framework
import kube_arbitrator_tpu.framework.decider as ref_decider
import kube_arbitrator_tpu.ops.ordering as ref_ordering
import kube_arbitrator_tpu_torch.cache.arena as port_arena
import kube_arbitrator_tpu_torch.framework as port_framework
import kube_arbitrator_tpu_torch.ops.ordering as port_ordering
from kube_arbitrator_tpu_torch.framework import TorchDecider
from kube_arbitrator_tpu_torch.framework import session as port_session
from kube_arbitrator_tpu_torch.framework.decider import host_fields
from test_torch_host_pack import GB, PORT, REF, assert_packs_equal, cluster_state

REPO = Path(__file__).resolve().parent.parent
CPU = 1000
FULL = ("reclaim", "allocate", "backfill", "preempt")
REF.framework, REF.arena_mod, REF.tiers = ref_framework, ref_arena, ref_ordering.DEFAULT_TIERS
PORT.framework, PORT.arena_mod, PORT.tiers = port_framework, port_arena, port_ordering.DEFAULT_TIERS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU cycles are thousands of small torch ops, which run
    fastest on one thread and slow down many times over when xdist
    workers each spread them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_buckets():
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)
    yield
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)


class HostPackLocalDecider(ref_decider.LocalDecider):
    """The reference's LocalDecider handed the host pack, as the port's
    TorchDecider is (the reference session then skips its own device
    placement): the arena and rebuild cycles give its jitted cycle the
    same kind of input and share one compile."""

    wants_device_pack = False


def scheduler(m, sim, actions, arena, decider=None):
    """A scheduler of package ``m`` over ``sim`` (the port's with
    ``decider``, the reference's with a LocalDecider)."""
    conf = m.framework.SchedulerConfig(actions=tuple(actions), tiers=m.tiers)
    kw = dict(decider=HostPackLocalDecider() if m is REF else decider or TorchDecider("cpu"))
    a = m.arena_mod.SnapshotArena(sim, verify_every=1) if arena else None
    return m.framework.Scheduler(sim, config=conf, arena=a, **kw)


# ---------------------------------------------------------------- worlds
# test_torch_serving.py's four worlds and a generated one, on either package


def _three_nodes(sim):
    for i in range(3):
        sim.add_node(f"node-{i}", cpu_milli=4 * CPU, memory=32 * GB)


def _job(sim, name, queue, rep, minm, mem=GB):
    j = sim.add_job(name, queue=queue, min_available=minm, creation_ts=float(len(sim.cluster.jobs)))
    for i in range(rep):
        sim.add_task(j, CPU, mem, name=f"{name}-{i}", priority=1)
    return j


def world_arena(m):
    return m.generate_cluster(num_nodes=16, num_jobs=6, tasks_per_job=8, num_queues=2, seed=21,
                              running_fraction=0.3), None


def world_gang_release(m):
    """A filler over half the cluster keeps a gang pending until the
    filler goes (after cycle 2)."""
    sim = m.SimCluster()
    sim.add_queue("default")
    _three_nodes(sim)
    filler = sim.add_job("filler", queue="default", min_available=0, creation_ts=0)
    for i in range(7):
        sim.add_task(filler, CPU, 0, status=m.TaskStatus.RUNNING, node=f"node-{i % 3}",
                     name=f"f{i}")
    _job(sim, "gang-qj", "default", rep=7, minm=7)

    def event(cycle):
        if cycle == 2:
            for t in list(filler.tasks.values()):
                node = sim.cluster.nodes.get(t.node_name)
                if node is not None and t.uid in node.tasks:
                    node.remove_task(t)
                t.status = m.TaskStatus.SUCCEEDED
            sim.delete_job(filler.uid)
            sim.collect_garbage(now=1e18)
    return sim, event


def world_preemption(m):
    sim = m.SimCluster()
    sim.add_queue("default")
    _three_nodes(sim)
    j1 = sim.add_job("preemptee-qj", queue="default", min_available=1, creation_ts=0)
    for i in range(12):
        sim.add_task(j1, CPU, 0, status=m.TaskStatus.RUNNING, node=f"node-{i % 3}",
                     name=f"p{i}", priority=1)
    _job(sim, "preemptor-qj", "default", rep=12, minm=1, mem=0)
    return sim, None


def world_reclaim(m):
    sim = m.SimCluster()
    sim.add_queue("q1", weight=1)
    sim.add_queue("q2", weight=1)
    _three_nodes(sim)
    j1 = sim.add_job("q1-qj-1", queue="q1", min_available=1, creation_ts=0)
    for i in range(12):
        sim.add_task(j1, CPU, 0, status=m.TaskStatus.RUNNING, node=f"node-{i % 3}",
                     name=f"r{i}", priority=1)
    _job(sim, "q2-qj-2", "q2", rep=12, minm=1, mem=0)
    return sim, None


def world_generated(m):
    """Gangs, GPUs, 4 queues, 40% running, oversubscribed; 24 tasks, so it
    pads to the preemption world's shapes and shares its compile."""
    return m.generate_cluster(num_nodes=4, num_jobs=6, tasks_per_job=4, num_queues=4, seed=7,
                              node_cpu_milli=8000, node_memory=32 * GB,
                              running_fraction=0.4), None


WORLDS = [world_arena, world_gang_release, world_preemption, world_reclaim, world_generated]


def statuses(job_status):
    return {uid: (int(s.phase), s.running, s.succeeded, s.failed,
                  [(c.type, c.status, c.reason, c.message) for c in s.conditions])
            for uid, s in job_status.items()}


def epoch(key):
    return None if key is None else key.split(":")[1]


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "rebuild"])
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: w.__name__[6:])
def test_scheduler_matches_reference(world, arena):
    (ref_sim, ref_ev), (port_sim, port_ev) = world(REF), world(PORT)
    ref_s, port_s = scheduler(REF, ref_sim, FULL, arena), scheduler(PORT, port_sim, FULL, arena)
    binds = evicts = 0
    modes = []
    for cyc in range(1, 7):
        rr, rp = ref_s.run_once(), port_s.run_once()
        ctx = f"cycle {cyc}: "
        assert [(b.task_uid, b.node_name) for b in rp.binds] == [
            (b.task_uid, b.node_name) for b in rr.binds], ctx
        assert [e.task_uid for e in rp.evicts] == [e.task_uid for e in rr.evicts], ctx
        assert statuses(rp.job_status) == statuses(rr.job_status), ctx
        assert rp.task_conditions == rr.task_conditions, ctx
        assert rp.failed_actuations == rr.failed_actuations, ctx
        sr, sp = ref_s.history[-1], port_s.history[-1]
        assert (sp.binds, sp.evicts, sp.pending_before) == (sr.binds, sr.evicts, sr.pending_before)
        assert_packs_equal(rr.snapshot, rp.snapshot, ctx)
        assert cluster_state(port_sim) == cluster_state(ref_sim), ctx
        assert port_s.job_status.keys() == ref_s.job_status.keys()
        if arena:
            mr, mp = ref_s.arena.pack_meta, port_s.arena.pack_meta
            assert (epoch(mp.key), epoch(mp.base_key), mp.changed_fields, mp.decode_caps) == (
                epoch(mr.key), epoch(mr.base_key), mr.changed_fields, mr.decode_caps), ctx
            assert port_s.arena.last_rebuild_reason == ref_s.arena.last_rebuild_reason, ctx
        modes.append(port_s.decider.last_mode)
        assert port_s.decider.resident.first_difference(host_fields(rp.snapshot.tensors)) is None
        binds, evicts = binds + len(rp.binds), evicts + len(rp.evicts)
        for m, sim, ev in ((REF, ref_sim, ref_ev), (PORT, port_sim, port_ev)):
            smoke.kubelet_step(sim, m.TaskStatus, cyc, 0.04)
            if ev is not None:
                ev(cyc)
    if arena:
        port_s.arena.verify()
        assert modes[0] == "full" and "delta" in modes
    else:
        assert set(modes) == {"full"}
    assert binds > 0
    if world in (world_preemption, world_reclaim, world_generated):
        assert evicts > 0


def test_session_default_decider_is_the_card(monkeypatch):
    """Scheduler() and Session() decide on the card: without CUDA they
    raise, unless given TorchDecider("cpu")."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_session, "_default_decider", None)
    sim = world_reclaim(PORT)[0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_framework.Scheduler(sim)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_framework.Session(sim.cluster).run()
    r = port_framework.Session(sim.cluster, decider=TorchDecider("cpu")).run()
    assert len(r.binds) == 0 and len(r.evicts) == 0  # the default conf evicts nothing here
    for name in ("audit", "capture", "trace_recorder"):
        with pytest.raises(TypeError):
            port_framework.Scheduler(sim, decider=TorchDecider("cpu"), **{name: None})
    for name in ("flight", "timeseries", "profile_dir", "cycle_slo_ms", "conf_path"):
        port_framework.Scheduler(sim, decider=TorchDecider("cpu"), **{name: None})


def test_decision_contract_and_decode_paths(monkeypatch):
    """The session holds the decider's decisions to the reference's
    decision schema, and decodes the dense masks when the compact lists
    overflow (KAT_DECODE_PARITY cross-checks the compact path)."""
    from kube_arbitrator_tpu.analysis.contracts import DECISIONS_SCHEMA

    assert set(port_session.DECISIONS_SCHEMA) == set(DECISIONS_SCHEMA)
    for name, (shape, dtype) in DECISIONS_SCHEMA.items():
        got, ndim = port_session.DECISIONS_SCHEMA[name]
        assert np.dtype(got) == np.dtype(dtype) and ndim == len(shape), name
    monkeypatch.setenv("KAT_DECODE_PARITY", "1")
    sim = world_generated(PORT)[0]
    ses = port_framework.Session(sim.cluster, decider=TorchDecider("cpu"))
    snap = ses.snapshot_phase()
    dec, _, _, _ = ses.decide_phase(snap, *ses.upload_phase(snap))
    binds, _ = ses.decode_phase(snap, dec)
    assert ses.last_decode_path == "compact" and len(binds) > 0
    small = dataclasses.replace(dec, bind_idx=dec.bind_idx[:1], bind_node=dec.bind_node[:1])
    dense, _ = ses.decode_phase(snap, small)
    assert ses.last_decode_path == "overflowed" and dense == binds
    with pytest.raises(TypeError, match="contract"):
        port_session._assert_decision_dtypes(
            dataclasses.replace(dec, task_node=dec.task_node.astype(np.int64)))


def test_run_classifies_cycle_errors():
    """run() retries retryable cycle errors up to max_cycle_retries in a
    row and re-raises fatal ones."""
    sim = world_preemption(PORT)[0]
    s = port_framework.Scheduler(sim, decider=TorchDecider("cpu"), max_cycle_retries=2)
    calls = []

    def flaky():
        calls.append(1)
        raise TimeoutError("apiserver")

    s.run_once = flaky
    with pytest.raises(TimeoutError):
        s.run(max_cycles=10)
    assert len(calls) == 3
    assert port_framework.classify_cycle_error(port_arena.ArenaDivergence("x")) == "fatal"
    assert port_framework.classify_cycle_error(ConnectionError()) == "retryable"
    assert port_framework.classify_cycle_error(TypeError("decision contract violation")) == "fatal"
    assert port_framework.classify_cycle_error(ValueError()) == "fatal"


def test_cli_sim_mode_imports_neither_jax_nor_the_reference():
    """``python -m kube_arbitrator_tpu_torch --sim-*`` on the CPU, in a
    process where ``jax`` and ``kube_arbitrator_tpu`` cannot be imported:
    the whole loop runs and binds."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kube_arbitrator_tpu'] = None\n"
        "from kube_arbitrator_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None and "
        "(k == 'jax' or k.startswith(('jax.', 'kube_arbitrator_tpu.'))))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, "--sim-nodes", "30", "--sim-jobs", "8",
         "--sim-tasks-per-job", "10", "--sim-queues", "2", "--cycles", "3", "--device", "cpu",
         "--json", "--arena"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert [r["upload_mode"] for r in lines[:-1]][:2] == ["full", "delta"]
    assert lines[-1]["binds"] > 0 and lines[-1]["cycles"] == len(lines) - 1 >= 2


# ---------------------------------------------------------------- phase 10's recipe


def phase10_cycles(m, world, actions, cycles, churn, burst_after=None, decider=None):
    """chip_smoke.py phase 10's loop on package ``m``: each cycle's record
    (binds, evicts by phase, digest, seconds), with the invariants
    checked after each actuation."""
    sim = m.generate_cluster(**world)
    sched = scheduler(m, sim, actions, arena=True, decider=decider)
    out = []
    for c in range(1, cycles + 1):
        t0 = time.perf_counter()
        result = sched.run_once()
        out.append(dict(smoke.cycle_record(result), s=round(time.perf_counter() - t0, 1)))
        smoke.sched_invariants(sim, result, m.TaskStatus)
        if c < cycles:
            smoke.between_cycles(sim, m.TaskStatus, world, c, churn, burst_after)
    if m is PORT:
        assert sched.decider.last_mode == ("delta" if cycles > 1 else "full")
    return out


def _strip(rec):
    return {k: v for k, v in rec.items() if k != "s"}


def phase10_world(which, **cut):
    """(world, actions, cycles, churn, burst_after) of phase 10's world
    ``which``."""
    if which == "a":
        return (dict(smoke.SCHED_A, **cut), ("allocate", "backfill"), smoke.SCHED_A_CYCLES,
                smoke.SCHED_CHURN, None)
    return dict(smoke.SCHED_B, **cut), FULL, smoke.SCHED_B_CYCLES, 0.0, smoke.SCHED_B_BURST_AFTER


@pytest.mark.parametrize("which", ["a", "b"])
def test_phase10_recipe_at_5k(which):
    """Phase 10's two worlds cut to 5k tasks x 500 nodes: the port's
    Scheduler on the CPU decides cycle 1 as the reference's does (the
    record chip_smoke.py holds at full width), its later cycles upload
    deltas, and the invariants hold after every actuation; in world (b)
    preempt claims after the priority burst."""
    world, actions, cycles, churn, burst_after = phase10_world(which, num_nodes=500, num_jobs=50)
    ref = phase10_cycles(REF, world, actions, 1, churn)
    port = phase10_cycles(PORT, world, actions, cycles, churn, burst_after)
    assert _strip(port[0]) == _strip(ref[0])
    assert all(r["binds"] > 0 for r in port)
    if which == "b":
        assert port[0]["evicts"] > 0
        assert port[burst_after]["evicts_by_phase"][1] > 0


@pytest.mark.slow
@pytest.mark.parametrize("which", ["a", "b"])
def test_phase10_constants_from_reference(which):
    """Cycle 1 of phase 10's worlds at full width as the JAX package's
    Scheduler decides it: prints the record chip_smoke.py holds as
    SCHED_A_42 / SCHED_B_42, and the port's CPU run must equal it."""
    world, actions, _, churn, _ = phase10_world(which)
    ref = phase10_cycles(REF, world, actions, 1, churn)[0]
    port = phase10_cycles(PORT, world, actions, 1, churn)[0]
    print(f"\nworld ({which}) cycle 1: reference {ref}, port {port}")
    assert _strip(port) == _strip(ref)
    assert _strip(ref) == (smoke.SCHED_A_42 if which == "a" else smoke.SCHED_B_42)
