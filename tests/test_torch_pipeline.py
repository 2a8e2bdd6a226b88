"""The port's pipelined cycle plane (``kube_arbitrator_tpu_torch.pipeline``
and ``Scheduler.run_pipelined``) held against the JAX package's, on the
CPU, in the small worlds of the reference's tests/test_pipeline.py
(``generate_cluster`` <= 12 nodes x 8 jobs x 5 tasks).

* The revalidation gate: every ``DISCARD_REASONS`` entry the gate emits,
  through both packages' ``revalidate_decisions`` (and the port's
  columnar ``revalidate_batch``) on the same scripted journal, gives
  equal kept decisions and discards (the reference's :111-210).
* The journal tee records while the arena is structural (:422).
* The executor: a quiescent pipelined run decides as the sequential one,
  cycle for cycle (:65); ``run_pipelined(max_cycles=6)`` gives ``run``'s
  totals (:87); a deterministic pipelined run with mid-window churn
  (a pod deleted, a node cordoned, a node's capacity shrunk, through
  ``ingest_fn``) gives the reference's ``run_pipelined(deterministic=True)``
  binds, evicts and discards step for step; the decide runs on the
  worker, which is the only thread allowed to launch; backpressure fires;
  a failed freeze after a commit keeps the committed epoch's bookkeeping
  (:489).

Decisions are integers, so every comparison is exact (tolerance: none).
The chaos-profile cases of the reference's file (:445, :460) wait for
the port's chaos plane.
"""
import threading
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

import kube_arbitrator_tpu.cache.sim as ref_sim
import kube_arbitrator_tpu.framework as ref_framework
import kube_arbitrator_tpu.pipeline as ref_pipeline
import kube_arbitrator_tpu_torch.cache.sim as port_sim
import kube_arbitrator_tpu_torch.framework as port_framework
import kube_arbitrator_tpu_torch.pipeline as port_pipeline
from kube_arbitrator_tpu.api.types import TaskStatus as RefStatus
from kube_arbitrator_tpu.framework.conf import load_conf as ref_load_conf
from kube_arbitrator_tpu.utils.metrics import metrics as ref_metrics
from kube_arbitrator_tpu_torch.api.types import TaskStatus
from kube_arbitrator_tpu_torch.cache.arena import ArenaDivergence, SnapshotArena
from kube_arbitrator_tpu_torch.cache.decode import BindColumn, EvictColumn
from kube_arbitrator_tpu_torch.framework import TorchDecider
from kube_arbitrator_tpu_torch.framework.conf import load_conf
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.options import reset_options
from kube_arbitrator_tpu_torch.utils.metrics import metrics

FULL_CONF = (
    'actions: "reclaim, allocate, backfill, preempt"\n'
    "tiers:\n"
    "- plugins:\n"
    "  - name: priority\n"
    "  - name: gang\n"
    "- plugins:\n"
    "  - name: drf\n"
    "  - name: predicates\n"
    "  - name: proportion\n"
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU cycles are thousands of small torch ops: one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh():
    reset_options()
    metrics().reset()
    ref_metrics().reset()
    yield
    build.pin_launch_thread(None)
    reset_options()
    metrics().reset()
    ref_metrics().reset()


def _mk(m=port_sim, seed=7, running=0.4, nodes=12, jobs=8, tpj=5):
    return m.generate_cluster(num_nodes=nodes, num_jobs=jobs, tasks_per_job=tpj, num_queues=3,
                              seed=seed, running_fraction=running)


def _sched(sim, **kw):
    return port_framework.Scheduler(sim, decider=TorchDecider("cpu"), arena=True, **kw)


def _pairs(binds):
    return sorted((b.task_uid, b.node_name) for b in binds)


def _uids(evicts):
    return sorted(e.task_uid for e in evicts)


def _discards(ds):
    return sorted((d.kind, d.task_uid, d.reason, d.detail) for d in ds)


# ---------------------------------------------------------------- the gate


def _gate_world(m):
    sim = _mk(m, seed=3, running=0.5, nodes=4, jobs=3, tpj=4)
    index = {uid: t for j in sim.cluster.jobs.values() for uid, t in j.tasks.items()}
    pending = sorted((t for t in index.values() if t.status.name == "PENDING"),
                     key=lambda t: t.uid)
    running = sorted((t for t in index.values() if t.status.name == "RUNNING"),
                     key=lambda t: t.uid)
    assert pending and running
    return sim, pending, running


def _script_task_gone(m, sim, pending, running, j):
    v = pending[0]
    j.task_dirty(v.uid)
    sim.cluster.jobs[v.job_uid].tasks.pop(v.uid)
    return [(v.uid, "node-00000")], []


def _script_already_bound(m, sim, pending, running, j):
    t = pending[0]
    t.status = m.TaskStatus.BOUND
    t.node_name = "node-00001"
    j.task_dirty(t.uid)
    return [(t.uid, "node-00000")], []


def _script_node_gone_unsched(m, sim, pending, running, j):
    sim.cluster.nodes.pop("node-00000")
    sim.cluster.nodes["node-00001"].unschedulable = True
    j.node_dirty("node-00000")
    j.node_dirty("node-00001")
    return [(pending[0].uid, "node-00000"), (pending[1].uid, "node-00001")], []


def _script_capacity_shrunk(m, sim, pending, running, j):
    by_job = {}
    for t in pending:
        by_job.setdefault(t.job_uid, []).append(t)
    a, b = next(ts for ts in by_job.values() if len(ts) >= 2)[:2]
    node = sim.cluster.nodes["node-00002"]
    node.idle = np.asarray(a.resreq) * 1.5
    node.releasing = np.zeros_like(node.idle)
    j.node_dirty(node.name)
    return [(a.uid, node.name), (b.uid, node.name)], []


def _script_pod_cap(m, sim, pending, running, j):
    node = sim.cluster.nodes["node-00003"]
    node.max_tasks = len(node.tasks) + 1
    j.node_dirty(node.name)
    return [(pending[0].uid, node.name), (pending[1].uid, node.name)], []


def _script_not_evictable(m, sim, pending, running, j):
    running[0].status = m.TaskStatus.RELEASING
    j.structural_event("relist")  # no per-row dirt: the structural flip
    return [], [running[0].uid, running[1].uid]


def _script_untouched(m, sim, pending, running, j):
    j.task_dirty("no-such-task")  # a non-empty window that implicates nothing
    return [(pending[0].uid, "node-00000")], [running[0].uid]


SCRIPTS = {
    "task_gone": _script_task_gone,
    "already_bound": _script_already_bound,
    "node_gone+node_unsched": _script_node_gone_unsched,
    "capacity_shrunk": _script_capacity_shrunk,
    "capacity_shrunk_pod_cap": _script_pod_cap,
    "not_evictable": _script_not_evictable,
    "untouched": _script_untouched,
}


class _Pkg:
    def __init__(self, sim_mod, pipeline, status):
        self.sim, self.pipeline, self.TaskStatus = sim_mod, pipeline, status


REF = _Pkg(ref_sim, ref_pipeline, RefStatus)
PORT = _Pkg(port_sim, port_pipeline, TaskStatus)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_gate_discards_equal_reference(script):
    """The same scripted window through both packages' object gates (and
    the port's columnar gate): equal kept decisions and discards."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        sim, pending, running = _gate_world(pkg.sim)
        j = pkg.pipeline.DeltaJournal()
        binds, evicts = SCRIPTS[script](pkg, sim, pending, running, j)
        kb, ke, ds = pkg.pipeline.revalidate_decisions(
            sim.cluster, [pkg.sim.BindIntent(task_uid=u, node_name=n) for u, n in binds],
            [pkg.sim.EvictIntent(task_uid=u) for u in evicts], j)
        out[name] = (_pairs(kb), _uids(ke), _discards(ds))
        if pkg is PORT:
            out["columnar"] = _columnar(sim, binds, evicts, j)
    assert out["port"] == out["ref"]
    assert out["columnar"] == out["ref"]
    reasons = {d[2] for d in out["port"][2]}
    assert reasons <= set(port_pipeline.DISCARD_REASONS)
    assert (script == "untouched") == (not reasons)


def _columnar(sim, binds, evicts, journal):
    """The port's columnar gate on the same decisions as columns over an
    index of the live model's task rows."""

    uids = sorted({u for u, _ in binds} | set(evicts))
    nodes = sorted(set(sim.cluster.nodes) | {n for _, n in binds})
    idx = NS(tasks=[NS(uid=u) for u in uids], nodes=[NS(name=n) for n in nodes])
    bc = BindColumn(idx, np.array([uids.index(u) for u, _ in binds], np.int64),
                    np.array([nodes.index(n) for _, n in binds], np.int64))
    ec = EvictColumn(idx, np.array([uids.index(u) for u in evicts], np.int64))
    kb, ke, ds = port_pipeline.revalidate_batch(sim.cluster, bc, ec, journal)
    return _pairs(kb), _uids(ke), _discards(ds)


def test_gate_empty_journal_is_identity():
    sim, pending, running = _gate_world(port_sim)
    binds = [port_sim.BindIntent(task_uid=pending[0].uid, node_name="node-00000")]
    evicts = [port_sim.EvictIntent(task_uid=running[0].uid)]
    kb, ke, ds = port_pipeline.revalidate_decisions(sim.cluster, binds, evicts,
                                                    port_pipeline.DeltaJournal())
    assert kb == binds and ke == evicts and not ds
    assert port_pipeline.DISCARD_REASONS == ref_pipeline.DISCARD_REASONS


def test_journal_tee_records_even_when_arena_structural():
    sim = _mk(seed=1, running=0.0, nodes=4, jobs=2, tpj=3)
    arena = SnapshotArena(sim)
    j = port_pipeline.DeltaJournal()
    arena.journal = j
    # the arena is structurally dirty from seeding; the journal still records
    assert arena._structural is not None
    sim.delta_sink.task_dirty("t1", "n1")
    sim.delta_sink.node_dirty("n2")
    sim.delta_sink.task_dirty_rows(["t2", "t3"], ["n3", ""])
    assert {"t1", "t2", "t3"} == j.dirty_tasks and {"n1", "n2", "n3"} == j.dirty_nodes
    assert j.events == 4
    j.reset()
    assert j.empty
    arena.structural("test_reason")
    assert j.structural == ["test_reason"]


# ---------------------------------------------------------------- the executor


def test_quiescent_pipelined_equals_sequential_cycle_for_cycle():
    """No external churn: every pipelined step commits the sequential
    cycle's binds and evicts, with nothing discarded."""
    seq = _sched(_mk(), config=load_conf(FULL_CONF))
    want = [seq.run_once() for _ in range(8)]
    pipe = _sched(_mk(), config=load_conf(FULL_CONF))
    ex = port_pipeline.PipelinedExecutor(pipe)
    try:
        for c, r in enumerate(want):
            out = ex.step()
            assert _pairs(out.binds) == _pairs(r.binds), c
            assert _uids(out.evicts) == _uids(r.evicts), c
            assert not out.discards, c
    finally:
        ex.close()
    assert len(pipe.history) == 8 and sum(s.binds for s in pipe.history) > 0
    assert sum(s.evicts for s in pipe.history) > 0
    assert set(ex.occupancy()) == set(port_pipeline.PIPELINE_STAGES)
    text = metrics().render()
    assert "pipeline_cycle_period_seconds" in text
    assert 'pipeline_stage_occupancy{stage="decide"}' in text


def test_run_pipelined_until_idle_matches_sequential_totals():
    seq = _sched(_mk(seed=11, running=0.0))
    pipe = _sched(_mk(seed=11, running=0.0))
    assert seq.run(max_cycles=6) == pipe.run_pipelined(max_cycles=6)
    assert sum(s.binds for s in seq.history) == sum(s.binds for s in pipe.history) > 0
    assert build.launch_thread() is None  # the executor lifted its pin


class _Churn:
    """Mid-window churn through ``ingest_fn``, the same on either
    package's SimCluster (the world is the same in both): the first
    window deletes job-00000's pending tasks, the second cordons
    node-00000, the third shrinks node-00001's pod capacity to the pods
    it holds (each aimed at the window's own binds)."""

    def __init__(self, sim):
        self.sim = sim
        self.calls = 0

    def __call__(self):
        self.calls += 1
        sim = self.sim
        if self.calls == 1:
            j = sim.cluster.jobs["job-00000"]
            for uid in sorted(j.tasks):
                if j.tasks[uid].status.name == "PENDING":
                    j.tasks.pop(uid)
            sim.delta_sink.structural("task_set")
            return 1
        if self.calls in (2, 3):
            node = sim.cluster.nodes["node-00000" if self.calls == 2 else "node-00001"]
            if self.calls == 2:
                node.unschedulable = True
            else:
                node.max_tasks = len(node.tasks)
            sim.delta_sink.node_dirty(node.name)
            return 1
        return 0


def test_deterministic_churn_equals_reference():
    """``run_pipelined(deterministic=True)`` with the same mid-window
    churn in both packages: equal binds, evicts and discards step for
    step (the reference with its own LocalDecider)."""
    steps = 6
    got = {}
    for name, fw, m, extra in (
        ("ref", ref_framework, ref_sim, dict(config=ref_load_conf(FULL_CONF), arena=True)),
        ("port", port_framework, port_sim, dict(config=load_conf(FULL_CONF), arena=True,
                                                decider=TorchDecider("cpu"))),
    ):
        sim = _mk(m, seed=5, running=0.4, nodes=8, jobs=6, tpj=5)
        sched = fw.Scheduler(sim, **extra)
        pipe = (ref_pipeline if name == "ref" else port_pipeline).PipelinedExecutor(
            sched, deterministic=True, ingest_fn=_Churn(sim))
        rows = []
        try:
            for _ in range(steps):
                out = pipe.step()
                rows.append((_pairs(out.binds), _uids(out.evicts), _discards(out.discards)))
        finally:
            pipe.close()
        got[name] = rows
    assert got["port"] == got["ref"]
    reasons = {d[2] for row in got["port"] for d in row[2]}
    assert {"task_gone", "node_unsched", "capacity_shrunk"} <= reasons
    assert reasons <= set(port_pipeline.DISCARD_REASONS)


def test_decide_runs_on_the_worker_which_alone_may_launch():
    sim = _mk(seed=6, running=0.0, nodes=4, jobs=2, tpj=3)
    seen = []
    decider = TorchDecider("cpu")
    inner = decider.decide

    def spy(st, config, pack_meta=None):
        seen.append(threading.current_thread().name)
        return inner(st, config, pack_meta)

    decider.decide = spy
    sched = port_framework.Scheduler(sim, decider=decider, arena=True)
    ex = port_pipeline.PipelinedExecutor(sched)
    try:
        ex.step()
        ex.step()
        worker = build.launch_thread()
        assert worker is not None and worker.name.startswith("kat-pipe-decide")
        # the ingest thread may not decide (nor launch) while the worker is pinned
        snap = sched.arena.snapshot()
        with pytest.raises(RuntimeError, match="pinned to thread 'kat-pipe-decide"):
            inner(snap.tensors, sched.config)
    finally:
        ex.close()
    assert seen and all(n.startswith("kat-pipe-decide") for n in seen)
    assert build.launch_thread() is None


def test_backpressure_counter_fires_when_ingest_outruns_decide():
    sim = _mk(seed=2, running=0.0, nodes=4, jobs=2, tpj=3)
    decider = TorchDecider("cpu")
    inner = decider.decide

    def slow(st, config, pack_meta=None):
        time.sleep(0.15)
        return inner(st, config, pack_meta)

    decider.decide = slow
    sched = port_framework.Scheduler(sim, decider=decider, arena=True)
    ex = port_pipeline.PipelinedExecutor(sched, max_ingest_per_wait=1, wait_poll_s=0.001,
                                         ingest_fn=lambda: 1)
    try:
        ex.step()
        ex.step()
    finally:
        ex.close()
    assert ex.backpressure_events >= 1
    assert metrics().counter_total("pipeline_backpressure_total") == ex.backpressure_events


def test_freeze_failure_after_commit_keeps_epoch_bookkeeping():
    """A failed pre-submit freeze (an ArenaDivergence at the epoch check)
    must not erase the committed epoch's evidence: its stats land in
    history before the freeze error surfaces, and the executor recovers."""
    sched = _sched(_mk(seed=8, running=0.0, nodes=5, jobs=3, tpj=3))
    ex = port_pipeline.PipelinedExecutor(sched)
    try:
        ex.step()  # fill + commit epoch 1; epoch 2 in flight
        n_hist = len(sched.history)
        # poison the arena: the NEXT pre-submit freeze's verify trips
        sched.arena.verify_every = 1
        sched.arena._packs_since_verify = 1
        sched.arena._w["node_idle"][0] *= 7
        with pytest.raises(ArenaDivergence):
            ex.step()
        assert len(sched.history) == n_hist + 1
        out = ex.step()  # the poisoned arena rebuilds
        assert out.stats is sched.history[-1]
    finally:
        ex.close()
