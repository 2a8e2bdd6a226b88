"""The port's serving path held against the JAX package: the epoch-keyed
device-resident pack (``cache/arena.DeviceResident``, K18's plain
version on the CPU), ``framework.TorchDecider`` behind the reference's
``Scheduler`` / ``Session``, and the array-level churn helpers of
``cache/synth.py``.

Packs and decisions are integers or sums of integral device units below
2^24, so every comparison is exact (tolerance: none).  K18 itself runs
only on the card (a ``cuda``-marked test, and chip_smoke.py's
``k18_case`` and phase 7).
"""
import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import TaskStatus
from kube_arbitrator_tpu.cache import SimCluster, generate_cluster
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.cache.arena import SnapshotArena, _pad_rows, _scatter_copy
from kube_arbitrator_tpu.cache.sim import BindIntent, EvictIntent
from kube_arbitrator_tpu.framework import Scheduler
from kube_arbitrator_tpu.framework.conf import SchedulerConfig as RefConfig
from kube_arbitrator_tpu.framework.conf import load_conf
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu_torch import cli
from kube_arbitrator_tpu_torch.cache.arena import (
    ARRAY_FIELDS, DeviceResident, PackMeta, changed_fields, changed_rows,
)
from kube_arbitrator_tpu_torch.cache.synth import (
    build_synthetic_arrays, complete_running, cordon, epoch_stream, pick_churn,
)
from kube_arbitrator_tpu_torch.framework import SchedulerConfig, TorchDecider, from_config
from kube_arbitrator_tpu_torch.framework.decider import host_fields
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops.kernels import row_scatter as k18

GB = 1024**3
CPU = 1000
FULL_ACTIONS = ("reclaim", "allocate", "backfill", "preempt")
FULL_CONF = load_conf(
    'actions: "reclaim, allocate, backfill, preempt"\n'
    "tiers:\n"
    "- plugins:\n  - name: priority\n  - name: gang\n"
    "- plugins:\n  - name: drf\n  - name: predicates\n  - name: proportion\n"
)


def tasks_by_status(sim, status):
    return [t for j in sim.cluster.jobs.values() for t in j.tasks.values() if t.status == status]


def feasible_bind(sim, rng):
    pend = tasks_by_status(sim, TaskStatus.PENDING)
    if not pend:
        return None
    t = rng.choice(pend)
    nodes = list(sim.cluster.nodes.values())
    rng.shuffle(nodes)
    for n in nodes:
        if (n.idle - t.resreq >= -1e-6).all() and len(n.tasks) < n.max_tasks:
            return BindIntent(t.uid, n.name)
    return None


def assert_decisions_equal(ref, port, ctx=""):
    for f in dataclasses.fields(port):
        a, b = np.asarray(getattr(ref, f.name)), getattr(port, f.name)
        assert isinstance(b, np.ndarray), f"{ctx}{f.name} is not a host array"
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx}{f.name}"
        assert np.array_equal(a, b), f"{ctx}{f.name} differs"


# ---------------------------------------------------------------- K18 plain


@pytest.mark.parametrize("dtype,shape", [
    (np.bool_, (9,)), (np.int32, (9,)), (np.float32, (9,)),
    (np.bool_, (9, 3)), (np.int32, (9, 2)), (np.float32, (9, 4)),
])
def test_row_scatter_fields(dtype, shape):
    """Every field dtype and rank; the result equals numpy's row
    assignment, and a CPU call launches nothing."""
    rng = np.random.default_rng(len(shape) * 7 + np.dtype(dtype).itemsize)
    base = (rng.random(shape) * 100).astype(dtype)
    idx = np.array([1, 4, 8], np.int32)
    rows = (rng.random((3,) + shape[1:]) * 100).astype(dtype)
    buf = torch.from_numpy(base.copy())
    want = base.copy()
    want[idx] = rows
    plan = k18.RowScatterPlan("cpu")
    plan.place("f", buf)
    before = k18.RowScatterPlan.launches
    assert plan([("f", want, idx)]) == rows.nbytes + idx.nbytes
    assert np.array_equal(buf.numpy(), want)
    assert k18.RowScatterPlan.launches == before


def test_row_scatter_duplicate_rows_like_reference_padding():
    """The reference pads a scatter by repeating its last (index, row)
    pair (tests/test_arena.py:344); the same padded indices land the
    same result through K18's plan on the CPU."""
    buf = np.arange(40, dtype=np.float32).reshape(10, 4)
    rows = np.array([2, 7], dtype=np.int32)
    vals = np.full((2, 4), -1.0, dtype=np.float32)
    idx_p, vals_p = _pad_rows(rows, vals)
    assert len(idx_p) > len(rows)
    expect = buf.copy()
    expect[rows] = vals
    assert np.array_equal(expect[idx_p], vals_p)  # the plan gathers the padded rows
    got = torch.from_numpy(buf.copy())
    plan = k18.RowScatterPlan("cpu")
    plan.place("f", got)
    plan([("f", expect, idx_p)])
    assert np.array_equal(got.numpy(), expect)
    assert np.array_equal(got.numpy(), np.asarray(_scatter_copy(buf.copy(), idx_p, vals_p)))


def test_row_scatter_empty_epoch_and_refusals():
    buf = torch.zeros(4, dtype=torch.int32)
    plan = k18.RowScatterPlan("cpu")
    plan.place("f", buf)
    assert plan([]) == 0
    assert plan([("f", np.ones(4, np.int32), np.zeros(0, np.int32))]) == 0
    assert torch.equal(buf, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        plan([("f", np.ones(4, np.float32), np.array([0]))])
    with pytest.raises(IndexError):
        plan([("f", np.ones(4, np.int32), np.array([4]))])
    with pytest.raises(IndexError):
        plan([("f", np.ones(4, np.int32), np.array([-1]))])
    with pytest.raises(ValueError):
        plan([("f", np.ones(3, np.int32), np.array([0, 1]))])
    with pytest.raises(TypeError):
        plan.place("g", torch.zeros(4, dtype=torch.float64))
    assert torch.equal(buf, torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------- DeviceResident


def test_device_resident_reuse_full_and_delta():
    """tests/test_arena.py:316 on the port: full, then reuse with 0
    bytes, then a delta epoch of fewer bytes; the resident equals the
    host pack after each; it owns its buffers."""
    sim = generate_cluster(num_nodes=12, num_jobs=4, tasks_per_job=6, num_queues=2, seed=4)
    arena = SnapshotArena(sim, verify_every=0)
    d = TorchDecider("cpu")
    s0 = arena.snapshot()
    d.upload(s0.tensors, arena.pack_meta)
    assert d.last_mode == "full"
    full_bytes = d.last_upload_bytes
    assert full_bytes == sum(host_fields(s0.tensors)[n].nbytes for n in ARRAY_FIELDS)
    d.upload(s0.tensors, arena.pack_meta)
    assert (d.last_mode, d.last_upload_bytes) == ("reuse", 0)
    sim.apply_binds([feasible_bind(sim, random.Random(1))])
    s1 = arena.snapshot()
    assert arena.pack_meta.base_key is not None
    d.upload(s1.tensors, arena.pack_meta)
    assert d.last_mode == "delta"
    assert 0 < d.last_upload_bytes < full_bytes
    host = host_fields(s1.tensors)
    assert d.resident.first_difference(host) is None
    # the caller's arrays are not aliased
    status = host["task_status"].copy()
    s1.tensors.task_status[:] = 99
    assert np.array_equal(d.resident.arrays["task_status"].numpy(), status)


def test_device_resident_full_triggers_and_field_rules():
    arrays, _ = build_synthetic_arrays(400, 40, 4, 20, 3, running_fraction=0.5)
    statics = {"rv_window": int(arrays["rv_window"])}
    cpu = torch.device("cpu")
    r = DeviceResident()
    r.update(arrays, statics, "a", None, {}, cpu)
    assert r.last_mode == "full"
    new = dict(arrays)
    new["task_priority"] = arrays["task_priority"].copy()
    new["task_priority"][[3, 5]] = 7                      # 2 rows: scattered
    new["node_unsched"] = ~arrays["node_unsched"]         # every row: re-placed
    new["group_valid"] = np.zeros(arrays["group_valid"].shape[0] + 8, bool)  # shape moved
    changed = {n: changed_rows(new[n], arrays[n]) for n in ("task_priority", "node_unsched", "group_valid")}
    assert isinstance(changed["group_valid"], str)
    r.update(new, statics, "b", "a", changed, cpu)
    assert r.last_mode == "delta"
    want = (2 * (4 + 4) + new["node_unsched"].nbytes + new["group_valid"].nbytes)
    assert r.last_upload_bytes == want
    assert r.first_difference(new) is None
    # a base that is not the resident's key: full
    r.update(new, statics, "c", "zzz", {}, cpu)
    assert r.last_mode == "full"
    # moved statics alone: a delta of no rows that takes the new statics
    moved = {"rv_window": statics["rv_window"] + 32}
    st = r.update(new, moved, "d", "c", {}, cpu)
    assert (r.last_mode, r.last_upload_bytes, st.rv_window) == ("delta", 0, moved["rv_window"])
    assert r.statics == moved and r.first_difference(new) is None
    assert changed_fields(arrays, new) == ("group_valid", "node_unsched", "task_priority")


# ---------------------------------------------------------------- the mutation stream


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutation_stream_resident_equals_arena_pack(seed):
    """tests/test_arena.py:70's stream (the same step mix, 60 steps)
    through the reference's SnapshotArena; after every step the decider's
    resident equals the arena's host pack field for field, and every 10th
    step its decisions equal the reference's schedule_cycle
    (native_ops=False) on the same pack."""
    rng = random.Random(seed)
    sim = generate_cluster(num_nodes=12, num_jobs=6, tasks_per_job=6, num_queues=2 + seed,
                           seed=seed, running_fraction=0.4)
    arena = SnapshotArena(sim, verify_every=0)
    d = TorchDecider("cpu")
    conf = RefConfig(actions=FULL_ACTIONS, tiers=ref_ord.DEFAULT_TIERS)

    def step_bind():
        b = feasible_bind(sim, rng)
        if b is not None:
            sim.apply_binds([b])

    def step_bind_failure():
        b = feasible_bind(sim, rng)
        if b is not None:
            sim.binder.fail_uids = {b.task_uid}
            sim.apply_binds([b])
            sim.binder.fail_uids = set()
            sim.process_resync()

    def step_evict():
        running = tasks_by_status(sim, TaskStatus.RUNNING)
        if running:
            sim.apply_evicts([EvictIntent(rng.choice(running).uid)])

    def step_add_task():
        job = rng.choice(list(sim.cluster.jobs.values()))
        sim.add_task(job, 400, 512 * 1024**2, priority=rng.randrange(3))

    def step_add_job():
        j = sim.add_job(f"rand-job-{rng.randrange(10**6)}", queue=rng.choice(list(sim.cluster.queues)))
        sim.add_task(j, 200, 256 * 1024**2)

    def step_delete_job():
        jobs = [j for j in sim.cluster.jobs.values()
                if all(t.status == TaskStatus.PENDING for t in j.tasks.values())]
        if jobs:
            j = rng.choice(jobs)
            for t in j.tasks.values():
                t.status = TaskStatus.SUCCEEDED
            for t in j.tasks.values():
                arena.task_dirty(t.uid)
            sim.delete_job(j.uid, now=0.0)
            sim.collect_garbage(now=10.0)

    def step_add_node():
        sim.add_node(f"rand-node-{rng.randrange(10**6)}", cpu_milli=16000, memory=32 * 1024**3)

    def step_cordon():
        n = rng.choice(list(sim.cluster.nodes.values()))
        n.unschedulable = not n.unschedulable
        arena.node_dirty(n.name)

    steps = [step_bind, step_bind, step_evict, step_add_task, step_cordon,
             step_bind_failure, step_add_job, step_delete_job, step_add_node]
    modes = set()
    for i in range(60):
        rng.choice(steps)()
        snap = arena.snapshot()
        if i % 10 == 9:
            dec, _ = d.decide(snap.tensors, conf, arena.pack_meta)
            ref = ref_cycle.schedule_cycle(snap.tensors, tiers=ref_ord.DEFAULT_TIERS,
                                           actions=FULL_ACTIONS, native_ops=False)
            assert_decisions_equal(ref, dec, ctx=f"seed {seed} step {i}: ")
        else:
            d.upload(snap.tensors, arena.pack_meta)
        modes.add(d.last_mode)
        diff = d.resident.first_difference(host_fields(snap.tensors))
        assert diff is None, f"seed {seed} step {i}: resident {diff} differs ({d.last_mode})"
    assert {"full", "delta"} <= modes


# ---------------------------------------------------------------- the Session


def _three_nodes(sim):
    for i in range(3):
        sim.add_node(f"node-{i}", cpu_milli=4 * CPU, memory=32 * GB)


def _job(sim, name, queue, rep, minm, mem=GB, **kw):
    j = sim.add_job(name, queue=queue, min_available=minm, creation_ts=float(len(sim.cluster.jobs)))
    for i in range(rep):
        sim.add_task(j, CPU, mem, name=f"{name}-{i}", priority=1, **kw)
    return j


def world_arena():
    """tests/test_arena.py:359's world."""
    return generate_cluster(num_nodes=16, num_jobs=6, tasks_per_job=8, num_queues=2, seed=21,
                            running_fraction=0.3), None


def world_gang_release():
    """test_e2e_parity.py's gang release: a filler over half the cluster
    keeps a gang pending until the filler goes (after cycle 2)."""
    sim = SimCluster()
    sim.add_queue("default")
    _three_nodes(sim)
    filler = sim.add_job("filler", queue="default", min_available=0, creation_ts=0)
    for i in range(7):
        sim.add_task(filler, CPU, 0, status=TaskStatus.RUNNING, node=f"node-{i % 3}", name=f"f{i}")
    _job(sim, "gang-qj", "default", rep=7, minm=7)

    def event(cycle, arena):
        if cycle == 2:
            for t in list(filler.tasks.values()):
                if t.node_name:
                    sim.cluster.nodes[t.node_name].remove_task(t)
                t.status = TaskStatus.SUCCEEDED
            sim.delete_job(filler.uid)
            sim.collect_garbage(now=1e18)
            arena.structural("filler deleted")
    return sim, event


def world_preemption():
    """test_e2e_parity.py's preemption: a running 12-task job, a second
    job of the same queue arrives; evicted pods come back pending."""
    sim = SimCluster()
    sim.add_queue("default")
    _three_nodes(sim)
    j1 = sim.add_job("preemptee-qj", queue="default", min_available=1, creation_ts=0)
    for i in range(12):
        sim.add_task(j1, CPU, 0, status=TaskStatus.RUNNING, node=f"node-{i % 3}", name=f"p{i}",
                     priority=1)
    _job(sim, "preemptor-qj", "default", rep=12, minm=1, mem=0)
    return sim, None


def world_reclaim():
    """test_e2e_parity.py's reclaim between queues: q1's job holds the
    cluster, q2's job reclaims toward its deserved half."""
    sim = SimCluster()
    sim.add_queue("q1", weight=1)
    sim.add_queue("q2", weight=1)
    _three_nodes(sim)
    j1 = sim.add_job("q1-qj-1", queue="q1", min_available=1, creation_ts=0)
    for i in range(12):
        sim.add_task(j1, CPU, 0, status=TaskStatus.RUNNING, node=f"node-{i % 3}", name=f"r{i}",
                     priority=1)
    _job(sim, "q2-qj-2", "q2", rep=12, minm=1, mem=0)
    return sim, None


def kubelet(sim, arena):
    """Between cycles: evicted (RELEASING) pods terminate and come back
    pending (the Job controller); bound pods start RUNNING.  Every
    change is published to the arena."""
    dying = tasks_by_status(sim, TaskStatus.RELEASING)
    for t in dying:
        if t.node_name:
            sim.cluster.nodes[t.node_name].remove_task(t)
        job = sim.cluster.jobs[t.job_uid]
        del job.tasks[t.uid]
        sim.add_task(job, t.resreq[0], t.resreq[1], name=f"{t.uid}.r", priority=t.priority)
    if dying:
        arena.structural("pods recreated")
    for t in tasks_by_status(sim, TaskStatus.BOUND):
        node = sim.cluster.nodes[t.node_name]
        node.remove_task(t)
        t.status = TaskStatus.RUNNING
        node.add_task(t)
        arena.task_dirty(t.uid, t.node_name)


@pytest.mark.parametrize("world", [world_arena, world_gang_release, world_preemption,
                                   world_reclaim], ids=lambda w: w.__name__[6:])
def test_scheduler_with_torch_decider_matches_local(world):
    """The reference Scheduler with TorchDecider("cpu") and an arena
    against the same Scheduler with its own LocalDecider: equal binds
    and evicts in every one of 6 cycles."""
    (sim_t, ev_t), (sim_l, ev_l) = world(), world()
    torch_s = Scheduler(sim_t, config=FULL_CONF, decider=TorchDecider("cpu"), arena=True)
    local_s = Scheduler(sim_l, config=FULL_CONF, arena=True)
    binds = evicts = 0
    modes = []
    for cyc in range(6):
        rt, rl = torch_s.run_once(), local_s.run_once()
        modes.append(torch_s.decider.last_mode)
        bt = sorted((x.task_uid, x.node_name) for x in rt.binds)
        assert bt == sorted((x.task_uid, x.node_name) for x in rl.binds), cyc
        et = sorted(x.task_uid for x in rt.evicts)
        assert et == sorted(x.task_uid for x in rl.evicts), cyc
        binds, evicts = binds + len(bt), evicts + len(et)
        for sim, sched, ev in ((sim_t, torch_s, ev_t), (sim_l, local_s, ev_l)):
            kubelet(sim, sched.arena)
            if ev is not None:
                ev(cyc, sched.arena)
    assert binds > 0
    if world in (world_preemption, world_reclaim):
        assert evicts > 0
    assert modes[0] == "full" and "delta" in modes


# ---------------------------------------------------------------- churn helpers


def _pipe_churn_uids(sim, cycle, frac):
    """The reference bench's _pipe_churn (bench.py:717-744) on ``sim``:
    the uids it completes."""
    rng = random.Random(f"kat-pipe-churn:{cycle}")
    running = tasks_by_status(sim, TaskStatus.RUNNING)
    k = min(len(running), max(1, int(len(running) * frac)))
    done = []
    for t in rng.sample(running, k):
        node = sim.cluster.nodes.get(t.node_name)
        if node is not None and t.uid in node.tasks:
            node.remove_task(t)
        t.status = TaskStatus.SUCCEEDED
        sim.delta_sink.task_dirty(t.uid, t.node_name)
        done.append(t.uid)
    return done


def _pack(snap):
    out = host_fields(snap.tensors)
    out["rv_window"] = snap.tensors.rv_window
    return out


def _ports_sim():
    sim = SimCluster()
    sim.add_queue("q")
    for n in range(3):
        sim.add_node(f"n{n}", cpu_milli=8000, memory=16 * GB)
    web = sim.add_job("web", queue="q")
    for i in range(6):
        sim.add_task(web, 500, GB, name=f"web{i}", host_ports=(8080 + i % 2,),
                     status=TaskStatus.RUNNING, node=f"n{i % 3}")
    plain = sim.add_job("plain", queue="q")
    for i in range(4):
        sim.add_task(plain, 1000, GB, name=f"plain{i}")
    return sim


@pytest.mark.parametrize("make", [
    lambda: generate_cluster(num_nodes=10, num_jobs=6, tasks_per_job=8, num_queues=3, seed=5,
                             running_fraction=0.6),
    _ports_sim,
], ids=["generated", "host_ports"])
def test_complete_running_and_cordon_equal_arena_packs(make):
    """The port's helpers applied to the previous pack equal the
    reference arena's next pack, field for field (buckets without the
    reference's sticky memo, as the port's)."""
    ref_snapshot.set_sticky_buckets(False)
    try:
        sim = make()
        arena = SnapshotArena(sim, verify_every=0)
        s0 = arena.snapshot()
        prev = _pack(s0)
        ords = {tk.uid: tk.ordinal for tk in s0.index.tasks}
        for cycle in (1, 2):
            uids = _pipe_churn_uids(sim, cycle, 0.3)
            snap = arena.snapshot()
            assert arena.last_rebuild_reason is None
            port = complete_running(prev, np.array(sorted(ords[u] for u in uids)))
            want = _pack(snap)
            for name in ARRAY_FIELDS:
                assert np.array_equal(port[name], want[name]) and port[name].dtype == want[name].dtype, name
            assert port["rv_window"] == want["rv_window"]
            assert set(changed_fields(prev, port)) <= set(arena.pack_meta.changed_fields)
            prev = port
        nodes = list(sim.cluster.nodes.values())[:2]
        for n in nodes:
            n.unschedulable = not n.unschedulable
            arena.node_dirty(n.name)
        want = _pack(arena.snapshot())
        port = cordon(prev, np.array([n.ordinal for n in nodes]))
        for name in ARRAY_FIELDS:
            assert np.array_equal(port[name], want[name]), name
    finally:
        ref_snapshot.set_sticky_buckets(True)


def test_epoch_stream_names_what_changed():
    arrays, _ = build_synthetic_arrays(2000, 200, 4, 100, 42, running_fraction=0.5)
    epochs = list(epoch_stream(arrays, 3, 0.04, 0.05, seed=3))
    assert [m.key for _, _, m in epochs] == ["epoch-1", "epoch-2", "epoch-3"]
    assert epochs[0][2].base_key is None and epochs[2][2].base_key == "epoch-2"
    for (_, prev, _), (_, pack, meta) in zip(epochs, epochs[1:]):
        assert {"task_status", "node_idle", "node_unsched"} <= set(meta.changed_fields)
        assert meta.changed_fields == changed_fields(prev, pack)
        assert int((pack["node_unsched"] != prev["node_unsched"]).sum()) == 10


def test_pick_churn_draws_the_reference_count():
    arrays, _ = build_synthetic_arrays(2000, 200, 4, 100, 42, running_fraction=0.5)
    running = int((arrays["task_status"] == int(TaskStatus.RUNNING)).sum())
    rows = pick_churn(arrays, 0.04, 3)
    assert len(rows) == int(running * 0.04) and np.all(np.diff(rows) > 0)
    assert np.array_equal(rows, pick_churn(arrays, 0.04, 3))
    assert (arrays["task_status"][rows] == int(TaskStatus.RUNNING)).all()
    after = complete_running(arrays, rows)
    assert (after["task_status"][rows] == int(TaskStatus.SUCCEEDED)).all()
    assert after["task_resreq"] is arrays["task_resreq"]
    with pytest.raises(ValueError):
        complete_running(after, rows)


# ---------------------------------------------------------------- the seams


def test_from_config_reads_the_reference_conf():
    conf = from_config(FULL_CONF)
    assert conf.actions == FULL_ACTIONS
    assert conf.tiers == port_ord.DEFAULT_TIERS
    assert from_config(RefConfig.default()) == SchedulerConfig.default()
    with pytest.raises(ValueError, match="unknown actions"):
        from_config(RefConfig(actions=("allocate", "enqueue"), tiers=()))


def test_torch_decider_refuses_a_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchDecider()
    assert TorchDecider("cpu").device == torch.device("cpu")
    assert TorchDecider.wants_device_pack is False and TorchDecider.supports_decode_caps


def test_torch_decider_honours_decode_caps():
    arrays, _ = build_synthetic_arrays(1000, 100, 4, 50, 1, running_fraction=0.2, fit_fraction=1.5)
    meta = PackMeta(key="k", base_key=None, changed_fields=(), decode_caps=(16, 8))
    dec, ms = TorchDecider("cpu").decide(arrays, SchedulerConfig.default(), meta)
    assert dec.bind_idx.shape == (16,) and dec.evict_idx.shape == (8,) and ms > 0


def test_cli_serves_epochs_on_cpu(capsys):
    assert cli.main(["--tasks", "1000", "--nodes", "100", "--tasks-per-job", "50", "--cycles",
                     "1", "--running-fraction", "0.5", "--actions", ",".join(FULL_ACTIONS),
                     "--epochs", "3", "--device", "cpu", "--json"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["mode"] for r in rows] == ["full", "delta", "delta"]
    assert rows[1]["upload_bytes"] < rows[0]["upload_bytes"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_row_scatter_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(18)
    bufs, idxs, hosts = [], [], []
    for dtype, shape in ((np.bool_, (50,)), (np.int32, (50, 2)), (np.float32, (50, 4)),
                         (np.bool_, (50, 3))):
        bufs.append((rng.random(shape) * 50).astype(dtype))
        i = np.array([0, 7, 7, 49], np.int32)
        h = bufs[-1].copy()
        h[i] = (rng.random((4,) + shape[1:]) * 50).astype(dtype)
        idxs.append(i)
        hosts.append(h)
    dev = [torch.from_numpy(b.copy()).to(cuda_device) for b in bufs]
    cpu = [torch.from_numpy(b.copy()) for b in bufs]
    plan = k18.RowScatterPlan(cuda_device)
    for f, d in enumerate(dev):
        plan.place(f"f{f}", d)
    before = k18.RowScatterPlan.launches
    plan([(f"f{f}", h, i) for f, (h, i) in enumerate(zip(hosts, idxs))])
    k18.row_scatter_plain(cpu, idxs, [h[i] for h, i in zip(hosts, idxs)])
    assert k18.RowScatterPlan.launches == before + 1
    torch.cuda.synchronize()
    for g, c in zip(dev, cpu):
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_torch_decider_card_equals_cpu(cuda_device):
    arrays, _ = build_synthetic_arrays(2000, 200, 4, 100, 1, running_fraction=0.5,
                                       fit_fraction=1.0)
    conf = SchedulerConfig(actions=FULL_ACTIONS, tiers=port_ord.DEFAULT_TIERS)
    gpu, cpu = TorchDecider(cuda_device), TorchDecider("cpu")
    for e, arrays, meta in epoch_stream(arrays, 3, 0.04, 0.01, seed=1):
        a, _ = gpu.decide(arrays, conf, meta)
        b, _ = cpu.decide(arrays, conf, meta)
        assert gpu.last_mode == ("full" if e == 1 else "delta")
        assert gpu.resident.first_difference(arrays) is None
        for f in dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), (e, f.name)
