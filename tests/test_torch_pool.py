"""The port's decision pool (``kube_arbitrator_tpu_torch/rpc/pool.py``) on
the CPU, held against the reference's (``kube_arbitrator_tpu/rpc/pool.py``)
and against independent single-decider runs.

The counterparts of tests/test_pool.py (all but the pipelined frontend
and the two chaos tests, whose planes the port has not ported): batching
compatibility, bit identity of a batched launch, shape splitting, the
threaded 2 x 4 run, hitless restart, re-seed on heal, ``PoolUnavailable``
when every replica is partitioned, shedding and recovery on a fake clock,
promtext conformance, the real error on a failed serve, the
cross-partition split and the kill race.  Then one scripted run of the
reference pool on the same world shape, whose decision log (outcomes,
replicas, batch sizes, epochs) and decisions the port's inline pool must
repeat.  World sizes stay on one pack shape and the reference run
launches batches of 2 only, so JAX compiles one batched program.
"""
import ast
import dataclasses
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache import build_snapshot as ref_build_snapshot
from kube_arbitrator_tpu.cache import generate_cluster as ref_generate_cluster
from kube_arbitrator_tpu.cache.arena import PackMeta as RefPackMeta
from kube_arbitrator_tpu.framework.conf import SchedulerConfig as RefConfig
from kube_arbitrator_tpu.framework.conf import dump_conf
from kube_arbitrator_tpu.framework.decider import LocalDecider
from kube_arbitrator_tpu.rpc import pool as ref_pool
from kube_arbitrator_tpu_torch.cache import build_snapshot, generate_cluster
from kube_arbitrator_tpu_torch.cache.arena import PackMeta
from kube_arbitrator_tpu_torch.framework import Scheduler, SchedulerConfig, TorchDecider
from kube_arbitrator_tpu_torch.rpc import (
    DecisionPool,
    PoolClient,
    PoolShed,
    PoolUnavailable,
    TenantAdmission,
    np_equal_decisions,
    pack_shape_key,
)
from kube_arbitrator_tpu_torch.rpc.pool import conf_fingerprint
from kube_arbitrator_tpu_torch.utils.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
FULL = ("allocate", "preempt", "reclaim", "backfill")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU cycles are thousands of small torch ops: one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _world(seed, running_fraction=0.0, gen=generate_cluster):
    return gen(num_nodes=16, num_jobs=4, tasks_per_job=4, num_queues=2,
               seed=seed, running_fraction=running_fraction)


def _pack(seed, running_fraction=0.0):
    return build_snapshot(_world(seed, running_fraction).cluster).tensors


def _big(seed):
    return build_snapshot(generate_cluster(num_nodes=200, num_jobs=16, tasks_per_job=4,
                                           num_queues=2, seed=seed).cluster).tensors


def _bound(sim):
    return {t.uid: t.node_name for j in sim.cluster.jobs.values() for t in j.tasks.values()}


def _pool(**kw):
    return DecisionPool(device="cpu", **kw)


# ---- batching compatibility ----


def test_shape_key_groups_compatible_packs():
    cfg = SchedulerConfig.default()
    fp = conf_fingerprint(cfg)
    a, b = _pack(1), _pack(2)
    assert pack_shape_key(a, fp, cfg.actions) == pack_shape_key(b, fp, cfg.actions)
    # a different world size resolves different symbolic axes
    assert pack_shape_key(_big(3), fp, cfg.actions) != pack_shape_key(a, fp, cfg.actions)
    # a different conf is never stackable
    other = dataclasses.replace(cfg, actions=("allocate",))
    assert conf_fingerprint(other) != fp
    assert pack_shape_key(a, conf_fingerprint(other), cfg.actions) != pack_shape_key(
        a, fp, cfg.actions)
    # the evictive class is part of the key
    ev = _pack(1, running_fraction=0.5)
    assert pack_shape_key(ev, fp, FULL) != pack_shape_key(a, fp, FULL)
    # so are a tenant's decode caps
    assert pack_shape_key(a, fp, cfg.actions, (8, 4)) != pack_shape_key(a, fp, cfg.actions)


def test_shape_keys_group_as_the_reference_groups():
    """Over packs of two sizes and two evictive classes, confs that
    differ in actions and in a plugin flag, and decode caps: two requests
    share the port's key exactly when they share the reference's."""
    from kube_arbitrator_tpu.ops import ordering as ref_ord

    base = RefConfig.default()
    tiers = list(base.tiers)
    first = tiers[0].plugins
    flagged = dataclasses.replace(first[0], job_order_disabled=not first[0].job_order_disabled)
    tiers[0] = ref_ord.Tier(plugins=(flagged,) + first[1:])
    confs = [base, RefConfig(actions=FULL, tiers=base.tiers), RefConfig(base.actions, tuple(tiers))]
    worlds = []
    for seed, rf in ((1, 0.0), (2, 0.0), (3, 0.5), (4, 0.5)):
        worlds.append((ref_build_snapshot(_world(seed, rf, ref_generate_cluster).cluster).tensors,
                       build_snapshot(_world(seed, rf).cluster).tensors))
    worlds.append((ref_build_snapshot(ref_generate_cluster(
        num_nodes=200, num_jobs=16, tasks_per_job=4, num_queues=2, seed=5).cluster).tensors,
        _big(5)))
    ref_keys, port_keys = [], []
    for ref_st, port_st in worlds:
        for conf in confs:
            for caps in (None, (8, 4)):
                ref_keys.append(ref_pool.pack_shape_key(ref_st, dump_conf(conf), conf.actions,
                                                        caps))
                port_keys.append(pack_shape_key(port_st, conf_fingerprint(conf), conf.actions,
                                                caps))
    n = len(ref_keys)
    assert len(set(port_keys)) == len(set(ref_keys)) > 1
    for i in range(n):
        for j in range(n):
            assert (ref_keys[i] == ref_keys[j]) == (port_keys[i] == port_keys[j]), (i, j)


def test_batched_launch_bit_identical_to_single():
    """One launch of B stacked packs == B single decides, bit for bit, on
    every CycleDecisions field (the port's TorchDecider and the
    reference's LocalDecider)."""
    cfg = SchedulerConfig.default()
    seeds = (11, 12, 13)
    packs = [_pack(s) for s in seeds]
    pool = _pool(replicas=1)
    reqs = pool.decide_many([(f"t{i}", p, cfg, None) for i, p in enumerate(packs)])
    assert all(r.error is None for r in reqs)
    assert {r.batch for r in reqs} == {3}
    ld = LocalDecider()
    for r, p, s in zip(reqs, packs, seeds):
        dec, _ = TorchDecider("cpu").decide(p, cfg)
        assert np_equal_decisions(r.decisions, dec), f"{r.tenant} diverged"
        ref, _ = ld.decide(ref_build_snapshot(_world(s, gen=ref_generate_cluster).cluster).tensors,
                           RefConfig.default())
        assert np_equal_decisions(r.decisions, ref), f"{r.tenant} diverged from the reference"


def test_incompatible_shapes_split_into_separate_launches():
    cfg = SchedulerConfig.default()
    pool = _pool(replicas=1)
    reqs = pool.decide_many([("a", _pack(21), cfg, None), ("b", _big(22), cfg, None)])
    assert all(r.error is None for r in reqs)
    assert all(r.batch == 1 for r in reqs), "incompatible packs were stacked"
    assert reqs[0].batch_id != reqs[1].batch_id


# ---- the 2-replica x 4-frontend run ----


def test_pool_2x4_batched_matches_independent_runs():
    """2 replicas x 4 tenant frontends on threads, min_fill forcing the
    batcher to stack: per-tenant binds equal 4 independent single-decider
    runs, and at least one launch stacked >= 2 packs."""
    pool = _pool(replicas=2, threaded=True, min_fill=4, batch_delay_s=0.25, max_batch=8)
    sims = [_world(100 + i) for i in range(4)]
    scheds = [
        Scheduler(s, decider=PoolClient(pool, f"t{i}"), arena=True)
        for i, s in enumerate(sims)
    ]
    threads = [
        threading.Thread(target=lambda s=s: s.run(max_cycles=3, until_idle=False))
        for s in scheds
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pool.close()
    refs = [_world(100 + i) for i in range(4)]
    for r in refs:
        Scheduler(r, decider=TorchDecider("cpu"), arena=True).run(max_cycles=3, until_idle=False)
    for sim, ref in zip(sims, refs):
        assert _bound(sim) == _bound(ref), "pooled tenant diverged"
    sizes = [e["batch"] for e in pool.decision_log if e["outcome"] in ("served", "resent")]
    assert max(sizes) >= 2, f"batching never stacked: {sizes}"
    assert sum(s.binds for sc in scheds for s in sc.history) > 0
    # the scheduler's upload columns come from the serving replica
    assert {s.upload_mode for sc in scheds for s in sc.history} <= {"full", "delta", "reuse"}


# ---- epoch-keyed replication: restart, partition, epoch correctness ----


def test_delta_fanout_hitless_replica_restart():
    pool = _pool(replicas=2)
    sims = [_world(40 + i, running_fraction=0.2) for i in range(2)]
    scheds = [
        Scheduler(s, decider=PoolClient(pool, f"t{i}"), arena=True)
        for i, s in enumerate(sims)
    ]
    for cycle in range(4):
        if cycle == 2:
            pool.kill_replica(0)  # packs gone; rejoin empty
        for s in scheds:
            s.run(max_cycles=1, until_idle=False)
    refs = [_world(40 + i, running_fraction=0.2) for i in range(2)]
    for r in refs:
        Scheduler(r, decider=TorchDecider("cpu"), arena=True).run(max_cycles=4, until_idle=False)
    for sim, ref in zip(sims, refs):
        assert _bound(sim) == _bound(ref), "restart changed decisions"
    log = pool.log_for("t0")
    assert any(e["outcome"] == "resent" for e in log), log
    for e in log:
        if e["outcome"] in ("served", "resent"):
            assert e["epoch"] == e["resident"], e
    assert pool.replicas[0].restarts == 1
    assert any(s.upload_mode == "delta" for sc in scheds for s in sc.history)


def test_partition_forces_full_reseed_on_heal():
    pool = _pool(replicas=2)
    sched = Scheduler(_world(55), decider=PoolClient(pool, "tp"), arena=True)
    sched.run(max_cycles=1, until_idle=False)
    # r1 loses the tenant for one pool cycle: fan-out skips it
    pool.begin_cycle(1)
    pool.partition(1, "tp", cycles=1)
    sched.run(max_cycles=1, until_idle=False)
    assert pool.log_for("tp")[-1]["replica"] == "r0"
    # heal, then force routing onto the stale replica
    pool.begin_cycle(3)
    assert not pool.is_partitioned(1, "tp")
    pool.partition(0, "tp", cycles=1)
    sched.run(max_cycles=1, until_idle=False)
    last = pool.log_for("tp")[-1]
    assert last["replica"] == "r1"
    assert last["outcome"] == "resent", last  # stale base -> full re-seed
    assert last["epoch"] == last["resident"], last
    assert sched.decider.last_mode == "full"


def test_all_replicas_partitioned_is_retryable_unavailable():
    pool = _pool(replicas=2)
    sim = _world(66)
    sched = Scheduler(sim, decider=PoolClient(pool, "tu"), arena=True)
    sched.run(max_cycles=1, until_idle=False)
    pool.partition(0, "tu", cycles=2)
    pool.partition(1, "tu", cycles=2)
    st = build_snapshot(sim.cluster).tensors
    with pytest.raises(PoolUnavailable) as err:
        pool.decide("tu", st, SchedulerConfig.default())
    assert getattr(err.value, "retryable", False) is True
    assert pool.status()["partitions"] == [
        {"replica": "r0", "tenant": "tu", "heal_at_cycle": 2},
        {"replica": "r1", "tenant": "tu", "heal_at_cycle": 2},
    ]


# ---- admission / load shedding ----


def test_admission_sheds_on_sustained_burn_and_recovers():
    clock = [0.0]
    adm = TenantAdmission(
        slo_ms=100.0, budget=0.5, windows=((20.0, 5.0, 1.0),),
        min_samples=4, now_fn=lambda: clock[0],
    )
    pool = _pool(replicas=1, admission=adm, now_fn=lambda: clock[0])
    cfg = SchedulerConfig.default()
    st = _pack(77)
    for _ in range(6):
        clock[0] += 1.0
        adm.observe("hot", 500.0)
    assert adm.should_shed("hot")
    with pytest.raises(PoolShed) as err:
        pool.decide("hot", st, cfg)
    assert getattr(err.value, "retryable", False) is True
    assert pool.shed_log and pool.shed_log[-1]["tenant"] == "hot"
    assert pool.log_for("hot")[-1]["outcome"] == "shed"
    assert not adm.should_shed("cold")
    dec, _ = pool.decide("cold", st, cfg)
    assert dec is not None
    # recovery: the breach rows age out of the windows
    clock[0] += 60.0
    assert not adm.should_shed("hot")
    dec, _ = pool.decide("hot", st, cfg)
    assert dec is not None


# ---- metrics ----


def test_pool_metrics_promtext_conformance():
    from tests.test_obs import check_promtext

    reg = MetricsRegistry()
    clock = [0.0]
    adm = TenantAdmission(
        slo_ms=50.0, budget=0.5, windows=((20.0, 5.0, 1.0),),
        min_samples=2, now_fn=lambda: clock[0],
    )
    pool = _pool(replicas=2, admission=adm, registry=reg, now_fn=lambda: clock[0])
    cfg = SchedulerConfig.default()
    packs = [_pack(81 + i) for i in range(2)]
    pool.decide_many([("m0", packs[0], cfg, None), ("m1", packs[1], cfg, None)])
    for _ in range(4):
        adm.observe("m0", 500.0)
    reqs = pool.decide_many([("m0", packs[0], cfg, None)])
    assert isinstance(reqs[0].error, PoolShed)
    pool.decide_many([("m1", packs[1], cfg, None)])
    text = reg.render()
    check_promtext(text)
    assert 'pool_requests_total{outcome="served",tenant="m0"}' in text
    assert 'pool_requests_total{outcome="shed",tenant="m0"}' in text
    assert "pool_batch_size_bucket" in text
    assert 'pool_replica_inflight{replica="r0"}' in text
    # the port pads nothing and compiles nothing per batch size
    assert reg.gauge_value("pool_batch_occupancy", labels={"bucket": "2"}) == 1.0
    assert reg.counter_value("pool_batch_padding_total", labels={"bucket": "2"}) == 0.0
    assert reg.counter_value("pool_batch_launches_total",
                             labels={"bucket": "2", "compile": "compile"}) == 1.0
    assert reg.counter_value("pool_batch_launches_total",
                             labels={"bucket": "1", "compile": "reuse"}) == 1.0


# ---- failure paths ----


def test_serve_path_error_resolves_requests_with_the_real_error():
    """A failed batched launch resolves every request in the group with
    the actual exception — never strands a tenant on its event wait
    (threaded) or swallows the error (inline)."""
    boom = RuntimeError("launch exploded")
    cfg = SchedulerConfig.default()
    st = _pack(71)
    pool = _pool(replicas=1)
    pool.replicas[0].decide_batch = lambda packs, config: (_ for _ in ()).throw(boom)
    reqs = pool.decide_many([("e0", st, cfg, None)])
    assert reqs[0].error is boom
    assert pool.log_for("e0")[-1]["outcome"] == "error"
    pool2 = _pool(replicas=1, threaded=True, batch_delay_s=0.01)
    pool2.replicas[0].decide_batch = lambda packs, config: (_ for _ in ()).throw(boom)
    with pytest.raises(RuntimeError, match="launch exploded"):
        pool2.decide("e1", st, cfg)
    pool2.close()
    with pytest.raises(PoolUnavailable, match="closed pool"):
        pool2.decide("e1", st, cfg)


def test_cross_partitioned_batch_splits_per_tenant():
    """r0 cut from tenant A and r1 from tenant B must not fail a batch
    holding both — the pool gives up batching, not service."""
    cfg = SchedulerConfig.default()
    pool = _pool(replicas=2)
    pool.partition(0, "A", cycles=5)
    pool.partition(1, "B", cycles=5)
    reqs = pool.decide_many([("A", _pack(72), cfg, None), ("B", _pack(73), cfg, None)])
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    by_tenant = {r.tenant: r for r in reqs}
    assert by_tenant["A"].replica == "r1" and by_tenant["B"].replica == "r0"
    assert all(r.batch == 1 for r in reqs)  # split, not stacked


def test_concurrent_kill_between_fanout_and_resident_reroutes():
    """kill_replica() racing a serve (packs cleared after fan-out)
    reroutes like the fault seam, never a fatal KeyError."""
    cfg = SchedulerConfig.default()
    pool = _pool(replicas=2)
    state = {"raised": False}
    for rep in pool.replicas:
        orig = rep.resident

        def flaky(tenant, _orig=orig):
            if not state["raised"]:
                state["raised"] = True
                raise KeyError(tenant)  # the cleared-packs race window
            return _orig(tenant)

        rep.resident = flaky
    dec, _ = pool.decide("rk", _pack(74), cfg)
    assert dec is not None and state["raised"]
    assert pool.log_for("rk")[-1]["outcome"] in ("served", "resent")


def test_fault_hook_reroutes_a_lost_replica_and_logs_corr_ids():
    """The fault seam: a hook raising _ReplicaLost for r0 moves the group
    to r1; corr ids given with the requests land in the log."""
    from kube_arbitrator_tpu_torch.rpc.pool import _ReplicaLost

    cfg = SchedulerConfig.default()
    seen = []

    def hook(replica, group):
        seen.append(replica.id)
        if replica.index == 0:
            raise _ReplicaLost(0)

    pool = _pool(replicas=2, fault_hook=hook)
    reqs = pool.decide_many([("a", _pack(1), cfg, None, "corr-a"), ("b", _pack(2), cfg, None)])
    assert seen == ["r0", "r1"]
    assert [r.replica for r in reqs] == ["r1", "r1"] and reqs[0].batch == 2
    assert [e["corr"] for e in pool.decision_log] == ["corr-a", None]
    pool.log_drop_served = True
    pool.decide_many([("a", _pack(1), cfg, None)])
    assert len(pool.decision_log) == 2  # the sensitivity seam drops served entries


def test_pool_device_seam_and_unported_fleet(monkeypatch):
    with pytest.raises(ValueError, match="fleet"):
        DecisionPool(fleet=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecisionPool()
    assert DecisionPool(device="cpu").device == torch.device("cpu")


def test_new_modules_import_without_yaml_or_jax():
    """The pool, the seam and the time series import with PyYAML blocked
    and load nothing of JAX or of the JAX package."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import kube_arbitrator_tpu_torch.rpc, kube_arbitrator_tpu_torch.utils.timeseries\n"
        "import kube_arbitrator_tpu_torch.ops.steps\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'kube_arbitrator_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    for rel in ("rpc/pool.py", "rpc/__init__.py", "utils/timeseries.py", "ops/steps.py"):
        tree = ast.parse((REPO / "kube_arbitrator_tpu_torch" / rel).read_text())
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "yaml" for n in names), rel


# ---- one run of the reference pool, repeated by the port's ----


def _script(pkg):
    """One deterministic inline-pool script over two tenants (batches of
    2 only): fresh packs, a delta epoch, a replica kill, a partition with
    its heal, a shed on a fake clock, a failed serve.  ``pkg`` gives the
    package's pool module, packs, configs and PackMeta."""
    mod, pack, conf, meta = pkg
    clock = [0.0]
    adm = mod.TenantAdmission(slo_ms=1e9, budget=0.5, windows=((20.0, 5.0, 1.0),),
                              min_samples=2, now_fn=lambda: clock[0])
    kw = {"device": "cpu"} if mod is not ref_pool else {}
    pool = mod.DecisionPool(replicas=2, threaded=False, admission=adm,
                            now_fn=lambda: clock[0], **kw)
    cfg = conf()
    packs = {"a": pack(1), "b": pack(2)}
    decisions = []

    def flush(epoch, base, tenants=("a", "b")):
        reqs = pool.decide_many([
            (t, packs[t], cfg, meta(f"{t}{epoch}", None if base is None else f"{t}{base}", ()))
            for t in tenants])
        decisions.extend(r.decisions for r in reqs if r.error is None)
        return reqs

    flush(1, None)
    flush(2, 1)
    pool.kill_replica(0)
    flush(3, 2)
    flush(4, 3)
    pool.begin_cycle(1)
    pool.partition(1, "a", cycles=1)
    flush(5, 4)
    pool.begin_cycle(2)
    flush(6, 5)
    clock[0] += 30.0  # the served samples age out of both windows
    for _ in range(3):
        clock[0] += 1.0
        adm.observe("a", 5e9)
    flush(7, 6, ("a",))
    clock[0] += 60.0
    boom = RuntimeError("launch exploded")
    for r in pool.replicas:
        r.decide_batch = lambda packs, config: (_ for _ in ()).throw(boom)
    flush(8, 7)
    log = [{k: e[k] for k in ("tenant", "seq", "cycle", "replica", "outcome", "batch", "epoch",
                              "resident")} for e in pool.decision_log]
    return log, decisions, [dict(r) for r in pool.shed_log]


def test_port_pool_repeats_the_reference_pool():
    ref = _script((ref_pool,
                   lambda s: ref_build_snapshot(_world(s, gen=ref_generate_cluster).cluster).tensors,
                   RefConfig.default, lambda k, b, f: RefPackMeta(k, b, f)))
    port = _script((sys.modules[DecisionPool.__module__], _pack, SchedulerConfig.default,
                    lambda k, b, f: PackMeta(k, b, f)))
    assert port[0] == ref[0]
    assert [e["outcome"] for e in port[0]].count("resent") >= 1
    assert {e["outcome"] for e in port[0]} == {"served", "resent", "shed", "error"}
    assert {e["batch"] for e in port[0] if e["outcome"] != "shed"} == {0, 2}
    assert len(port[1]) == len(ref[1]) == 12
    for i, (a, b) in enumerate(zip(ref[1], port[1])):
        assert np_equal_decisions(b, a), f"request {i}"
    assert port[2] == ref[2]
