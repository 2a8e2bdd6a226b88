"""The port's Scheduler over its LiveCache held against the JAX package's
Scheduler over the reference's LiveCache, on the CPU: the port with
``TorchDecider("cpu")``, the reference with its ``LocalDecider`` handed
the host pack (tests/test_torch_scheduler.py's ``HostPackLocalDecider``).

Worlds: the reference's live scenarios (test_live_cache.py: a gang
cluster, the bind failure diverted to the errTasks resync and repaired,
the evict world of :154), each with and without the arena, and one world
of chip_smoke.py phase 11's helper at 64 nodes x 16 jobs x 8 tasks,
evictive, 3 cycles with the arena, the phase's apiserver-side kubelet
step and priority burst between cycles.  Every cycle must bind and evict
alike, with equal PodGroup statuses, pod conditions and failed
actuations and equal packs; after every cycle the two apiservers' event
logs (every bind POST, evict DELETE, status PUT and condition PATCH, in
order, with its resource version) and the caches' recorded events must
be equal.

Also: ``python -m kube_arbitrator_tpu_torch --watch-stream F --device cpu
--cycles 2 --json`` (in a process where ``jax`` and
``kube_arbitrator_tpu`` cannot be imported) against the reference CLI on
the same recorded stream, and (``-m slow``) phase 11's worlds (a) and
(b) at full width, whose cycle 1 gives chip_smoke.py's LIVE_A_42 /
LIVE_B_42.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import chip_smoke as smoke
import kube_arbitrator_tpu.cache as ref_cache
import kube_arbitrator_tpu.cache.snapshot as ref_snapshot
import kube_arbitrator_tpu.framework as ref_framework
import kube_arbitrator_tpu.ops.ordering as ref_ordering
import kube_arbitrator_tpu.options as ref_options
import kube_arbitrator_tpu_torch.cache as port_cache
import kube_arbitrator_tpu_torch.cache.snapshot as port_snapshot
import kube_arbitrator_tpu_torch.framework as port_framework
import kube_arbitrator_tpu_torch.ops.ordering as port_ordering
import kube_arbitrator_tpu_torch.options as port_options
from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
from test_torch_host_pack import assert_packs_equal
from test_torch_live_plane import make_node, make_pod, make_podgroup, queue
from test_torch_scheduler import HostPackLocalDecider, statuses

REPO = Path(__file__).resolve().parent.parent
FULL = ("reclaim", "allocate", "backfill", "preempt")


def _pkg(cache, snapshot, framework, tiers, options, decider):
    return types.SimpleNamespace(cache=cache, snapshot=snapshot, framework=framework,
                                 tiers=tiers, options=options, decider=decider)


REF = _pkg(ref_cache, ref_snapshot, ref_framework, ref_ordering.DEFAULT_TIERS, ref_options,
           HostPackLocalDecider)
PORT = _pkg(port_cache, port_snapshot, port_framework, port_ordering.DEFAULT_TIERS,
            port_options, lambda: port_framework.TorchDecider("cpu"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_state():
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)
        m.options.reset_options()
    yield
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)
        m.options.reset_options()


# ---------------------------------------------------------------- worlds
# each: (objects, actions, cycles, between(api, cycle, since_rv) or None)


def world_gang():
    objs = [("nodes", make_node(f"n{i}")) for i in range(2)]
    objs += [("queues", queue("default")), ("podgroups", make_podgroup("pg1", min_member=3))]
    objs += [("pods", make_pod(f"p{i}", group="pg1")) for i in range(4)]
    # a second gang that cannot fit until the first one's pods are gone
    objs += [("podgroups", make_podgroup("pg2", min_member=3, ts=2.0))]
    objs += [("pods", make_pod(f"q{i}", group="pg2", cpu="2")) for i in range(4)]

    def between(api, cycle, since):
        if cycle == 1:
            for i in range(4):
                api.delete("pods", "default", f"p{i}")
    return objs, ("allocate", "backfill"), 3, between


def world_bind_failure():
    objs = [("nodes", make_node(f"n{i}")) for i in range(2)]
    objs += [("queues", queue("default")), ("podgroups", make_podgroup("pg1", min_member=1))]
    objs += [("pods", make_pod(f"p{i}", group="pg1")) for i in range(2)]

    def between(api, cycle, since):
        api.fail_bind_uids.clear()
    return objs, ("allocate", "backfill"), 2, between, {"uid-default-p0"}


def world_evict():
    objs = [("nodes", make_node("n0", cpu="4")), ("queues", queue("qa")), ("queues", queue("qb")),
            ("podgroups", make_podgroup("victims", min_member=0, queue="qa")),
            ("podgroups", make_podgroup("claimer", min_member=1, queue="qb"))]
    objs += [("pods", make_pod(f"v{i}", group="victims", cpu="1", memory="256Mi", node="n0",
                               phase="Running")) for i in range(4)]
    objs += [("pods", make_pod("c0", group="claimer", cpu="1", memory="256Mi"))]
    return objs, FULL, 2, None


def world_phase11():
    world = smoke.LIVE_C
    objs = smoke.cluster_objects(generate_cluster(**dict(world, running_fraction=0.5)),
                                 "kube-batch")

    def between(api, cycle, since):
        smoke.live_kubelet_step(api, since, cycle, 0.04)
        if cycle == 2:
            smoke.live_burst(api, world["num_queues"], world["num_nodes"], "kube-batch")
    return objs, FULL, 3, between


def run_world(m, world, arena):
    objs, actions, cycles, between, *fail = world()
    api = m.cache.FakeApiServer()
    smoke.load_objects(api, objs)
    if fail:
        api.fail_bind_uids = set(fail[0])
    live = m.cache.LiveCache(api)
    conf = m.framework.SchedulerConfig(actions=tuple(actions), tiers=m.tiers)
    a = m.cache.SnapshotArena(live, verify_every=1) if arena else None
    sched = m.framework.Scheduler(live, config=conf, decider=m.decider(), arena=a)
    for c in range(1, cycles + 1):
        m.snapshot.set_sticky_buckets(True)
        since = api.list("pods")[1]
        r = sched.run_once()
        yield c, r, api, live
        if between is not None:
            between(api, c, since)


CASES = [(w, a) for w in (world_gang, world_bind_failure, world_evict) for a in (True, False)]
CASES.append((world_phase11, True))  # with the arena, as phase 11 runs it


@pytest.mark.parametrize("world,arena", CASES,
                         ids=[f"{w.__name__[6:]}-{'arena' if a else 'rebuild'}" for w, a in CASES])
def test_live_scheduler_matches_reference(world, arena):
    binds = evicts = 0
    for (c, rr, rapi, rlive), (_, rp, papi, plive) in zip(run_world(REF, world, arena),
                                                          run_world(PORT, world, arena)):
        ctx = f"cycle {c}: "
        assert [(b.task_uid, b.node_name) for b in rp.binds] == [
            (b.task_uid, b.node_name) for b in rr.binds], ctx
        assert [e.task_uid for e in rp.evicts] == [e.task_uid for e in rr.evicts], ctx
        assert statuses(rp.job_status) == statuses(rr.job_status), ctx
        assert rp.task_conditions == rr.task_conditions, ctx
        assert rp.failed_actuations == rr.failed_actuations, ctx
        assert_packs_equal(rr.snapshot, rp.snapshot, ctx)
        assert papi.event_log == rapi.event_log, ctx
        assert [tuple(vars(e).values()) for e in plive.events] == [
            tuple(vars(e).values()) for e in rlive.events], ctx
        assert plive.resync_queue == rlive.resync_queue, ctx
        binds, evicts = binds + len(rp.binds), evicts + len(rp.evicts)
    if world is not world_evict:  # its claimer stays pipelined, in both packages
        assert binds > 0
    if world in (world_evict, world_phase11):
        assert evicts > 0
    if world is world_bind_failure:
        assert any(e.kind == "FailedScheduling" for e in plive.events)
        assert all(p["spec"]["nodeName"] for p in papi.list("pods")[0])
    if world is world_gang:  # the second gang binds once the first one's pods finished
        assert all(papi.get("pods", "default", f"q{i}")["spec"]["nodeName"] for i in range(4))
        assert papi.get("podgroups", "default", "pg2")["status"]["phase"] == "Running"


def test_cli_watch_stream_matches_reference(tmp_path, capsys):
    """The same recorded stream through both command lines: equal binds;
    the port's CLI imports neither jax nor the JAX package."""
    objs, *_ = world_gang()
    api = port_cache.FakeApiServer()
    smoke.load_objects(api, objs)
    path = str(tmp_path / "stream.jsonl")
    api.dump_stream(path)
    from kube_arbitrator_tpu.cli import main as ref_main

    assert ref_main(["--watch-stream", path, "--cycles", "2", "--json"]) == 0
    ref_last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
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
    metrics_file = tmp_path / "metrics.prom"
    out = subprocess.run(
        [sys.executable, "-c", code, "--watch-stream", path, "--device", "cpu", "--cycles", "2",
         "--json", "--enable-leader-election", "--lock-object-namespace", str(tmp_path / "lock"),
         "--metrics-file", str(metrics_file)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    assert rows[-1]["binds"] == ref_last["binds"] == 4
    assert rows[-1]["cycles"] == ref_last["cycles"] == 2
    assert [r["upload_mode"] for r in rows[:-1]] == ["full", "delta"]
    assert (tmp_path / "lock" / "kube-batch.lock").exists()
    text = metrics_file.read_text()
    assert "kube_arbitrator_tpu_binds_total 4" in text
    assert 'kube_arbitrator_tpu_cache_watch_events_total{phase="list"}' in text
    bad = subprocess.run(
        [sys.executable, "-m", "kube_arbitrator_tpu_torch", "--watch-stream", path, "--device",
         "cpu", "--enable-leader-election"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert bad.returncode != 0 and "lock_object_namespace" in bad.stderr


@pytest.mark.slow
@pytest.mark.parametrize("which", ["a", "b"])
def test_live_constants_from_reference(which):
    """Cycle 1 of phase 11's worlds at full width, chip_smoke.py's
    cluster_objects in each package's FakeApiServer and LiveCache, the
    arena on: prints the record chip_smoke.py holds as LIVE_A_42 /
    LIVE_B_42; the port's CPU run must equal the reference's."""
    world, actions = ((smoke.SCHED_A, ("allocate", "backfill")) if which == "a"
                      else (smoke.SCHED_B, FULL))
    objs = smoke.cluster_objects(generate_cluster(**world), "kube-batch")
    recs = []
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)
        api = m.cache.FakeApiServer()
        smoke.load_objects(api, objs)
        live = m.cache.LiveCache(api)
        conf = m.framework.SchedulerConfig(actions=tuple(actions), tiers=m.tiers)
        sched = m.framework.Scheduler(live, config=conf, decider=m.decider(),
                                      arena=m.cache.SnapshotArena(live))
        recs.append(smoke.cycle_record(sched.run_once()))
    print(f"\nlive world ({which}) cycle 1: reference {recs[0]}, port {recs[1]}")
    assert recs[1] == recs[0]
    assert recs[0] == (smoke.LIVE_A_42 if which == "a" else smoke.LIVE_B_42)
