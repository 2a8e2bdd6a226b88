"""Leader election in the port (``kube_arbitrator_tpu_torch.framework.leader``)
and the port Scheduler's lease gating, on the CPU with an injected clock
(nothing here sleeps).

* The reference's tests/test_leader.py cases on the port: first
  contender wins, renewal, observer-local expiry and takeover, the renew
  deadline, release, timing validation, the scheduler gated on the
  lease, the commit fence (a usurped lease discards the cycle with
  nothing POSTed; a slow cycle revalidates and actuates; a transient
  storage error fails revalidation).
* A port elector and a reference elector on one lock file: exactly one
  leads and each reads the other's record.
* ``ApiLeaderElector`` over the port's ``FakeApiServer``: the lease as a
  ConfigMap, CAS races, compare-and-delete release, ``usurp_lease``.
* ``run()`` raises ``LeaderLost`` when a renew fails; the run loop counts
  ``cycle_errors_total{class}`` and retries an ``ApiError``.
* ``classify_cycle_error`` gives the reference's class for each error.
"""
import json

import pytest
import torch

import kube_arbitrator_tpu.cache.arena as ref_arena
import kube_arbitrator_tpu.cache.fakeapi as ref_fakeapi
import kube_arbitrator_tpu.framework.scheduler as ref_scheduler
import kube_arbitrator_tpu.framework.leader as ref_leader
from kube_arbitrator_tpu_torch.cache import ArenaDivergence, FakeApiServer, LiveCache, SimCluster
from kube_arbitrator_tpu_torch.cache.fakeapi import ApiError, GoneError
from kube_arbitrator_tpu_torch.framework import (
    ApiLeaderElector, LeaderElector, LeaderLost, Scheduler, TorchDecider, TransientLockError,
    classify_cycle_error)
from kube_arbitrator_tpu_torch.framework import leader as port_leader
from kube_arbitrator_tpu_torch.utils.metrics import metrics

GB = 1024**3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _elector(path, ident, clock, **kw):
    return LeaderElector(str(path), identity=ident, now_fn=clock, **kw)


def _one_task_sim():
    sim = SimCluster()
    sim.add_queue("default")
    sim.add_node("n1", cpu_milli=4000, memory=8 * GB)
    job = sim.add_job("j1")
    sim.add_task(job, cpu_milli=500, memory=GB)
    return sim


def _slow_decider(clock, dt, mid_decision=None):
    """A CPU TorchDecider whose decision 'takes' ``dt`` seconds on the
    fake clock (a stalled cycle), optionally running a callback in the
    middle (a standby taking the lease)."""

    class Wedged(TorchDecider):
        def decide(self, st, config, pack_meta=None):
            out = super().decide(st, config, pack_meta)
            clock.t += dt
            if mid_decision is not None:
                mid_decision()
            return out

    return Wedged("cpu")


# ---------------------------------------------------------------- the reference's cases


def test_first_contender_wins_second_waits(tmp_path):
    clock = FakeClock()
    a, b = _elector(tmp_path / "kb.lock", "a", clock), _elector(tmp_path / "kb.lock", "b", clock)
    assert a.try_acquire()
    assert not b.try_acquire()
    assert a.is_leader and not b.is_leader


def test_renewal_keeps_lease_alive(tmp_path):
    clock = FakeClock()
    a = _elector(tmp_path / "kb.lock", "a", clock, lease_duration_s=15, renew_deadline_s=10)
    b = _elector(tmp_path / "kb.lock", "b", clock)
    assert a.try_acquire()
    for _ in range(10):
        clock.t += 5.0
        assert a.renew()
        assert not b.try_acquire()


def test_stale_lease_taken_over_on_the_observers_clock(tmp_path):
    clock = FakeClock()
    a = _elector(tmp_path / "kb.lock", "a", clock, lease_duration_s=15)
    b = _elector(tmp_path / "kb.lock", "b", clock)
    assert a.try_acquire()
    clock.t += 16.0
    assert not b.try_acquire()  # b first observes the record now
    clock.t += 16.0
    assert b.try_acquire()
    assert not a.renew() and not a.is_leader


def test_renew_deadline_is_fatal_even_without_usurper(tmp_path):
    clock = FakeClock()
    a = _elector(tmp_path / "kb.lock", "a", clock, lease_duration_s=30, renew_deadline_s=10)
    assert a.try_acquire()
    clock.t += 11.0
    assert not a.renew()


def test_release_hands_over_immediately(tmp_path):
    clock = FakeClock()
    a, b = _elector(tmp_path / "kb.lock", "a", clock), _elector(tmp_path / "kb.lock", "b", clock)
    assert a.try_acquire()
    a.release()
    assert b.try_acquire()


@pytest.mark.parametrize("cls", [LeaderElector, ApiLeaderElector])
def test_timing_ordering_validated(cls, tmp_path):
    first = str(tmp_path / "lock") if cls is LeaderElector else FakeApiServer()
    with pytest.raises(ValueError, match="lease_duration"):
        cls(first, lease_duration_s=10.0, renew_deadline_s=10.0)
    with pytest.raises(ValueError, match="renew_deadline"):
        cls(first, lease_duration_s=15.0, renew_deadline_s=5.0, retry_period_s=5.0)
    with pytest.raises(ValueError, match="retry_period"):
        cls(first, lease_duration_s=15.0, renew_deadline_s=10.0, retry_period_s=0.0)


def test_scheduler_gated_on_leadership_and_loss_is_fatal(tmp_path):
    clock = FakeClock()
    leader = _elector(tmp_path / "kb.lock", "leader", clock)
    standby = _elector(tmp_path / "kb.lock", "standby", clock)
    assert leader.try_acquire()
    sim = _one_task_sim()
    assert not standby.acquire_blocking(timeout_s=0.0)
    sched = Scheduler(sim, decider=TorchDecider("cpu"), elector=leader)
    sched.run(max_cycles=1)
    assert len(sim.binder.binds) == 1
    clock.t += 100.0
    assert standby.try_acquire()
    with pytest.raises(LeaderLost):
        sched.run(max_cycles=1)


def test_acquire_blocking_waits_on_the_injected_sleep(tmp_path):
    """RunOrDie's loop: the standby retries every retry period (on the
    injected sleep, which advances the fake clock) until the holder's
    record has gone unchanged for a full lease."""
    clock = FakeClock()
    holder = _elector(tmp_path / "kb.lock", "holder", clock)
    standby = _elector(tmp_path / "kb.lock", "standby", clock)
    assert holder.try_acquire()
    slept = []

    def sleep(dt):
        slept.append(dt)
        clock.t += dt

    standby.sleep = sleep
    assert standby.acquire_blocking(timeout_s=60.0)
    assert slept == [5.0] * 3 and clock.t == 15.0


def test_slow_cycle_revalidates_against_storage_and_actuates(tmp_path):
    clock = FakeClock()
    leader = _elector(tmp_path / "kb.lock", "leader", clock,
                      lease_duration_s=15, renew_deadline_s=10)
    assert leader.try_acquire()
    sim = _one_task_sim()
    before = metrics().counter_value("leader_fence_revalidations_total",
                                     {"outcome": "renewed"})
    sched = Scheduler(sim, elector=leader, decider=_slow_decider(clock, 12.0))
    sched.run(max_cycles=1)
    assert len(sim.binder.binds) == 1
    assert leader.is_leader
    assert metrics().counter_value("leader_fence_revalidations_total",
                                   {"outcome": "renewed"}) == before + 1


def test_usurped_lease_after_decision_discards_cycle(tmp_path):
    clock = FakeClock()
    leader = _elector(tmp_path / "kb.lock", "leader", clock)
    standby = _elector(tmp_path / "kb.lock", "standby", clock)
    assert leader.try_acquire()
    sim = _one_task_sim()

    def standby_takes_over():
        assert not standby.try_acquire()
        clock.t += 20.0
        assert standby.try_acquire()

    before = metrics().counter_value("leader_fence_revalidations_total", {"outcome": "lost"})
    sched = Scheduler(sim, elector=leader, decider=_slow_decider(clock, 20.0, standby_takes_over))
    with pytest.raises(LeaderLost, match="not actuated"):
        sched.run(max_cycles=1)
    assert sim.binder.binds == {}
    assert not leader.is_leader and sched.history == []
    assert metrics().counter_value("leader_fence_revalidations_total",
                                   {"outcome": "lost"}) == before + 1


def test_usurped_lease_posts_nothing_to_the_apiserver(tmp_path):
    """The fence over a LiveCache: after a usurped lease the apiserver
    sees no bind POST, no status PUT and no condition PATCH."""
    clock = FakeClock()
    leader = _elector(tmp_path / "kb.lock", "leader", clock)
    standby = _elector(tmp_path / "kb.lock", "standby", clock)
    assert leader.try_acquire()
    api = FakeApiServer()
    api.create("nodes", {"metadata": {"name": "n0"},
                         "status": {"allocatable": {"cpu": "4", "memory": "8Gi"}}})
    api.create("queues", {"metadata": {"name": "default"}, "spec": {"weight": 1}})
    api.create("podgroups", {"metadata": {"name": "pg", "namespace": "default"},
                             "spec": {"minMember": 1}})
    for i in range(3):
        api.create("pods", {
            "metadata": {"name": f"p{i}", "namespace": "default", "uid": f"p{i}",
                         "annotations": {"scheduling.k8s.io/group-name": "pg"}},
            "spec": {"schedulerName": "kube-batch",
                     "containers": [{"resources": {"requests": {"cpu": "1"}}}]},
            "status": {"phase": "Pending"}})

    def standby_takes_over():
        assert not standby.try_acquire()
        clock.t += 20.0
        assert standby.try_acquire()

    live = LiveCache(api)
    sched = Scheduler(live, elector=leader, decider=_slow_decider(clock, 20.0, standby_takes_over),
                      arena=True)
    rv = api.list("pods")[1]
    with pytest.raises(LeaderLost):
        sched.run(max_cycles=1)
    assert api.list("pods")[1] == rv
    assert all(not p["spec"].get("nodeName") for p in api.list("pods")[0])
    standby_sched = Scheduler(LiveCache(api), elector=standby, decider=TorchDecider("cpu"))
    standby_sched.run(max_cycles=1)
    assert all(p["spec"].get("nodeName") == "n0" for p in api.list("pods")[0])


def test_revalidate_fails_on_transient_storage_error(tmp_path, monkeypatch):
    clock = FakeClock()
    leader = _elector(tmp_path / "kb.lock", "leader", clock)
    assert leader.try_acquire()
    clock.t += 12.0

    def boom():
        raise TransientLockError("storage unreachable")

    monkeypatch.setattr(leader, "_fetch", boom)
    assert not leader.revalidate()
    assert not leader.is_leader


def test_run_raises_leader_lost_when_renew_fails(tmp_path):
    """A lease the holder cannot renew (its renew deadline passed between
    runs) ends ``run`` with LeaderLost before any cycle; a supervisor
    that re-acquires can run again."""
    clock = FakeClock()
    leader = _elector(tmp_path / "kb.lock", "leader", clock)
    sim = _one_task_sim()
    sched = Scheduler(sim, decider=TorchDecider("cpu"), elector=leader)
    sched.run(max_cycles=1)
    assert leader.is_leader and len(sched.history) == 1
    clock.t += 11.0
    with pytest.raises(LeaderLost, match="lease lost"):
        sched.run(max_cycles=1)
    assert len(sched.history) == 1
    assert leader.try_acquire()  # the record is still ours
    sched.run(max_cycles=1)
    assert len(sched.history) == 2


def test_run_counts_and_retries_apiserver_errors():
    """An ApiError kills the cycle, is retryable, and counts in
    cycle_errors_total{class="retryable"}; past max_cycle_retries in a
    row the loop re-raises."""
    sim = _one_task_sim()
    s = Scheduler(sim, decider=TorchDecider("cpu"), max_cycle_retries=2)
    calls = []

    def conflict():
        calls.append(1)
        raise ApiError("pods conflict", status=409)

    s.run_once = conflict
    before = metrics().counter_value("cycle_errors_total", {"class": "retryable"})
    assert s.run(max_cycles=2) == 2
    with pytest.raises(ApiError):
        s.run(max_cycles=10)
    assert len(calls) == 5
    assert metrics().counter_value("cycle_errors_total", {"class": "retryable"}) == before + 5


def test_wait_for_event_seam_keeps_an_idle_loop_alive():
    """An idle cycle calls wait_for_event: True keeps scheduling, False
    ends the loop (a LiveCache's event_waiter over a fake clock)."""
    api = FakeApiServer()
    api.create("queues", {"metadata": {"name": "default"}, "spec": {"weight": 1}})
    clock = FakeClock()
    live = LiveCache(api, now_fn=clock)

    def sleep(dt):
        clock.t += dt
        if clock.t == 1.0:  # a node and a pod arrive while the loop waits
            api.create("nodes", {"metadata": {"name": "n0"},
                                 "status": {"allocatable": {"cpu": "4", "memory": "8Gi"}}})
            api.create("pods", {
                "metadata": {"name": "p0", "namespace": "default", "uid": "p0"},
                "spec": {"schedulerName": "kube-batch",
                         "containers": [{"resources": {"requests": {"cpu": "1"}}}]},
                "status": {"phase": "Pending"}})

    s = Scheduler(live, decider=TorchDecider("cpu"),
                  wait_for_event=live.event_waiter(timeout_s=5.0, poll_s=0.5, sleep_fn=sleep))
    assert s.run() == 3  # idle, the pod bound, idle until the timeout
    assert [h.binds for h in s.history] == [0, 1, 0]
    assert api.get("pods", "default", "p0")["spec"]["nodeName"] == "n0"


# ---------------------------------------------------------------- across packages


def test_port_and_reference_electors_exclude_each_other(tmp_path):
    """One lock file, one LeaseRecord JSON: whichever package acquires
    first leads, the other reads its record and waits; after a release
    the other takes it."""
    clock = FakeClock(100.0)
    lock = str(tmp_path / "kb.lock")
    port = LeaderElector(lock, identity="port", now_fn=clock)
    ref = ref_leader.LeaderElector(lock, identity="ref", now_fn=clock)
    assert port.try_acquire() and not ref.try_acquire()
    with open(lock) as f:
        rec = json.load(f)
    assert rec == dict(holder="port", acquired_ts=100.0, renew_ts=100.0, lease_duration_s=15.0)
    assert ref_leader.LeaseRecord.from_json(json.dumps(rec)).holder == "port"
    assert port_leader.LeaseRecord.from_json(ref_leader.LeaseRecord(**rec).to_json()) == \
        port_leader.LeaseRecord(**rec)
    port.release()
    assert ref.try_acquire() and not port.try_acquire()
    clock.t += 5.0
    assert ref.renew() and not port.try_acquire()
    clock.t += 16.0  # the record unchanged past a lease on port's clock
    assert port.try_acquire()
    assert not ref.renew()


def test_api_elector_over_the_port_apiserver():
    """The ConfigMap resourcelock on the port's FakeApiServer: first
    contender wins, a CAS race has one winner, release is
    compare-and-delete, usurp_lease hands the lease over, and a
    reference elector on the same server reads the same record."""
    api = FakeApiServer()
    clock = FakeClock()
    a = ApiLeaderElector(api, identity="a", now_fn=clock)
    b = ApiLeaderElector(api, identity="b", now_fn=clock)
    r = ref_leader.ApiLeaderElector(api, identity="r", now_fn=clock)
    assert a.try_acquire() and not b.try_acquire() and not r.try_acquire()
    cm = api.get("configmaps", "kube-system", port_leader.LOCK_CONFIGMAP)
    assert json.loads(cm["metadata"]["annotations"][port_leader.LEASE_ANNOTATION])["holder"] == "a"
    # a stale CAS loses: b pushes against an rv that a's renew moved
    token, _ = b._fetch()
    clock.t += 5.0
    assert a.renew()
    assert not b._push(token, port_leader.LeaseRecord("b", 5.0, 5.0, 15.0))
    # release deletes only a record that is still ours
    stale, _ = a._fetch()
    a.release()
    assert api.get("configmaps", "kube-system", port_leader.LOCK_CONFIGMAP) is None
    assert b.try_acquire()
    a._delete(stale)  # a stale ex-leader's delete is refused (409), silently
    assert api.get("configmaps", "kube-system", port_leader.LOCK_CONFIGMAP) is not None
    rec = port_leader.usurp_lease(api, "a", clock.t)
    assert rec.holder == "a"
    assert not b.renew() and a.try_acquire()
    clock.t += 20.0
    assert not b.revalidate()


def test_api_elector_transient_outage_keeps_grace():
    class Down:
        def get(self, *a):
            raise ApiError("apiserver unreachable", status=503)

    clock = FakeClock()
    api = FakeApiServer()
    e = ApiLeaderElector(api, identity="a", now_fn=clock)
    assert e.try_acquire()
    e.api = Down()
    clock.t += 5.0
    assert e.renew()  # within the renew deadline: a blip
    clock.t += 6.0
    assert not e.renew()
    assert not e.try_acquire()


def test_classify_cycle_error_matches_reference():
    """Each package's classifier on its own errors: the same class."""
    pairs = [
        (LeaderLost("x"), ref_leader.LeaderLost("x")),
        (ApiError("x", 409), ref_fakeapi.ApiError("x", 409)),
        (GoneError("x"), ref_fakeapi.GoneError("x")),
        (TransientLockError("x"), ref_leader.TransientLockError("x")),
        (TimeoutError("x"), TimeoutError("x")),
        (ConnectionError("x"), ConnectionError("x")),
        (ArenaDivergence("x"), ref_arena.ArenaDivergence("x")),
        (AssertionError("x"), AssertionError("x")),
        (TypeError("decision contract"), TypeError("decision contract")),
        (ValueError("x"), ValueError("x")),
    ]
    got = [classify_cycle_error(p) for p, _ in pairs]
    assert got == [ref_scheduler.classify_cycle_error(r) for _, r in pairs]
    assert got == ["fatal", "retryable", "retryable", "retryable", "retryable", "retryable",
                   "fatal", "fatal", "fatal", "fatal"]
    err = RuntimeError("self-classified")
    err.retryable = True
    assert classify_cycle_error(err) == ref_scheduler.classify_cycle_error(err) == "retryable"
