"""The port's concurrency sanitizer (kube_arbitrator_tpu_torch/utils/
locking.py) held to the reference's (kube_arbitrator_tpu/utils/
locking.py), on the CPU.

The reference's test_locking.py cases run on both modules: the off path
(stdlib types, ``register_guarded`` a no-op), the witness graph (lock-
order inversions, an expected inversion, RLock reentry, the hold SLO of
``KAT_SANITIZE_HOLD_SLO_MS``, Condition wait / notify) and the guarded
state (lock mode, a rebound container, single-writer mode).  One script
of those calls gives equal witness reports in both packages.

Then the live plane under the sanitizer (``force_sanitize(True)``): each
package's Scheduler over its LiveCache, read through its REST shim
(``serve_api`` on 127.0.0.1, ``HttpApiClient``), schedules two cycles;
the binds, evicts and apiserver event logs are equal, the shim's store
lock is a sanitized lock, LiveCache's fields are guarded in single-writer
mode, and the witness holds no finding until a second thread drains the
watch, which both packages flag on the same fields.
"""
import threading
import time

import pytest
import torch

import chip_smoke as smoke
import kube_arbitrator_tpu.cache.httpapi as ref_httpapi
import kube_arbitrator_tpu_torch.cache.httpapi as port_httpapi
from kube_arbitrator_tpu.utils import locking as ref_locking
from kube_arbitrator_tpu_torch.utils import locking as port_locking
from test_torch_live_plane import make_pod
from test_torch_live_scheduler import PORT, REF, world_gang

LOCKING = {"ref": ref_locking, "port": port_locking}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=["ref", "port"])
def locking(request):
    return LOCKING[request.param]


@pytest.fixture
def sanitized(locking):
    """The shim on with a fresh witness; restored on exit so the rest of
    the suite keeps constructing plain threading locks."""
    prev = locking.force_sanitize(True)
    locking.reset_witness()
    yield locking.witness()
    locking.reset_witness()
    locking.force_sanitize(prev)


def _on_thread(fn, name="kat-test"):
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join()


class _Box:
    def __init__(self):
        self.count = 0
        self.items = {}
        self.rows = []
        self.tags = set()


# ---------------------------------------------------------------- off path


def test_off_path_returns_exact_stdlib_types(locking):
    prev = locking.force_sanitize(False)
    try:
        assert type(locking.Lock("x")) is type(threading.Lock())
        assert type(locking.RLock("x")) is type(threading.RLock())
        assert type(locking.Condition()) is threading.Condition
        assert type(locking.Condition(threading.Lock())) is threading.Condition
    finally:
        locking.force_sanitize(prev)


def test_off_path_register_guarded_is_a_noop(locking):
    prev = locking.force_sanitize(False)
    try:
        b = _Box()
        assert locking.register_guarded(None, b, ("items",)) is b
        assert type(b) is _Box and type(b.items) is dict
        assert not hasattr(b, "_kat_guards")
    finally:
        locking.force_sanitize(prev)


# ---------------------------------------------------------------- witness graph


def test_witness_sees_lock_order_inversion(locking, sanitized):
    a, b = locking.Lock("t.a"), locking.Lock("t.b")

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    _on_thread(fwd)
    _on_thread(rev)
    assert frozenset(("t.a", "t.b")) in sanitized.inversions()
    assert "inversion" in [f["kind"] for f in sanitized.findings]
    assert {"src": "t.a", "dst": "t.b"}.items() <= sanitized.report()["edges"][0].items()


def test_expected_inversion_is_witnessed_but_not_a_finding(locking, sanitized):
    sanitized.expect_inversion("t.a", "t.b")
    a, b = locking.Lock("t.a"), locking.Lock("t.b")
    _on_thread(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
    _on_thread(lambda: (b.acquire(), a.acquire(), a.release(), b.release()))
    assert frozenset(("t.a", "t.b")) in sanitized.inversions()
    assert [f for f in sanitized.findings if f["kind"] == "inversion"] == []


def test_rlock_reentry_adds_no_edges(locking, sanitized):
    outer, r = locking.Lock("t.outer"), locking.RLock("t.re")
    with r:
        with outer:
            with r:  # reentrant: must NOT witness t.outer -> t.re
                pass
    assert ("t.outer", "t.re") not in sanitized.edges
    assert ("t.re", "t.outer") in sanitized.edges


def test_hold_slo_breach_is_flagged(locking, sanitized, monkeypatch):
    monkeypatch.setenv("KAT_SANITIZE_HOLD_SLO_MS", "1")
    lk = locking.Lock("t.slow")
    with lk:
        time.sleep(0.01)
    holds = [f for f in sanitized.findings if f["kind"] == "hold_slo"]
    assert holds and holds[0]["lock"] == "t.slow"


def test_condition_wait_notify_roundtrip(locking, sanitized):
    cond = locking.Condition(name="t.cond")
    ready = []

    def waiter():
        with cond:
            while not ready:
                cond.wait(timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    with cond:
        ready.append(1)
        cond.notify_all()
    t.join(timeout=5)
    assert not t.is_alive()
    # the wait released and re-acquired through the shim without
    # corrupting the per-thread bookkeeping
    assert not sanitized.held_names()


# ---------------------------------------------------------------- guarded state


def test_guard_lock_mode_flags_unlocked_mutation(locking, sanitized):
    lk = locking.Lock("t.guard")
    box = locking.register_guarded(lk, _Box(), ("count", "items"), name="Box")
    with lk:
        box.count = 1  # locked: fine
        box.items["a"] = 1
    box.count = 2  # a rebind without the lock
    box.items["b"] = 2  # a container mutation without the lock
    guards = [f for f in sanitized.findings if f["kind"] == "guard"]
    assert {f["field"] for f in guards} == {"count", "items"}
    assert all(f["lock"] == "t.guard" and f["mode"] == "lock" for f in guards)


def test_guard_rebound_container_stays_wrapped(locking, sanitized):
    lk = locking.Lock("t.rewrap")
    box = locking.register_guarded(lk, _Box(), ("rows",), name="Box")
    with lk:
        box.rows = []  # rebound to a fresh plain list, under the lock
    box.rows.append(1)  # still checked
    assert [f["field"] for f in sanitized.findings if f["kind"] == "guard"] == ["rows"]


def test_guard_single_writer_mode(locking, sanitized):
    box = locking.register_guarded(None, _Box(), ("tags",), name="Box")
    box.tags.add("mine")  # the first mutator claims the box
    _on_thread(lambda: box.tags.add("theirs"))  # any other thread: a finding
    guards = [f for f in sanitized.findings if f["kind"] == "guard"]
    assert [(f["mode"], f["field"]) for f in guards] == [("single-writer", "tags")]


def witness_script(locking) -> dict:
    """The cases above as one script under a fresh witness: the report
    without stacks, thread names and hold times."""
    prev = locking.force_sanitize(True)
    locking.reset_witness()
    try:
        w = locking.witness()
        w.expect_inversion("s.x", "s.y")
        a, b, x, y = (locking.Lock(n) for n in ("s.a", "s.b", "s.x", "s.y"))
        r = locking.RLock("s.re")
        for first, second in ((a, b), (b, a), (x, y), (y, x)):
            _on_thread(lambda f=first, s=second: (f.acquire(), s.acquire(), s.release(),
                                                  f.release()))
        with r:
            with a:
                with r:
                    pass
        lk = locking.Lock("s.guard")
        box = locking.register_guarded(lk, _Box(), ("count", "items", "rows"), name="Box")
        locking.register_guarded(None, box, ("tags",), name="Box")
        with lk:
            box.count = 1
            box.rows = []
        box.items["b"] = 2
        box.rows.append(1)
        box.tags.add("mine")
        _on_thread(lambda: box.tags.add("theirs"))
        rep = w.report()
        return dict(
            edges=[(e["src"], e["dst"], e["count"]) for e in rep["edges"]],
            findings=[{k: v for k, v in f.items() if k not in ("stack", "thread", "held_ms")}
                      for f in rep["findings"]],
            inversions=rep["inversions"], expected=rep["expected_inversions"])
    finally:
        locking.reset_witness()
        locking.force_sanitize(prev)


def test_witness_reports_equal_reference():
    port, ref = witness_script(port_locking), witness_script(ref_locking)
    assert port == ref
    assert [f["kind"] for f in port["findings"]] == ["inversion", "guard", "guard", "guard"]


# ---------------------------------------------------------------- the live plane


def sanitized_live_run(m, locking, httpapi) -> dict:
    """``world_gang`` in package ``m``'s FakeApiServer behind its REST
    shim, with ``locking``'s sanitizer on: the Scheduler over
    LiveCache(HttpApiClient) for two cycles on the main thread, then one
    more pod and a watch drain on a second thread.  Returns what the run
    decided and what the witness saw."""
    objs, actions, *_ = world_gang()
    prev = locking.force_sanitize(True)
    locking.reset_witness()
    api = m.cache.FakeApiServer()
    smoke.load_objects(api, objs)
    server, thread, url = httpapi.serve_api(api, "127.0.0.1", 0)
    try:
        assert type(server.api_lock) is locking.SanLock
        live = m.cache.LiveCache(httpapi.HttpApiClient(url, timeout_s=10.0))
        assert set(live._kat_guards) >= {"cluster", "events", "resync_queue", "_task_by_uid"}
        conf = m.framework.SchedulerConfig(actions=tuple(actions), tiers=m.tiers)
        sched = m.framework.Scheduler(live, config=conf, decider=m.decider(),
                                      arena=m.cache.SnapshotArena(live, verify_every=1))
        cycles = []
        for _ in range(2):
            m.snapshot.set_sticky_buckets(True)
            r = sched.run_once()
            cycles.append(([(b.task_uid, b.node_name) for b in r.binds],
                           [e.task_uid for e in r.evicts]))
        clean = list(locking.witness().findings)
        api.create("pods", make_pod("late", group="pg1"))
        drained = []
        _on_thread(lambda: drained.append(live.sync()), name="second-pump")
        rep = locking.witness().report()
        return dict(cycles=cycles, event_log=api.event_log, clean=clean, drained=drained,
                    edges=[(e["src"], e["dst"]) for e in rep["edges"]],
                    late=sorted((f["kind"], f["obj"], f["field"], f["mode"], f["thread"])
                                for f in rep["findings"]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()
        locking.reset_witness()
        locking.force_sanitize(prev)


def test_live_plane_under_sanitizer_matches_reference():
    port = sanitized_live_run(PORT, port_locking, port_httpapi)
    ref = sanitized_live_run(REF, ref_locking, ref_httpapi)
    assert port == ref
    assert sum(len(b) for b, _ in port["cycles"]) > 0
    assert port["clean"] == [] and port["drained"][0] > 0
    fields = {f[2] for f in port["late"]}
    assert {"_task_by_uid", "_raw_pod"} <= fields
    assert {f[1:] for f in port["late"]} == {("LiveCache", f, "single-writer", "second-pump")
                                             for f in fields}
