"""The port's host plane held against the JAX package, on the CPU: the
object model (``api/``), ``cache/sim.SimCluster`` and ``generate_cluster``,
the pack builder ``cache/snapshot.build_snapshot``, the arena's delta
path (``cache/arena.SnapshotArena``) and ``framework/conf``.

Each case applies one recipe of ``SimCluster`` calls to both packages'
clusters (``both``, a test helper) and compares.  Packs are integers or
integral device units below 2^24, so every comparison is exact: every
pack field in name, dtype, shape and bits, and the snapshot index's
order.  Both packages' sticky-bucket memos are cleared before each case
(``fresh_buckets``), so they see the same sequence of builds.
"""
import dataclasses
import types

import numpy as np
import pytest

import kube_arbitrator_tpu.api as ref_api
import kube_arbitrator_tpu.cache.arena as ref_arena
import kube_arbitrator_tpu.cache.decode as ref_decode
import kube_arbitrator_tpu.cache.sim as ref_sim
import kube_arbitrator_tpu.cache.snapshot as ref_snapshot
import kube_arbitrator_tpu.framework.conf as ref_conf
import kube_arbitrator_tpu_torch.api as port_api
import kube_arbitrator_tpu_torch.cache.arena as port_arena
import kube_arbitrator_tpu_torch.cache.decode as port_decode
import kube_arbitrator_tpu_torch.cache.sim as port_sim
import kube_arbitrator_tpu_torch.cache.snapshot as port_snapshot
import kube_arbitrator_tpu_torch.framework.conf as port_conf

GB = 1024**3
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _pkg(api, sim, snapshot, arena, decode, conf):
    return types.SimpleNamespace(
        api=api, sim=sim, snapshot=snapshot, arena=arena, decode=decode, conf=conf,
        SimCluster=sim.SimCluster, generate_cluster=sim.generate_cluster,
        TaskStatus=api.TaskStatus, Taint=api.Taint, Toleration=api.Toleration,
        MatchExpression=api.MatchExpression, PodAffinityTerm=api.PodAffinityTerm,
    )


REF = _pkg(ref_api, ref_sim, ref_snapshot, ref_arena, ref_decode, ref_conf)
PORT = _pkg(port_api, port_sim, port_snapshot, port_arena, port_decode, port_conf)


@pytest.fixture(autouse=True)
def fresh_buckets():
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)
    yield
    for m in (REF, PORT):
        m.snapshot.set_sticky_buckets(True)


def both(recipe, *args):
    """``recipe(pkg, *args)`` applied to each package: (reference result,
    port result)."""
    return recipe(REF, *args), recipe(PORT, *args)


def pack_fields(st):
    return [f.name for f in dataclasses.fields(st)]


def assert_packs_equal(ref_snap, port_snap, ctx=""):
    """Every pack field equal in name, dtype, shape and bits, and the
    snapshot index in the same order."""
    a, b = ref_snap.tensors, port_snap.tensors
    assert pack_fields(a) == pack_fields(b), ctx
    for name in pack_fields(a):
        x, y = getattr(a, name), getattr(b, name)
        if name == "rv_window":
            assert isinstance(y, int) and x == y, f"{ctx}{name}: {x} vs {y}"
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert isinstance(getattr(b, name), (np.ndarray, np.generic)), f"{ctx}{name} is not host numpy"
        assert x.dtype == y.dtype and x.shape == y.shape, (
            f"{ctx}{name}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}")
        assert x.tobytes() == y.tobytes(), f"{ctx}{name} differs"
    ri, pi = ref_snap.index, port_snap.index
    assert [t.uid for t in ri.tasks] == [t.uid for t in pi.tasks], ctx
    assert [t.ordinal for t in ri.tasks] == [t.ordinal for t in pi.tasks], ctx
    assert [n.name for n in ri.nodes] == [n.name for n in pi.nodes], ctx
    assert [j.uid for j in ri.jobs] == [j.uid for j in pi.jobs], ctx
    assert [q.uid for q in ri.queues] == [q.uid for q in pi.queues], ctx
    assert list(ri.port_universe) == list(pi.port_universe), ctx


def cluster_state(sim):
    """A package-neutral picture of a SimCluster: every task's identity,
    status, node and request; every node's accounting and resident pods
    in insertion order; queues, others, the binder's and evictor's
    records, resync queue, events and pod conditions."""
    c = sim.cluster
    return dict(
        jobs=[(j.uid, j.queue_uid, j.min_available, j.priority, j.creation_ts,
               [(t.uid, int(t.status), t.node_name, t.resreq.tolist(), t.priority)
                for t in j.tasks.values()]) for j in c.jobs.values()],
        nodes=[(n.name, n.idle.tolist(), n.used.tolist(), n.releasing.tolist(),
                [(u, int(t.status)) for u, t in n.tasks.items()]) for n in c.nodes.values()],
        queues=[(q.uid, q.weight) for q in c.queues.values()],
        others=[(t.uid, t.node_name, t.resreq.tolist()) for t in c.others],
        binds=dict(sim.binder.binds),
        evicts=list(sim.evictor.evicts),
        volumes=(list(sim.volume_binder.allocated), list(sim.volume_binder.bound)),
        resync=list(sim.resync_queue),
        events=[(e.kind, e.object_uid, e.reason, e.message) for e in sim.events],
        pod_conditions=dict(sim.pod_conditions),
    )


# ---------------------------------------------------------------- recipes
# test_cycle.py's scenarios, as SimCluster calls on either package


def sc_two_pods_one_node(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=2000, memory=4 * GB)
    j = sim.add_job("pg1", queue="c1")
    sim.add_task(j, 1000, GB, name="p1")
    sim.add_task(j, 1000, GB, name="p2")
    return sim


def sc_two_queues_two_jobs(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_queue("c2")
    sim.add_node("n1", cpu_milli=2000, memory=4 * GB)
    sim.add_node("n2", cpu_milli=2000, memory=4 * GB)
    j1, j2 = sim.add_job("pg1", queue="c1"), sim.add_job("pg2", queue="c2")
    for i in range(2):
        sim.add_task(j1, 1000, GB, name=f"q1p{i}")
        sim.add_task(j2, 1000, GB, name=f"q2p{i}")
    return sim


def sc_gang_blocks(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=2000, memory=4 * GB)
    j = sim.add_job("pg", queue="c1", min_available=3)
    for i in range(3):
        sim.add_task(j, 1000, GB, name=f"g{i}")
    return sim


def sc_gang_invalid(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=8000, memory=16 * GB)
    j = sim.add_job("pg", queue="c1", min_available=5)
    for i in range(2):
        sim.add_task(j, 100, GB // 10, name=f"v{i}")
    return sim


def sc_drf(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    for n in range(2):
        sim.add_node(f"n{n}", cpu_milli=8000, memory=16 * GB)
    ja = sim.add_job("a", queue="c1", creation_ts=1)
    jb = sim.add_job("b", queue="c1", creation_ts=2)
    for i in range(16):
        sim.add_task(ja, 1000, GB, name=f"a{i}")
        sim.add_task(jb, 1000, GB, name=f"b{i}")
    return sim


def sc_proportion(m):
    sim = m.SimCluster()
    sim.add_queue("qa", weight=2)
    sim.add_queue("qb", weight=1)
    for n in range(3):
        sim.add_node(f"n{n}", cpu_milli=8000, memory=16 * GB)
    ja, jb = sim.add_job("a", queue="qa"), sim.add_job("b", queue="qb")
    for i in range(30):
        sim.add_task(ja, 1000, 0, name=f"a{i}")
        sim.add_task(jb, 1000, 0, name=f"b{i}")
    return sim


def sc_priority(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=2000, memory=4 * GB)
    lo = sim.add_job("lo", queue="c1", priority=1, creation_ts=1)
    hi = sim.add_job("hi", queue="c1", priority=10, creation_ts=2)
    for i in range(2):
        sim.add_task(lo, 1000, GB, name=f"lo{i}")
        sim.add_task(hi, 1000, GB, name=f"hi{i}")
    return sim


def sc_backfill(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=1000, memory=GB)
    j = sim.add_job("pg", queue="c1")
    sim.add_task(j, 1000, GB, name="big")
    be = sim.add_job("be-job", queue="c1")
    sim.add_task(be, 0, 0, name="be0")
    return sim


def sc_pipeline(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=1000, memory=GB)
    old = sim.add_job("old", queue="c1")
    sim.add_task(old, 1000, GB, status=m.TaskStatus.RELEASING, node="n1", name="dying")
    j = sim.add_job("new", queue="c1", min_available=1)
    sim.add_task(j, 1000, GB, name="new0")
    return sim


def sc_selector(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("special", cpu_milli=4000, memory=8 * GB, labels={"pool": "x"})
    sim.add_node("general", cpu_milli=4000, memory=8 * GB)
    j = sim.add_job("pg", queue="c1")
    sim.add_task(j, 1000, GB, name="picky", node_selector={"pool": "x"})
    return sim


def sc_max_tasks(m):
    sim = m.SimCluster()
    sim.add_queue("c1")
    sim.add_node("n1", cpu_milli=64000, memory=64 * GB, max_tasks=3)
    j = sim.add_job("pg", queue="c1")
    for i in range(5):
        sim.add_task(j, 100, GB // 10, name=f"t{i}")
    return sim


def sc_failing_top_job(m):
    sim = m.SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=8000, memory=16 * GB)
    sim.add_task(sim.add_job("aaa", queue="q", min_available=1), 99000, GB, name="huge")
    sim.add_task(sim.add_job("bbb", queue="q", min_available=1), 1000, GB, name="small")
    return sim


def sc_random(m, seed):
    return m.generate_cluster(num_nodes=16, num_jobs=8, tasks_per_job=10, num_queues=3,
                              seed=seed, node_cpu_milli=16000, node_memory=32 * GB,
                              node_gpu_milli=4000, running_fraction=0.2)


CYCLE_SCENARIOS = [sc_two_pods_one_node, sc_two_queues_two_jobs, sc_gang_blocks,
                   sc_gang_invalid, sc_drf, sc_proportion, sc_priority, sc_backfill,
                   sc_pipeline, sc_selector, sc_max_tasks, sc_failing_top_job]


def predicates_world(m, pod_affinity=True):
    """Taints and tolerations, node selectors and node affinity (one term
    and two), host ports, volumes with zones, tasks of another scheduler
    and, with ``pod_affinity``, pod (anti-)affinity terms over zone and
    hostname domains."""
    T, Tol, Me = m.Taint, m.Toleration, m.MatchExpression
    sim = m.SimCluster()
    sim.add_queue("qa", weight=2)
    sim.add_queue("qb")
    for i in range(6):
        zone = "zone-a" if i < 3 else "zone-b"
        taints = [T("gpu", "true", "NoSchedule")] if i % 3 == 2 else []
        if i == 4:
            taints.append(T("soft", "", "PreferNoSchedule"))
        sim.add_node(f"n{i}", cpu_milli=8000, memory=16 * GB, gpu_milli=2000 * (i % 2),
                     labels={ZONE: zone, HOST: f"n{i}", "disk": "ssd" if i % 2 else "hdd",
                             "cpus": str(8 + i)},
                     taints=taints, unschedulable=(i == 5), attach_limit=2 + i)
    web = sim.add_job("web", queue="qa", min_available=2, priority=3, creation_ts=2)
    for i in range(4):
        sim.add_task(web, 500, GB, name=f"web{i}", host_ports=(8080 + i % 2,),
                     labels={"app": "web"},
                     status=m.TaskStatus.RUNNING if i < 2 else m.TaskStatus.PENDING,
                     node=f"n{i}" if i < 2 else "")
    db = sim.add_job("db", queue="qb", min_available=1, creation_ts=1)
    for i in range(3):
        sim.add_task(db, 1000, 2 * GB, name=f"db{i}", volumes=1, volume_zone="zone-b",
                     labels={"app": "db"},
                     tolerations=[Tol("gpu", "Equal", "true", "NoSchedule")])
    picky = sim.add_job("picky", queue="qa", creation_ts=3)
    sim.add_task(picky, 200, GB, name="sel", node_selector={"disk": "ssd"})
    sim.add_task(picky, 200, GB, name="aff1", node_affinity=[Me("cpus", "Gt", ("10",)),
                                                             Me("disk", "Exists")])
    sim.add_task(picky, 200, GB, name="aff2",
                 node_affinity=[(Me("disk", "In", ("hdd",)),), (Me(ZONE, "NotIn", ("zone-a",)),)])
    sim.add_task(picky, 300, GB, name="tolall", tolerations=[Tol("", "Exists")],
                 host_ports=(9090,))
    if pod_affinity:
        PA = m.PodAffinityTerm
        pa = sim.add_job("pa", queue="qb", creation_ts=4)
        sim.add_task(pa, 100, GB, name="near-web", labels={"app": "cache"},
                     affinity=[PA(match_labels=(("app", "web"),), topology_key=ZONE)])
        sim.add_task(pa, 100, GB, name="apart", labels={"app": "cache"},
                     affinity=[PA(match_labels=(("app", "cache"),), topology_key=HOST, anti=True)])
        sim.add_task(pa, 100, GB, name="both", labels={"app": "x"},
                     affinity=[PA(match_labels=(("app", "web"),), topology_key=ZONE),
                               PA(match_expressions=(m.MatchExpression("app", "In", ("db",)),),
                                  topology_key=HOST, anti=True, namespaces=("default",))])
        lone = sim.add_job("lone", queue="qa", creation_ts=5)
        sim.add_task(lone, 100, GB, name="guard", labels={"app": "guard"},
                     status=m.TaskStatus.RUNNING, node="n0",
                     affinity=[PA(match_labels=(("app", "cache"),), topology_key=ZONE, anti=True)])
    sim.add_other_task("n3", cpu_milli=700, memory=GB)
    sim.add_other_task("n1", cpu_milli=300, memory=GB // 2, gpu_milli=500)
    return sim


# ---------------------------------------------------------------- the pack


@pytest.mark.parametrize("recipe", CYCLE_SCENARIOS, ids=lambda r: r.__name__[3:])
def test_pack_matches_reference_on_cycle_scenarios(recipe):
    ref, port = both(recipe)
    assert_packs_equal(ref_snapshot.build_snapshot(ref.cluster),
                       port_snapshot.build_snapshot(port.cluster))
    assert cluster_state(ref) == cluster_state(port)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_matches_reference_on_random_clusters(seed):
    ref, port = both(sc_random, seed)
    assert cluster_state(ref) == cluster_state(port)
    assert_packs_equal(ref_snapshot.build_snapshot(ref.cluster),
                       port_snapshot.build_snapshot(port.cluster))


def generated(m, q, seed):
    """tests/test_batched_turns.py's worlds at 3 tasks a job (at most
    1,728 tasks)."""
    return m.generate_cluster(num_nodes=48, num_jobs=max(12, q + q // 8), tasks_per_job=3,
                              num_queues=q, seed=seed, node_cpu_milli=4000,
                              node_memory=8 * GB, running_fraction=0.5)


@pytest.mark.parametrize("q", [8, 64, 512])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_cluster_and_pack_match_reference(q, seed):
    """The port's generate_cluster builds the reference's cluster, and its
    pack equals the reference's (twice: the sticky memo's second build
    keeps the first one's shapes in both packages)."""
    ref, port = both(generated, q, seed)
    assert cluster_state(ref) == cluster_state(port)
    for _ in range(2):
        assert_packs_equal(ref_snapshot.build_snapshot(ref.cluster),
                           port_snapshot.build_snapshot(port.cluster), f"q{q} seed {seed}: ")


@pytest.mark.parametrize("pod_affinity", [False, True], ids=["no_terms", "pod_affinity"])
def test_pack_matches_reference_with_predicates(pod_affinity):
    ref, port = both(predicates_world, pod_affinity)
    r = ref_snapshot.build_snapshot(ref.cluster)
    p = port_snapshot.build_snapshot(port.cluster)
    assert_packs_equal(r, p)
    t = p.tensors
    assert t.class_fit.shape[0] > 3 and not t.class_fit.all()
    assert len(p.index.port_universe) == 3 and t.others_used.any()
    assert (t.group_aff_terms.shape[1] > 0) == pod_affinity


def test_sticky_buckets_match_reference():
    """The memo keeps a shape while counts shrink by less than ~20%, and
    re-buckets past it, in both packages alike; a keyless bucket (the
    synthetic generator's) never reads the memo."""
    seq = [1000, 900, 800, 1100, 3000, 2600, 100, 120]
    for key in ("tasks", ""):
        got = [port_snapshot._bucket(n, 8, 8, key=key) for n in seq]
        want = [ref_snapshot._bucket(n, 8, 8, key=key) for n in seq]
        assert got == want
    assert [port_snapshot._bucket(n, 8, 8) for n in seq] == [
        ref_snapshot._bucket(n, 8, 8, key="") for n in seq]
    port_snapshot.set_sticky_buckets(False)
    ref_snapshot.set_sticky_buckets(False)
    assert [port_snapshot._bucket(n, 8, 8, key="t") for n in seq] == [
        ref_snapshot._bucket(n, 8, 8, key="t") for n in seq]


def test_pack_dtype_contract():
    """The port's pack contract covers the reference's schema, and a
    drifted dtype or rank raises."""
    from kube_arbitrator_tpu.analysis.contracts import SNAPSHOT_SCHEMA

    for name, (shape, dtype) in SNAPSHOT_SCHEMA.items():
        got_dtype, ndim = port_snapshot.HOST_SCHEMA[name]
        assert np.dtype(got_dtype) == np.dtype(dtype) and ndim == len(shape), name
    assert set(port_snapshot.HOST_SCHEMA) == set(SNAPSHOT_SCHEMA)
    pack = port_snapshot.build_snapshot(sc_drf(PORT).cluster).tensors
    port_snapshot.assert_pack_dtypes(pack)
    for bad in (dict(task_job=pack.task_job.astype(np.int64)),
                dict(node_idle=pack.node_idle.astype(np.float64)),
                dict(n_valid_queues=np.zeros(1, np.int32))):
        with pytest.raises(TypeError, match="contract"):
            port_snapshot.assert_pack_dtypes(dataclasses.replace(pack, **bad))


def test_pack_feeds_from_numpy():
    """The host pack moves to the device through from_numpy unchanged."""
    pack = port_snapshot.build_snapshot(predicates_world(PORT).cluster).tensors
    arrays = {name: getattr(pack, name) for name in pack_fields(pack)}
    st = port_snapshot.from_numpy(arrays, "cpu")
    assert st.rv_window == pack.rv_window and st.num_tasks == pack.task_resreq.shape[0]
    for name in port_snapshot.SCHEMA:
        assert np.array_equal(getattr(st, name).numpy(), getattr(pack, name)), name


# ---------------------------------------------------------------- actuation


def _intents(m, sim, pairs, evicts):
    return ([m.sim.BindIntent(u, n) for u, n in pairs], [m.sim.EvictIntent(u) for u in evicts])


def _columns(m, sim, pairs, evicts):
    snap = m.snapshot.build_snapshot(sim.cluster)
    row = {t.uid: t.ordinal for t in snap.index.tasks}
    node = {n.name: n.ordinal for n in snap.index.nodes}
    binds = m.decode.BindColumn(snap.index, [row[u] for u, _ in pairs], [node[n] for _, n in pairs])
    return binds, m.decode.EvictColumn(snap.index, [row[u] for u in evicts])


def actuation_world(m, failures):
    sim = predicates_world(m, pod_affinity=False)
    if failures:
        sim.binder.fail_uids.add("web3")
        sim.evictor.fail_uids.add("web1")
    return sim


@pytest.mark.parametrize("failures", [False, True], ids=["clean", "failures"])
@pytest.mark.parametrize("form", ["intents", "columns"])
def test_actuation_matches_reference(form, failures):
    """The same binds and evicts applied to both packages' clusters leave
    equal cluster state, failed-uid sets, events and resync queues: bind
    a gang, a zone-pinned volume task on the wrong zone (diverted: the
    volume binder re-checks), evict running pods, then drain the resync
    queue, set pod conditions and collect a deleted job."""
    binds = [("web2", "n3"), ("web3", "n4"), ("db0", "n1"), ("sel", "n1"), ("aff1", "n5"),
             ("db1", "n3")]
    evicts = ["web0", "web1"]
    ref, port = both(actuation_world, failures)
    make = _columns if form == "columns" else _intents
    failed = []
    for m, sim in ((REF, ref), (PORT, port)):
        b, e = make(m, sim, binds, evicts)
        apply_b = sim.apply_binds_columnar if form == "columns" else sim.apply_binds
        apply_e = sim.apply_evicts_columnar if form == "columns" else sim.apply_evicts
        failed.append((sorted(apply_b(b)), sorted(apply_e(e))))
    assert failed[0] == failed[1]
    assert "db0" in failed[1][0] and ("web3" in failed[1][0]) == failures
    assert cluster_state(ref) == cluster_state(port)
    for sim in (ref, port):
        sim.update_pod_condition("aff2", "0/6 nodes are available.")
        sim.delete_job("picky", now=10.0)
        assert sim.collect_garbage(now=12.0) == []
        for t in sim.cluster.jobs["picky"].tasks.values():
            t.status = type(t.status)(7)  # SUCCEEDED
    assert [ref.process_resync(), ref.collect_garbage(now=20.0)] == [
        port.process_resync(), port.collect_garbage(now=20.0)]
    assert cluster_state(ref) == cluster_state(port)


def test_columnar_fast_path_equals_intent_path():
    """With no failure armed, the certified columnar commit leaves the
    same cluster as the intent path."""
    binds = [("web2", "n3"), ("sel", "n1"), ("aff1", "n5"), ("web3", "n4")]
    states = []
    for make, form in ((_intents, "intents"), (_columns, "columns")):
        sim = actuation_world(PORT, False)
        b, e = make(PORT, sim, binds, ["web0"])
        if form == "columns":
            sim.apply_binds_columnar(b), sim.apply_evicts_columnar(e)
        else:
            sim.apply_binds(b), sim.apply_evicts(e)
        states.append(cluster_state(sim))
    assert states[0] == states[1]


# ---------------------------------------------------------------- conf

CONFS = [
    ref_conf.DEFAULT_CONF,
    'actions: "reclaim, allocate, backfill, preempt"\ntiers:\n- plugins:\n  - name: priority\n'
    "  - name: gang\n- plugins:\n  - name: drf\n  - name: predicates\n  - name: proportion\n",
    'actions: "allocate, backfill"\ntiers:\n- plugins:\n  - name: priority\n'
    "    disableJobOrder: true\n  - name: gang\n    disableJobReady: true\n"
    "    disablePreemptable: true\n- plugins:\n  - name: drf\n  - name: predicates\n"
    "    disablePredicate: true\n  - name: proportion\n    disableQueueOrder: true\n"
    "  - name: nodeorder\n    arguments:\n      policy: binpack\n",
    'actions: "reclaim_optimistic, allocate"\ntiers: []\n',
]
BAD_CONFS = [
    'actions: "allocate, teleport"\n',
    'actions: "allocate"\ntiers:\n- plugins:\n  - name: astrology\n',
    'actions: "allocate"\ntiers:\n- plugins:\n  - name: predicates\n    disableJobOrder: true\n',
    'actions: "allocate"\ntiers:\n- plugins:\n  - name: nodeorder\n    arguments:\n'
    "      policy: random\n",
]


@pytest.mark.parametrize("text", CONFS, ids=["default", "evictive", "flags", "optimistic"])
def test_conf_round_trips_like_reference(text):
    ref, port = ref_conf.load_conf(text), port_conf.load_conf(text)
    assert port == port_conf.from_config(ref)
    assert port_conf.dump_conf(port) == ref_conf.dump_conf(ref)
    assert port_conf.load_conf(port_conf.dump_conf(port)) == port


@pytest.mark.parametrize("text", BAD_CONFS,
                         ids=["action", "plugin", "flag", "nodeorder_policy"])
def test_conf_refuses_like_reference(text):
    with pytest.raises(ValueError):
        ref_conf.load_conf(text)
    with pytest.raises(ValueError):
        port_conf.load_conf(text)


def test_conf_file_and_default(tmp_path):
    path = tmp_path / "conf.yaml"
    path.write_text(CONFS[1])
    assert port_conf.load_conf_file(str(path)) == port_conf.load_conf(CONFS[1])
    assert port_conf.load_conf(port_conf.DEFAULT_CONF) == port_conf.SchedulerConfig.default()


# ---------------------------------------------------------------- the arena


def churn(m, sim, arena, step):
    """One step of a mutation stream: binds, evicts, a completion, a
    status flip published as a node change, a new task (structural) and a
    node capacity drift."""
    S = m.TaskStatus
    pend = sorted((t for j in sim.cluster.jobs.values() for t in j.tasks.values()
                   if t.status == S.PENDING), key=lambda t: t.uid)
    run = sorted((t for j in sim.cluster.jobs.values() for t in j.tasks.values()
                  if t.status == S.RUNNING), key=lambda t: t.uid)
    nodes = sorted(sim.cluster.nodes.values(), key=lambda n: n.name)
    if step % 3 == 0 and pend:
        t = pend[step % len(pend)]
        for n in nodes:
            if np.all(t.resreq < n.idle + m.api.resource.EPSILON) and len(n.tasks) < n.max_tasks:
                sim.apply_binds([m.sim.BindIntent(t.uid, n.name)])
                break
    if step % 3 == 1 and run:
        sim.apply_evicts([m.sim.EvictIntent(run[step % len(run)].uid)])
    if step % 4 == 2 and run:
        t = run[-1]
        sim.cluster.nodes[t.node_name].remove_task(t)
        t.status = S.SUCCEEDED
        arena.task_dirty(t.uid, t.node_name)
    if step == 5:
        job = sim.cluster.jobs[sorted(sim.cluster.jobs)[0]]
        sim.add_task(job, 500, GB, name=f"late-{step}")
    if step == 7:
        n = nodes[1]
        n.unschedulable = not n.unschedulable
        arena.node_dirty(n.name)


def test_arena_delta_packs_match_reference():
    """A mutation stream through both packages' arenas: every epoch's pack
    equal field for field, the same PackMeta epochs and changed fields
    and the same rebuild reasons; verify() passes on the port's every
    epoch, and the delta path is taken."""
    ref, port = both(generated, 8, 3)
    arenas = (ref_arena.SnapshotArena(ref, verify_every=1),
              port_arena.SnapshotArena(port, verify_every=1))
    reasons = []
    for step in range(10):
        snaps = [a.snapshot() for a in arenas]
        assert_packs_equal(*snaps, f"epoch {step}: ")
        mr, mp = (a.pack_meta for a in arenas)
        epoch = lambda k: None if k is None else k.split(":")[1]  # noqa: E731
        assert (epoch(mr.key), epoch(mr.base_key), mr.changed_fields) == (
            epoch(mp.key), epoch(mp.base_key), mp.changed_fields), step
        assert arenas[0].last_rebuild_reason == arenas[1].last_rebuild_reason
        reasons.append(arenas[1].last_rebuild_reason)
        arenas[1].verify()
        for m, sim, a in ((REF, ref, arenas[0]), (PORT, port, arenas[1])):
            churn(m, sim, a, step)
    assert reasons[0] == "seed" and reasons.count(None) >= 6 and "task_added" in reasons


def test_arena_verify_catches_a_missed_delta():
    """A mutation that is not published to the delta sink leaves the
    arena's pack stale; verify() raises ArenaDivergence and the next pack
    is rebuilt."""
    sim = generated(PORT, 8, 1)
    arena = port_arena.SnapshotArena(sim, verify_every=0)
    arena.snapshot()
    t = next(t for j in sim.cluster.jobs.values() for t in j.tasks.values()
             if t.status == PORT.TaskStatus.RUNNING)
    t.priority += 5  # not published
    with pytest.raises(port_arena.ArenaDivergence, match="task_priority"):
        arena.verify()
    arena.snapshot()
    assert arena.last_rebuild_reason == "divergence"
    arena.verify()
