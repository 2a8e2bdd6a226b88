"""The port's live-cluster plane held against the JAX package's, on the
CPU: ``cache/fakeapi.FakeApiServer``, ``cache/live.LiveCache`` and
``cache/httpapi`` of ``kube_arbitrator_tpu_torch`` against the same
modules of ``kube_arbitrator_tpu`` (stdlib Python in both; the reference
imports no JAX there).

* fakeapi: the reference's test_fakeapi.py verbs (404 on a deleted pod,
  409 on a double bind and on a stale-rv evict, an injected bind
  failure, GoneError after ``compact``) given to both servers: the same
  answers, error codes, resource versions and watch output; a stream
  dumped by either package replays in the other.
* LiveCache: the scenarios of the reference's test_live_cache.py fed to
  both packages' caches, object by object; the models agree and the
  port's ``build_snapshot`` pack equals the reference's in every field,
  bit for bit (node selectors, ORed node-affinity terms, pod
  (anti-)affinity, tolerations and taints, host ports, PVC -> PV zones
  and attach counts, namespaces as queues, PDBs, a pod deletion and a
  node update, a relist after GoneError with its
  ``structural("relist")``).
* batch ingest: a seeded stream of pod, node and job churn drained by a
  batched and a per-event cache of each package (the ctor switch and
  ``KAT_BATCH_INGEST``): the same model and the same delta-sink dirt
  and structural reasons, batched and per-event alike, and port ==
  reference call for call.
* httpapi: each package's client against the other package's server,
  every verb, the same answers and the same error codes.

Both packages' sticky-bucket memos are cleared before each case.
"""
import dataclasses
import random
import types

import numpy as np
import pytest
import torch

import kube_arbitrator_tpu.cache.fakeapi as ref_fakeapi
import kube_arbitrator_tpu.cache.httpapi as ref_httpapi
import kube_arbitrator_tpu.cache.live as ref_live
import kube_arbitrator_tpu.cache.snapshot as ref_snapshot
import kube_arbitrator_tpu.options as ref_options
import kube_arbitrator_tpu_torch.cache.fakeapi as port_fakeapi
import kube_arbitrator_tpu_torch.cache.httpapi as port_httpapi
import kube_arbitrator_tpu_torch.cache.live as port_live
import kube_arbitrator_tpu_torch.cache.snapshot as port_snapshot
import kube_arbitrator_tpu_torch.options as port_options
from test_torch_host_pack import assert_packs_equal

ZONE = "topology.kubernetes.io/zone"


def _pkg(fakeapi, live, httpapi, snapshot, options):
    return types.SimpleNamespace(
        fakeapi=fakeapi, live=live, httpapi=httpapi, snapshot=snapshot, options=options,
        FakeApiServer=fakeapi.FakeApiServer, ApiError=fakeapi.ApiError,
        GoneError=fakeapi.GoneError, LiveCache=live.LiveCache,
    )


REF = _pkg(ref_fakeapi, ref_live, ref_httpapi, ref_snapshot, ref_options)
REF.name = "ref"
PORT = _pkg(port_fakeapi, port_live, port_httpapi, port_snapshot, port_options)
PORT.name = "port"
BOTH = (REF, PORT)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_state():
    for m in BOTH:
        m.snapshot.set_sticky_buckets(True)
        m.options.reset_options()
    yield
    for m in BOTH:
        m.snapshot.set_sticky_buckets(True)
        m.options.reset_options()


# ---------------------------------------------------------------- objects


def make_pod(name, ns="default", group=None, cpu="1", memory="1Gi", scheduler="kube-batch",
             node="", phase="Pending", uid=None, priority=1):
    pod = {
        "metadata": {"name": name, "namespace": ns, "uid": uid or f"uid-{ns}-{name}",
                     "annotations": {}, "labels": {}},
        "spec": {"schedulerName": scheduler, "nodeName": node, "priority": priority,
                 "containers": [{"resources": {"requests": {"cpu": cpu, "memory": memory}}}]},
        "status": {"phase": phase},
    }
    if group:
        pod["metadata"]["annotations"]["scheduling.k8s.io/group-name"] = group
    return pod


def make_node(name, cpu="4", memory="8Gi", pods=110, labels=None, **alloc):
    return {"metadata": {"name": name, "labels": dict(labels or {})},
            "status": {"allocatable": {"cpu": cpu, "memory": memory, "pods": pods, **alloc}},
            "spec": {}}


def make_podgroup(name, ns="default", min_member=1, queue="", ts=1.0):
    pg = {"metadata": {"name": name, "namespace": ns, "creationTimestamp": ts},
          "spec": {"minMember": min_member}, "status": {}}
    if queue:
        pg["spec"]["queue"] = queue
    return pg


def queue(name, weight=1):
    return {"metadata": {"name": name}, "spec": {"weight": weight}}


def gang(n_nodes=2, n_pods=3, min_member=3):
    out = [("nodes", make_node(f"n{i}")) for i in range(n_nodes)]
    out += [("queues", queue("default")), ("podgroups", make_podgroup("pg1", min_member=min_member))]
    out += [("pods", make_pod(f"p{i}", group="pg1")) for i in range(n_pods)]
    return out


# ---------------------------------------------------------------- fakeapi


def _call(fn, *args, **kw):
    """(result, None) or (None, (error class name, status, message))."""
    try:
        return fn(*args, **kw), None
    except Exception as err:  # noqa: BLE001 - the error is the answer
        return None, (type(err).__name__, getattr(err, "status", None), str(err))


def fakeapi_script(m):
    """The reference test_fakeapi.py verbs on package ``m``'s server:
    every answer, the resource version after each call, and the log."""
    api = m.FakeApiServer()
    out = []

    def rec(*x):
        out.append((x, api.list("configmaps")[1]))

    api.create("nodes", make_node("n1"))
    rec(_call(api.create, "pods", make_pod("p1", uid="u1")))
    rec(_call(api.create, "pods", make_pod("p1", uid="u1")))  # 409 exists
    rec(_call(api.delete, "pods", "default", "p1"))
    rec(_call(api.bind_pod, "default", "p1", "n1"))  # 404
    rec(_call(api.create, "pods", make_pod("p2", uid="u2")))
    rec(_call(api.bind_pod, "default", "p2", "n1"))
    rec(_call(api.bind_pod, "default", "p2", "n2"))  # 409 double bind
    rec(api.get("pods", "default", "p2")["spec"]["nodeName"])
    rec(_call(api.create, "pods", make_pod("p3", uid="u3")))
    stale = api.get("pods", "default", "p3")["metadata"]["resourceVersion"]
    rec(_call(api.bind_pod, "default", "p3", "n1"))
    rec(_call(api.evict_pod, "default", "p3", expect_rv=stale))  # 409 stale rv
    rv = api.get("pods", "default", "p3")["metadata"]["resourceVersion"]
    rec(_call(api.evict_pod, "default", "p3", expect_rv=rv))
    rec(api.get("pods", "default", "p3"))
    rec(_call(api.create, "pods", make_pod("p4", uid="u4")))
    api.fail_bind_uids.add("u4")
    rec(_call(api.bind_pod, "default", "p4", "n1"))  # 422 injected
    api.fail_delete_uids.add("u4")
    rec(_call(api.evict_pod, "default", "p4"))  # 422 injected
    rec(_call(api.update, "pods", make_pod("nope")))  # 404
    pod = api.get("pods", "default", "p4")
    rec(_call(api.update, "pods", pod, expect_rv="1"))  # 409 conflict
    rec(_call(api.update_pod_condition, "default", "p4",
              {"type": "PodScheduled", "status": "False", "reason": "Unschedulable"}))
    rec(_call(api.update_pod_condition, "default", "gone", {"type": "PodScheduled"}))  # 404
    api.create("podgroups", make_podgroup("pg1"))
    rec(_call(api.update_podgroup_status, "default", "pg1", {"phase": "Running"}))
    rec(_call(api.update_podgroup_status, "default", "nope", {}))  # 404
    rec(api.watch("pods", 3), api.watch_all(5))
    rec(api.list("pods"), api.list("nodes"))
    horizon = api.compact(8)
    rec(horizon, _call(api.watch_all, 7), _call(api.watch, "pods", 0), api.watch_all(horizon))
    rec(api.compact(), _call(api.watch_all, horizon))
    api.create("pods", make_pod("p5", uid="u5"))
    rec(api.watch_all(api.list("pods")[1] - 1))
    return out, api


def test_fakeapi_verbs_answer_alike():
    (ref_out, ref_api), (port_out, port_api) = fakeapi_script(REF), fakeapi_script(PORT)
    assert port_out == ref_out
    assert port_api.event_log == ref_api.event_log
    codes = {item[1][1] for x, _ in port_out for item in x
             if isinstance(item, tuple) and len(item) == 2 and isinstance(item[1], tuple)}
    assert {404, 409, 422, 410} <= codes


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_stream_dumped_by_one_package_replays_in_the_other(writer, tmp_path):
    src, dst = (REF, PORT) if writer == "ref" else (PORT, REF)
    api = src.FakeApiServer()
    for r, o in gang(n_pods=4):
        api.create(r, o)
    api.bind_pod("default", "p0", "n0")
    api.delete("pods", "default", "p1")
    api.update_podgroup_status("default", "pg1", {"phase": "Running"})
    path = str(tmp_path / "stream.jsonl")
    api.dump_stream(path)
    events = dst.FakeApiServer.load_stream(path)
    assert events == src.FakeApiServer.load_stream(path) == api.event_log
    replay = dst.FakeApiServer.from_stream(events)
    for res in ("pods", "nodes", "podgroups", "queues"):
        assert replay.list(res) == api.list(res)
    assert replay.watch_all(0) == api.watch_all(0)


# ---------------------------------------------------------------- LiveCache


def model_digest(live, ordered=True):
    """A package-neutral picture of a LiveCache's model.  ``ordered=False``
    sorts each job's tasks by uid: a batched MODIFY updates a task in
    its place in the job, a per-event one removes and re-adds it."""
    c = live.cluster

    def tasks(j):
        return j.tasks.values() if ordered else sorted(j.tasks.values(), key=lambda t: t.uid)

    return dict(
        jobs=[(u, j.name, j.namespace, j.queue_uid, j.min_available, j.priority, j.creation_ts,
               [(t.uid, t.name, t.status.name, t.node_name, np.asarray(t.resreq).tolist(),
                 t.priority, t.volume_zone, sorted(t.node_selector.items()),
                 [[dataclasses.astuple(e) for e in term] for term in t.node_affinity],
                 [dataclasses.astuple(x) for x in t.tolerations], t.host_ports,
                 [dataclasses.astuple(a) for a in t.affinity_terms])
                for t in tasks(j)]) for u, j in c.jobs.items()],
        nodes=[(n.name, n.allocatable.tolist(), n.idle.tolist(), n.used.tolist(),
                n.releasing.tolist(), list(n.tasks), n.unschedulable, sorted(n.labels.items()),
                [dataclasses.astuple(t) for t in n.taints], n.max_tasks)
               for n in c.nodes.values()],
        queues=[(q.uid, q.weight) for q in c.queues.values()],
        others=[(t.uid, t.node_name, np.asarray(t.resreq).tolist()) for t in c.others],
        pdbs=[(u, getattr(j, "pdb", None) and dataclasses.astuple(j.pdb))
              for u, j in c.jobs.items()],
        events=[dataclasses.astuple(e) for e in live.events],
        refs=dict(live._pod_ref), rv=live._watch_rv,
    )


class RecordingSink:
    """A delta sink that records every call."""

    def __init__(self):
        self.calls = []

    def task_dirty(self, uid, node_name=""):
        self.calls.append(("task_dirty", uid, node_name))

    def task_dirty_rows(self, uids, node_names=()):
        self.calls.append(("task_dirty_rows", list(uids), list(node_names)))

    def node_dirty(self, name):
        self.calls.append(("node_dirty", name))

    def structural(self, reason):
        self.calls.append(("structural", reason))

    def effect(self):
        """The dirt and structural reasons the calls amount to (a batched
        row call and its scalar sequence mean the same)."""
        tasks, nodes, reasons = set(), set(), []
        for c in self.calls:
            if c[0] == "task_dirty":
                tasks.add(c[1])
                nodes.update([c[2]] if c[2] else [])
            elif c[0] == "task_dirty_rows":
                tasks.update(c[1])
                nodes.update(n for n in c[2] if n)
            elif c[0] == "node_dirty":
                nodes.add(c[1])
            else:
                reasons.append(c[1])
        return sorted(tasks), sorted(nodes), reasons


def sc_list_watch(m, api):
    for r, o in gang():
        api.create(r, o)
    api.create("pods", make_pod("alien", scheduler="default-scheduler", node="n0",
                                phase="Running", cpu="2"))


def sc_selectors_taints_ports(m, api):
    api.create("nodes", make_node("ssd", labels={"disk": "ssd"}))
    tainted = make_node("gpu", labels={"disk": "hdd"})
    tainted["spec"]["taints"] = [{"key": "gpu", "value": "yes", "effect": "NoSchedule"}]
    api.create("nodes", tainted)
    api.create("queues", queue("default"))
    api.create("podgroups", make_podgroup("pg1", min_member=1))
    p0 = make_pod("p0", group="pg1")
    p0["spec"]["nodeSelector"] = {"disk": "ssd"}
    p0["spec"]["containers"][0]["ports"] = [{"hostPort": 8080}, {"containerPort": 80}]
    p1 = make_pod("p1", group="pg1")
    p1["spec"]["tolerations"] = [{"key": "gpu", "operator": "Equal", "value": "yes",
                                  "effect": "NoSchedule"}]
    p1["spec"]["containers"].append(
        {"resources": {"requests": {"cpu": "250m", "nvidia.com/gpu": "1"}},
         "ports": [{"hostPort": 9090}]})
    for p in (p0, p1):
        api.create("pods", p)


def sc_node_affinity_terms(m, api):
    api.create("nodes", make_node("west-hdd", labels={"zone": "west", "disk": "hdd"}))
    api.create("nodes", make_node("east", labels={"zone": "east"}))
    api.create("queues", queue("default"))
    api.create("podgroups", make_podgroup("pg1", min_member=1))
    pod = make_pod("p0", group="pg1")
    pod["spec"]["affinity"] = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
        "nodeSelectorTerms": [
            {"matchExpressions": [{"key": "zone", "operator": "In", "values": ["west"]},
                                  {"key": "disk", "operator": "In", "values": ["ssd"]}]},
            {"matchExpressions": [{"key": "zone", "operator": "In", "values": ["east"]}]},
        ]}}}
    api.create("pods", pod)


def sc_pod_affinity(m, api):
    for i in range(2):
        api.create("nodes", make_node(f"n{i}"))
    api.create("queues", queue("default"))
    api.create("podgroups", make_podgroup("pg1", min_member=2))
    for i in range(2):
        pod = make_pod(f"p{i}", group="pg1")
        pod["metadata"]["labels"] = {"app": "db"}
        pod["spec"]["affinity"] = {
            "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "db"}},
                 "topologyKey": "kubernetes.io/hostname"}]},
            "podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchExpressions": [
                    {"key": "app", "operator": "In", "values": ["db", "web"]}]},
                 "topologyKey": ZONE, "namespaces": ["default"]}]},
        }
        api.create("pods", pod)


def sc_volumes(m, api):
    for zone, n in (("zone-a", "n0"), ("zone-b", "n1")):
        api.create("nodes", make_node(n, labels={ZONE: zone}, **{"attachable-volumes-csi": 3}))
    api.create("queues", queue("default"))
    api.create("storageclasses", {"metadata": {"name": "wffc"}})
    for zone, pv, claim in (("zone-a", "pva", "ca"), ("zone-b", "pvb", "cb")):
        api.create("persistentvolumes", {"metadata": {"name": pv, "labels": {ZONE: zone}},
                                         "spec": {}})
        api.create("persistentvolumeclaims", {"metadata": {"namespace": "default", "name": claim},
                                              "spec": {"volumeName": pv}})
    api.create("persistentvolumes", {"metadata": {"name": "pvc-na"}, "spec": {"nodeAffinity": {
        "required": {"nodeSelectorTerms": [{"matchExpressions": [
            {"key": ZONE, "operator": "In", "values": ["zone-b"]}]}]}}}})
    api.create("persistentvolumeclaims", {"metadata": {"namespace": "default", "name": "cn"},
                                          "spec": {"volumeName": "pvc-na"}})
    api.create("persistentvolumeclaims", {"metadata": {"namespace": "default", "name": "unbound"},
                                          "spec": {}})
    api.create("podgroups", make_podgroup("pg1", min_member=1))
    for name, claims in (("pa", ["ca"]), ("pb", ["cn", "unbound"]), ("pc", ["ca", "cb"]),
                         ("late", ["cl"])):
        pod = make_pod(name, group="pg1")
        pod["spec"]["volumes"] = [{"name": c, "persistentVolumeClaim": {"claimName": c}}
                                  for c in claims]
        api.create("pods", pod)
    # a PV and PVC that arrive after the pod: the pod is retranslated
    api.create("persistentvolumes", {"metadata": {"name": "pvl", "labels": {ZONE: "zone-a"}},
                                     "spec": {}})
    api.create("persistentvolumeclaims", {"metadata": {"namespace": "default", "name": "cl"},
                                          "spec": {"volumeName": "pvl"}})


def sc_namespace_queues(m, api):
    m.options.set_options(m.options.ServerOptions(namespace_as_queue=True))
    api.create("namespaces", {"metadata": {"name": "team-a"}})
    api.create("namespaces", {"metadata": {"name": "team-b"}})
    api.create("queues", queue("ignored", 3))
    api.create("nodes", make_node("n0"))
    api.create("pods", make_pod("p0", ns="team-a", group="g", cpu="1"))
    api.create("podgroups", make_podgroup("g", ns="team-a", min_member=1))
    api.create("pods", make_pod("p1", ns="team-b", cpu="1"))


def sc_pdbs(m, api):
    api.create("nodes", make_node("n0"))
    api.create("queues", queue("default"))
    api.create("pdbs", {"metadata": {"name": "owner-rs1", "namespace": "default"},
                        "spec": {"minAvailable": 2}})
    for i in range(3):
        pod = make_pod(f"r{i}")
        pod["metadata"]["ownerReferences"] = [{"uid": "rs1", "name": "rs"}]
        api.create("pods", pod)
    api.create("pods", make_pod("solo"))


SCENARIOS = [sc_list_watch, sc_selectors_taints_ports, sc_node_affinity_terms, sc_pod_affinity,
             sc_volumes, sc_namespace_queues, sc_pdbs]


def live_pair(scenario):
    """(reference LiveCache, port LiveCache), each over its own
    package's server fed by ``scenario``, listed (one sync)."""
    out = []
    for m in BOTH:
        api = m.FakeApiServer()
        scenario(m, api)
        live = m.LiveCache(api)
        live.delta_sink = RecordingSink()
        live.sync()
        out.append((m, api, live))
    return out


def assert_live_equal(r, p, ctx=""):
    (rm, rapi, rlive), (pm, papi, plive) = r, p
    assert model_digest(plive) == model_digest(rlive), ctx
    assert plive.delta_sink.calls == rlive.delta_sink.calls, ctx
    rm.snapshot.set_sticky_buckets(True)
    pm.snapshot.set_sticky_buckets(True)
    assert_packs_equal(rm.snapshot.build_snapshot(rlive.cluster),
                       pm.snapshot.build_snapshot(plive.cluster), ctx)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__[3:])
def test_live_cache_packs_equal_reference(scenario):
    r, p = live_pair(scenario)
    assert_live_equal(r, p)
    assert sum(len(j.tasks) for j in p[2].cluster.jobs.values()) > 0


def test_live_cache_deletion_node_update_and_relist():
    """A pod deletion and a node update through the watch, then a
    compacted window: the relist rebuilds the model, the sink hears
    ``structural("relist")``, and the packs stay equal."""
    r, p = live_pair(sc_list_watch)
    for m, api, live in (r, p):
        api.delete("pods", "default", "p1")
        node = api.get("nodes", "", "n0")
        node["spec"]["unschedulable"] = True
        api.update("nodes", node)
        api.bind_pod("default", "p0", "n1")
        live.sync()
    assert_live_equal(r, p, "after the watch: ")
    assert p[2].cluster.nodes["n0"].unschedulable
    for m, api, live in (r, p):
        api.delete("pods", "default", "p2")
        api.create("pods", make_pod("p9", group="pg1"))
        api.compact()
        assert live.sync() > 0
    assert_live_equal(r, p, "after the relist: ")
    assert ("structural", "relist") in p[2].delta_sink.calls
    assert set(p[2]._task_by_uid) == {"uid-default-p0", "uid-default-p9"}


def test_live_cache_actuation_and_resync_alike():
    """The actuation verbs of both caches on the same objects: binds,
    a failing bind diverted to the errTasks resync, an evict, a status
    PUT and a condition PATCH leave the same apiserver log, events and
    resync queue."""
    out = []
    for m in BOTH:
        api = m.FakeApiServer()
        sc_list_watch(m, api)
        api.fail_bind_uids.add("uid-default-p1")
        live = m.LiveCache(api)
        live.sync()
        col = types.SimpleNamespace(uids=["uid-default-p0", "uid-default-p1", "gone"],
                                    node_names=["n0", "n1", "n1"])
        failed = live.apply_binds_columnar(col)
        failed += live.apply_evicts_columnar(types.SimpleNamespace(uids=["uid-default-p2"]))
        st = types.SimpleNamespace(phase=types.SimpleNamespace(name="RUNNING"), running=1,
                                   succeeded=0, failed=0, conditions=[types.SimpleNamespace(
                                       type="Unschedulable", status="True", reason="r",
                                       message="m")])
        live.update_job_status("default/pg1", st)
        live.update_pod_condition("uid-default-p1", "0/2 nodes are available")
        depth = list(live.resync_queue)
        api.fail_bind_uids.clear()
        repaired = live.process_resync()
        live.collect_garbage(now=1e18)
        out.append((failed, depth, repaired, api.event_log, model_digest(live)))
    assert out[1] == out[0]
    assert out[1][0] == ["uid-default-p1", "gone"] and out[1][2] == 1


# ---------------------------------------------------------------- batch ingest


def churn_stream(m, api, seed):
    """The reference test_ingest_batch.py soak's churn (row-local pod
    MODIFYs, new and foreign pods, deletions, job flips, cordons) on
    ``api``, one round; returns the pods' state."""
    rng = random.Random(seed)
    pods = {p["metadata"]["name"]: p for p in api.list("pods")[0]}
    for i in range(rng.randint(3, 7)):
        op = rng.random()
        if op < 0.55 and pods:
            name = rng.choice(sorted(pods))
            old = pods[name]
            p = make_pod(name, group=old["metadata"]["annotations"].get(
                "scheduling.k8s.io/group-name"), uid=old["metadata"]["uid"],
                node=old["spec"]["nodeName"] or (rng.choice(["", "n0", "n1"])
                                                 if rng.random() < 0.4 else ""),
                phase=rng.choice(["Pending", "Running", "Succeeded"]),
                priority=rng.randint(1, 3), scheduler=old["spec"]["schedulerName"])
            api.update("pods", p)
        elif op < 0.7:
            name = f"new-{seed}-{i}"
            foreign = rng.random() < 0.3
            api.create("pods", make_pod(
                name, group=None if foreign else f"pg{rng.randrange(3)}",
                node=f"n{rng.randrange(4)}" if foreign else "",
                phase="Running" if foreign else "Pending",
                scheduler="default-scheduler" if foreign else "kube-batch"))
        elif op < 0.8 and pods:
            name = rng.choice(sorted(pods))
            api.delete("pods", "default", name)
            pods.pop(name)
        elif op < 0.9 and pods:
            name = rng.choice(sorted(pods))
            old = pods[name]
            api.update("pods", make_pod(name, group=f"pg{rng.randrange(3)}",
                                        uid=old["metadata"]["uid"],
                                        node=old["spec"]["nodeName"],
                                        phase=old["status"]["phase"],
                                        scheduler=old["spec"]["schedulerName"]))
        else:
            node = make_node(f"n{rng.randrange(4)}", cpu="8", memory="16Gi")
            if rng.random() < 0.5:
                node["spec"]["unschedulable"] = True
            api.update("nodes", node)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_ingest_equals_per_event_and_reference(seed, monkeypatch):
    """Four caches of each package drain one server's stream: batched
    by the ctor switch, per event by the ctor switch, and the same two
    by ``KAT_BATCH_INGEST`` (unset and "0").  After every drain: one
    model (up to the order of a job's tasks, as in the reference's soak)
    and one delta-sink effect per package; port == reference call for
    call and model for model, the packs equal bit for bit in each mode;
    the batched path did batch."""
    caches = {}
    apis = {}
    for m in BOTH:
        api = m.FakeApiServer()
        for i in range(4):
            api.create("nodes", make_node(f"n{i}", cpu="8", memory="16Gi"))
        api.create("queues", queue("default"))
        for g in range(3):
            api.create("podgroups", make_podgroup(f"pg{g}"))
            for i in range(4):
                api.create("pods", make_pod(f"p{g}-{i}", group=f"pg{g}"))
        apis[m.name] = api
        monkeypatch.delenv("KAT_BATCH_INGEST", raising=False)
        env_on = m.LiveCache(api)
        monkeypatch.setenv("KAT_BATCH_INGEST", "0")
        env_off = m.LiveCache(api)
        monkeypatch.delenv("KAT_BATCH_INGEST")
        caches[m.name] = dict(batched=m.LiveCache(api, batch_ingest=True),
                         scalar=m.LiveCache(api, batch_ingest=False),
                         env_on=env_on, env_off=env_off)
        assert env_on.batch_ingest and not env_off.batch_ingest
        for live in caches[m.name].values():
            live.sync()
            live.delta_sink = RecordingSink()
    batched_calls = 0
    for rnd in range(8):
        for m in BOTH:
            churn_stream(m, apis[m.name], 100 * seed + rnd)
        for m in BOTH:
            for v in caches[m.name].values():
                v.delta_sink.calls.clear()
            applied = {k: v.sync() for k, v in caches[m.name].items()}
            digests = {k: model_digest(v, ordered=False) for k, v in caches[m.name].items()}
            assert len(set(applied.values())) == 1, (rnd, applied)
            ref_digest = digests["scalar"]
            for k, d in digests.items():
                assert d == ref_digest, (rnd, k)
            effects = {k: v.delta_sink.effect() for k, v in caches[m.name].items()}
            assert effects["batched"] == effects["scalar"] == effects["env_on"] == effects["env_off"]
            batched_calls += sum(c[0] == "task_dirty_rows"
                                 for c in caches[m.name]["batched"].delta_sink.calls)
        for k in caches["port"]:
            assert model_digest(caches["port"][k]) == model_digest(caches["ref"][k]), (rnd, k)
            assert caches["port"][k].delta_sink.calls == caches["ref"][k].delta_sink.calls, (rnd, k)
        for k in ("batched", "scalar"):
            for m in BOTH:
                m.snapshot.set_sticky_buckets(True)
            assert_packs_equal(REF.snapshot.build_snapshot(caches["ref"][k].cluster),
                               PORT.snapshot.build_snapshot(caches["port"][k].cluster),
                               f"round {rnd} {k}: ")
    assert batched_calls > 0


# ---------------------------------------------------------------- httpapi


def http_script(client):
    """Every verb of the REST shim through ``client``: (answer or error
    class, status, message) per call."""
    out = []

    def rec(fn, *a, **kw):
        r, err = _call(fn, *a, **kw)
        out.append((r, err and (err[1], err[2])))

    rec(client.create, "nodes", make_node("n0"))
    rec(client.create, "queues", queue("default"))
    rec(client.create, "podgroups", make_podgroup("pg1"))
    for i in range(3):
        rec(client.create, "pods", make_pod(f"p{i}", group="pg1"))
    rec(client.create, "pods", make_pod("p0", group="pg1"))  # 409
    rec(client.list, "pods")
    rec(client.list, "nodes")
    rec(client.get, "pods", "default", "p0")
    rec(client.get, "pods", "default", "nope")  # None (404)
    rec(client.get, "nodes", "", "n0")
    rec(client.bind_pod, "default", "p0", "n0")
    rec(client.bind_pod, "default", "p0", "n0")  # 409
    rec(client.bind_pod, "default", "nope", "n0")  # 404
    rec(client.evict_pod, "default", "p1", expect_rv="1")  # 409
    rec(client.evict_pod, "default", "p1")
    rec(client.evict_pod, "default", "p1")  # 404
    rec(client.update_pod_condition, "default", "p2",
        {"type": "PodScheduled", "status": "False", "reason": "Unschedulable", "message": "m"})
    rec(client.update_pod_condition, "default", "nope", {"type": "PodScheduled"})  # 404
    rec(client.update_podgroup_status, "default", "pg1", {"phase": "Running", "running": 1})
    rec(client.update_podgroup_status, "default", "nope", {})  # 404
    node = client.get("nodes", "", "n0")
    node["spec"]["unschedulable"] = True
    rec(client.update, "nodes", node, expect_rv="2")  # 409
    rec(client.update, "nodes", node, expect_rv=node["metadata"]["resourceVersion"])
    rec(client.update, "nodes", make_node("nope"))  # 404
    rec(client.create, "configmaps", {"metadata": {"namespace": "kube-system", "name": "lock"}})
    rec(client.delete, "configmaps", "kube-system", "lock", expect_rv="1")  # 409
    rec(client.delete, "configmaps", "kube-system", "lock")
    rec(client.watch_all, 0)
    rec(client.watch, "pods", 4)
    return out


@pytest.mark.parametrize("server_pkg,client_pkg", [("ref", "port"), ("port", "ref")])
def test_http_clients_and_servers_interoperate(server_pkg, client_pkg):
    """Each package's HttpApiClient against the other package's
    serve_api, and against its own: the same answers and error codes for
    every verb, and GoneError's 410 across the wire."""
    srv_m = REF if server_pkg == "ref" else PORT
    cli_m = PORT if client_pkg == "port" else REF
    answers = {}
    for name, (sm, cm) in (("cross", (srv_m, cli_m)), ("own", (srv_m, srv_m))):
        api = sm.FakeApiServer()
        server, thread, url = sm.httpapi.serve_api(api, "127.0.0.1", 0)
        try:
            client = cm.httpapi.HttpApiClient(url, timeout_s=10.0)
            answers[name] = http_script(client)
            api.compact()
            gone = _call(client.watch_all, 0)[1]
            assert gone[:2] == ("ApiError", 410)
            answers[name].append(gone[1:])
            live = cm.LiveCache(client)
            assert live.sync() > 0
            assert set(live._task_by_uid) == {"uid-default-p0", "uid-default-p2"}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()
    assert answers["cross"] == answers["own"]
    codes = {a[1][0] for a in answers["cross"] if a[1]}
    assert {404, 409} <= codes


def test_http_lease_race_has_one_winner():
    """Twelve port ApiLeaderElectors race for one lease through the
    port's REST shim on threads (a short switch interval): the server's
    one store lock and the resourceVersion precondition leave exactly
    one leader, whose record the store holds."""
    import sys
    import threading

    from kube_arbitrator_tpu_torch.framework.leader import (
        LEASE_ANNOTATION, LOCK_CONFIGMAP, ApiLeaderElector)

    api = PORT.FakeApiServer()
    server, thread, url = PORT.httpapi.serve_api(api, "127.0.0.1", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        barrier = threading.Barrier(12, timeout=20)
        won = {}

        def contend(i):
            e = ApiLeaderElector(PORT.httpapi.HttpApiClient(url, timeout_s=10.0),
                                 identity=f"e{i}", now_fn=lambda: 0.0)
            barrier.wait()
            won[i] = e.try_acquire()

        workers = [threading.Thread(target=contend, args=(i,)) for i in range(12)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers) and len(won) == 12
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    winners = [i for i, ok in won.items() if ok]
    assert len(winners) == 1
    cm = api.get("configmaps", "kube-system", LOCK_CONFIGMAP)
    assert f'"holder": "e{winners[0]}"' in cm["metadata"]["annotations"][LEASE_ANNOTATION]
