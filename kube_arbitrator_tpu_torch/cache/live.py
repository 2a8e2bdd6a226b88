"""Live-cluster cache: list/watch ingestion + apiserver actuation (the
port of kube_arbitrator_tpu/cache/live.py).

The analog of the reference's informer-driven ``SchedulerCache``
(``pkg/scheduler/cache/cache.go:225-306`` wires 9 informers with filtered
handlers; ``event_handlers.go`` mutates the in-memory model;
``cache.go:88-165`` actuates through DefaultBinder/DefaultEvictor/
StatusUpdater).  The decision plane is unchanged — this module
keeps the same ``ClusterInfo`` model the snapshot flattener consumes, and
presents the same backend surface the :class:`framework.Scheduler` drives
(``process_resync`` / ``collect_garbage`` / ``apply_binds`` /
``apply_evicts`` / ``record_event``), so sim and live backends are
interchangeable.

Differences from a real client-go stack, by design:

* watches are pull-based (the scheduler pumps ``sync()`` at cycle start,
  the single-threaded equivalent of informer goroutines draining their
  queues between cycles);
* the apiserver is any object speaking the verbs of
  :class:`fakeapi.FakeApiServer` — the in-memory store for tests, a
  recorded JSONL stream for replay, or :class:`httpapi.HttpApiClient`
  dialing the REST shim over localhost.

The translator covers node selector, multi-term node affinity (ORed,
helpers.go:303-315), pod inter-(anti)affinity terms (predicates.go:
186-198), tolerations, host ports, resources, and the volume plane:
PV/PVC/StorageClass objects are ingested (cache.go:230-238, informer
registrations :288-306) and pod ``volumes`` resolve through the PVC -> PV
chain into the model's zone pin (``TaskInfo.volume_zone``) and
attach-count resource axis, feeding the existing zone-class predicate and
attach-limit fit.

Actuation is circular like the real thing: ``apply_binds`` POSTs the
binding subresource and the model only learns the outcome from the watch
events the next ``sync()`` drains (with the fake server's kubelet
emulation moving bound pods to Running).  A failed POST/DELETE diverts the
task uid to the errTasks resync FIFO; ``process_resync`` re-GETs the pod
and repairs the model (``cache.go:519-547``, ``event_handlers.go:70-88``).
"""
from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import resource as res
from ..api.info import (
    ClusterInfo,
    JobInfo,
    MatchExpression,
    NodeInfo,
    QueueInfo,
    Taint,
    TaskInfo,
    Toleration,
)
from ..api.types import TaskStatus
from ..options import options
from ..utils import locking
from ..utils.metrics import metrics
from .fakeapi import ADDED, DELETED, MODIFIED, RESOURCES, ApiError, FakeApiServer
from .sim import BindIntent, Event, EvictIntent

GROUP_ANNOTATION = "scheduling.k8s.io/group-name"  # reference labels.go:20

_MEM_SUFFIX = {
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "K": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
}


def parse_cpu_milli(q) -> float:
    """k8s cpu quantity -> millicores ("500m" -> 500, "2" -> 2000)."""
    if isinstance(q, (int, float)):
        return float(q) * 1000.0
    s = str(q)
    if s.endswith("m"):
        return float(s[:-1])
    return float(s) * 1000.0


def parse_memory_bytes(q) -> float:
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q)
    for suf, mult in _MEM_SUFFIX.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def pod_resreq(pod: dict, n_attach: int = 0):
    """Sum of container requests (job_info.go:36-60 GetPodResourceRequest);
    ``n_attach`` rides the 4th (attach-count) resource axis — this model's
    form of the reference's volume attach limits (volumebinder,
    cache.go:230-238)."""
    cpu = mem = gpu = 0.0
    for c in pod.get("spec", {}).get("containers", []):
        reqs = c.get("resources", {}).get("requests", {})
        if "cpu" in reqs:
            cpu += parse_cpu_milli(reqs["cpu"])
        if "memory" in reqs:
            mem += parse_memory_bytes(reqs["memory"])
        if "nvidia.com/gpu" in reqs:
            gpu += float(reqs["nvidia.com/gpu"]) * 1000.0
    return res.make(cpu, mem, gpu, float(n_attach))


def pod_status(pod: dict) -> TaskStatus:
    """Pod -> TaskStatus (helpers.go:35-61)."""
    phase = pod.get("status", {}).get("phase", "Pending")
    node = pod.get("spec", {}).get("nodeName", "")
    if pod.get("metadata", {}).get("deletionTimestamp") and node:
        return TaskStatus.RELEASING
    if phase == "Running":
        return TaskStatus.RUNNING
    if phase == "Pending":
        return TaskStatus.BOUND if node else TaskStatus.PENDING
    if phase == "Succeeded":
        return TaskStatus.SUCCEEDED
    if phase == "Failed":
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN


def _match_expressions(terms) -> Tuple[MatchExpression, ...]:
    out = []
    for t in terms or []:
        out.append(
            MatchExpression(
                key=t.get("key", ""),
                operator=t.get("operator", "In"),
                values=tuple(t.get("values", ())),
            )
        )
    return tuple(out)


def _pod_affinity_terms(spec: dict) -> Tuple["PodAffinityTerm", ...]:
    """spec.affinity.{podAffinity,podAntiAffinity}.requiredDuring... ->
    PodAffinityTerm tuple (the inter-pod half of predicates.go:186-198;
    the decision plane evaluates them in ops/podaffinity.py)."""
    from ..api.info import PodAffinityTerm

    out = []
    aff = spec.get("affinity", {})
    for kind, anti in (("podAffinity", False), ("podAntiAffinity", True)):
        for term in aff.get(kind, {}).get(
            "requiredDuringSchedulingIgnoredDuringExecution", []
        ) or []:
            sel = term.get("labelSelector", {}) or {}
            out.append(
                PodAffinityTerm(
                    match_labels=tuple(sorted(sel.get("matchLabels", {}).items())),
                    match_expressions=_match_expressions(sel.get("matchExpressions")),
                    topology_key=term.get("topologyKey", "kubernetes.io/hostname"),
                    anti=anti,
                    namespaces=tuple(term.get("namespaces", ()) or ()),
                )
            )
    return tuple(out)


def pod_claims(pod: dict) -> Tuple[str, ...]:
    """Names of the pod's PVC-backed volumes (spec.volumes[].persistentVolumeClaim)."""
    return tuple(
        v["persistentVolumeClaim"]["claimName"]
        for v in pod.get("spec", {}).get("volumes", []) or []
        if v.get("persistentVolumeClaim", {}).get("claimName")
    )


def pv_zone(pv: dict) -> str:
    """A PersistentVolume's zone pin: the topology label, else the first
    zone value in spec.nodeAffinity required terms (how provisioners
    express zonal volumes)."""
    from ..api.info import ZONE_LABEL

    labels = pv.get("metadata", {}).get("labels", {})
    zone = labels.get(ZONE_LABEL) or labels.get(
        "failure-domain.beta.kubernetes.io/zone"
    )
    if zone:
        return zone
    req = (
        pv.get("spec", {}).get("nodeAffinity", {}).get("required", {})
        or {}
    )
    for term in req.get("nodeSelectorTerms", []) or []:
        for expr in term.get("matchExpressions", []) or []:
            # only a SINGLE-value In term is a pin: NotIn/Gt/Lt would be
            # misread as pinning to the EXCLUDED zone, and a multi-value
            # In (regional PV) legally attaches in any listed zone — the
            # single-zone class predicate cannot express that, so leave
            # it unconstrained here; the volume binder re-checks zones at
            # actuation (cache/sim.py FakeVolumeBinder, the reference's
            # AllocateVolumes seam)
            if (
                expr.get("key")
                in (ZONE_LABEL, "failure-domain.beta.kubernetes.io/zone")
                and expr.get("operator", "In") == "In"
                and len(expr.get("values") or ()) == 1
            ):
                return expr["values"][0]
    return ""


def pod_to_task(pod: dict, job_uid: str, volume_zone: str = "",
                n_attach: int = 0) -> TaskInfo:
    md = pod.get("metadata", {})
    spec = pod.get("spec", {})
    ports = tuple(
        p["hostPort"]
        for c in spec.get("containers", [])
        for p in c.get("ports", [])
        if "hostPort" in p
    )
    aff = spec.get("affinity", {}).get("nodeAffinity", {})
    required = aff.get("requiredDuringSchedulingIgnoredDuringExecution", {})
    # ALL nodeSelectorTerms, ORed across terms with expressions ANDed
    # within one — the vendored MatchNodeSelectorTerms semantics
    # (helpers.go:303-315) PodMatchNodeSelector adapts
    node_aff = tuple(
        _match_expressions(term.get("matchExpressions"))
        for term in required.get("nodeSelectorTerms", [])
    )
    tolerations = [
        Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in spec.get("tolerations", [])
    ]
    return TaskInfo(
        uid=md.get("uid") or f"{md.get('namespace', 'default')}/{md['name']}",
        job_uid=job_uid,
        name=md["name"],
        namespace=md.get("namespace", "default"),
        resreq=pod_resreq(pod, n_attach),
        node_name=spec.get("nodeName", ""),
        status=pod_status(pod),
        volume_zone=volume_zone,
        # k8s semantics: unset pod priority means 0 (job_info.go:66-70
        # reads *pod.Spec.Priority only when present)
        priority=int(spec.get("priority") or 0),
        node_selector=dict(spec.get("nodeSelector", {})),
        node_affinity=node_aff,
        tolerations=tolerations,
        host_ports=ports,
        labels=dict(md.get("labels", {})),
        affinity_terms=_pod_affinity_terms(spec),
    )


def pod_to_task_block(pod: dict, job_uid: str, rr_memo: dict) -> TaskInfo:
    """:func:`pod_to_task` for a claim-free pod inside an ingest block,
    field-identical to ``pod_to_task(pod, job_uid, "", 0)`` but with the
    per-row constants folded out: container-request parsing is memoized
    per distinct raw value shape (churn blocks repeat a handful of
    container shapes; each hit hands back a private copy so no two tasks
    share a resreq array), the affinity/toleration sub-parses only run
    when the spec carries those stanzas, and TaskInfo is built without
    re-running ``__init__``/``__post_init__`` — every field below is
    already in the canonical form the constructor would normalize to
    (``node_affinity`` is terms-of-expressions, on which
    ``normalize_node_affinity`` is value-identity)."""
    md = pod.get("metadata", {})
    spec = pod.get("spec", {})
    containers = spec.get("containers", [])
    resreq = None
    if len(containers) == 1:
        reqs = containers[0].get("resources", {}).get("requests", {})
        try:
            key = (reqs.get("cpu"), reqs.get("memory"), reqs.get("nvidia.com/gpu"))
            resreq = rr_memo.get(key)
            if resreq is None:
                resreq = rr_memo[key] = pod_resreq(pod, 0)
            resreq = resreq.copy()
        except TypeError:
            resreq = None  # unhashable request value: parse straight
    if resreq is None:
        resreq = pod_resreq(pod, 0)
    ports: Tuple[int, ...] = ()
    if any(c.get("ports") for c in containers):
        ports = tuple(
            p["hostPort"]
            for c in containers
            for p in c.get("ports", [])
            if "hostPort" in p
        )
    node_aff: Tuple = ()
    terms: Tuple = ()
    aff = spec.get("affinity")
    if aff:
        required = aff.get("nodeAffinity", {}).get(
            "requiredDuringSchedulingIgnoredDuringExecution", {}
        )
        node_aff = tuple(
            _match_expressions(term.get("matchExpressions"))
            for term in required.get("nodeSelectorTerms", [])
        )
        terms = _pod_affinity_terms(spec)
    tol_raw = spec.get("tolerations")
    tolerations = (
        [
            Toleration(
                key=t.get("key", ""),
                operator=t.get("operator", "Equal"),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
            for t in tol_raw
        ]
        if tol_raw
        else []
    )
    task = TaskInfo.__new__(TaskInfo)
    task.__dict__.update(
        uid=md.get("uid") or f"{md.get('namespace', 'default')}/{md['name']}",
        job_uid=job_uid,
        name=md["name"],
        namespace=md.get("namespace", "default"),
        resreq=resreq,
        node_name=spec.get("nodeName", ""),
        status=pod_status(pod),
        priority=int(spec.get("priority") or 0),
        node_selector=dict(spec.get("nodeSelector", {})),
        node_affinity=node_aff,
        tolerations=tolerations,
        host_ports=ports,
        labels=dict(md.get("labels", {})),
        affinity_terms=terms,
        volume_zone="",
        ordinal=-1,
    )
    return task


def node_to_info(node: dict) -> NodeInfo:
    md = node.get("metadata", {})
    st = node.get("status", {})
    alloc = st.get("allocatable", st.get("capacity", {}))
    cpu = parse_cpu_milli(alloc.get("cpu", 0))
    mem = parse_memory_bytes(alloc.get("memory", 0))
    gpu = float(alloc.get("nvidia.com/gpu", 0)) * 1000.0
    # volume attach limit (the 4th resource axis): kubelets publish
    # per-driver "attachable-volumes-<driver>" allocatable keys; sum them
    # when PRESENT (an explicit 0 means zero attachments), defaulting to
    # the sim's 40 when none are published
    attach_keys = [k for k in alloc if k.startswith("attachable-volumes")]
    attach = (
        sum(float(alloc[k]) for k in attach_keys) if attach_keys else 40.0
    )
    taints = [
        Taint(key=t.get("key", ""), value=t.get("value", ""), effect=t.get("effect", ""))
        for t in node.get("spec", {}).get("taints", [])
    ]
    labels = dict(md.get("labels", {}))
    # the kubelet guarantees the hostname label on every node; pod
    # (anti-)affinity over topology_key=hostname depends on it for its
    # per-node domains, so default it like a real cluster would
    labels.setdefault("kubernetes.io/hostname", md["name"])
    return NodeInfo(
        name=md["name"],
        allocatable=res.make(cpu, mem, gpu, attach),
        capability=res.make(cpu, mem, gpu, attach),
        max_tasks=int(alloc.get("pods", 110)),
        labels=labels,
        taints=taints,
        unschedulable=bool(node.get("spec", {}).get("unschedulable", False)),
    )


def _job_uid_for_pod(pod: dict) -> str:
    """Job identity resolution: PodGroup annotation, then ownerReference,
    then the pod itself (apis/utils/utils.go:18-34 GetController fallback)."""
    md = pod.get("metadata", {})
    ns = md.get("namespace", "default")
    group = md.get("annotations", {}).get(GROUP_ANNOTATION)
    if group:
        return f"{ns}/{group}"
    owners = md.get("ownerReferences", [])
    if owners:
        return f"{ns}/owner-{owners[0].get('uid') or owners[0].get('name')}"
    return f"{ns}/pod-{md.get('uid') or md['name']}"


class LiveCache:
    """Cluster model fed by list/watch; actuation through the apiserver.

    Drop-in backend for :class:`framework.Scheduler` (same duck-typed
    surface as :class:`SimCluster`)."""

    def __init__(self, api: FakeApiServer, now_fn=None, batch_ingest=None):
        self.api = api
        # injectable clock (tests run on a virtual clock so
        # GC delays and staleness gauges are deterministic)
        self._now = now_fn or _time.time
        # batched watch ingest (default on; KAT_BATCH_INGEST=0 or the
        # ctor arg force the per-event scalar path — the parity soak and
        # the ingest bench drive both)
        if batch_ingest is None:
            batch_ingest = os.environ.get("KAT_BATCH_INGEST", "1") != "0"
        self.batch_ingest = bool(batch_ingest)
        self.cluster = ClusterInfo()
        self.events: List[Event] = []
        self.resync_queue: List[str] = []
        self._watch_rv = 0
        self._listed = False
        # task uid -> (namespace, pod name) for actuation verbs
        self._pod_ref: Dict[str, Tuple[str, str]] = {}
        # job uid -> (namespace, podgroup name) for status write-back
        self._pg_ref: Dict[str, Tuple[str, str]] = {}
        self._deleted_jobs: List[Tuple[str, float]] = []
        self._task_by_uid: Dict[str, TaskInfo] = {}
        self._other_by_uid: Dict[str, TaskInfo] = {}
        # volume plane (cache.go:230-238): PV/PVC/StorageClass objects plus
        # the claim -> pod reverse index used to retranslate pods when a
        # late PV/PVC event changes their zone/attach constraints.
        # _raw_pod holds raw dicts for PVC-BEARING pods only (they are the
        # only retranslation targets; keeping every pod would double
        # live-plane memory at 100k-pod scale); _pv_claims is the
        # volumeName -> claims reverse index so a PV event resolves its
        # bound claims in O(1) instead of scanning every indexed claim.
        self._pvs: Dict[str, dict] = {}
        self._pvcs: Dict[Tuple[str, str], dict] = {}
        self._scs: Dict[str, dict] = {}
        self._raw_pod: Dict[str, dict] = {}
        self._claim_pods: Dict[Tuple[str, str], set] = {}
        self._pv_claims: Dict[str, set] = {}
        self._last_sync_ts: Optional[float] = None
        # incremental snapshot plane (cache/arena.py SnapshotArena): when
        # attached, watch handlers publish deltas — row-level dirt for
        # in-place pod/node churn, structural events for set membership
        # changes the arena cannot patch.  None = no arena.
        self.delta_sink = None
        # delta delivery callback: called with the applied event count
        # after every sync() that applied any — the hook idle waiters and
        # the reference's pipelined executor's ingest observability ride on.
        self.on_events = None
        # resource -> handler, built ONCE (satellite fix: the dispatch
        # dict used to be rebuilt per event — pure overhead on 10k-event
        # pumps).  Read-only after construction, so no sanitizer guard.
        self._handlers = {
            "pods": self._on_pod,
            "nodes": self._on_node,
            "podgroups": self._on_podgroup,
            "queues": self._on_queue,
            "namespaces": self._on_namespace,
            "pdbs": self._on_pdb,
            "persistentvolumes": self._on_pv,
            "persistentvolumeclaims": self._on_pvc,
            "storageclasses": self._on_storageclass,
        }
        if locking.sanitize_enabled():
            # the live plane is lock-free BY CONTRACT: one pump thread
            # owns all mutation (informer discipline).  Single-writer
            # mode makes the sanitizer prove it — the first thread to
            # mutate after construction claims the cache; any other
            # thread's write is a finding.
            locking.register_guarded(
                None, self,
                (
                    "cluster", "events", "resync_queue", "_watch_rv",
                    "_listed", "_pod_ref", "_pg_ref", "_deleted_jobs",
                    "_task_by_uid", "_other_by_uid", "_pvs", "_pvcs",
                    "_scs", "_raw_pod", "_claim_pods", "_pv_claims",
                    "_last_sync_ts",
                ),
                name="LiveCache",
            )

    # ---- informer pump ----

    # LIST order puts pods last so their nodes/queues/groups exist first;
    # the WATCH phase preserves the apiserver's global event order instead
    # (a real informer set gives no cross-resource ordering; nodes-first
    # list + placeholder nodes cover the gap like event_handlers.go's
    # auto-created empty NodeInfo).
    _LIST_ORDER = ("nodes", "queues", "namespaces", "storageclasses",
                   "persistentvolumes", "persistentvolumeclaims",
                   "podgroups", "pdbs", "pods")

    def _reset_model(self) -> None:
        """410-Gone recovery: the watch window was compacted past our
        resourceVersion, so incremental catch-up is impossible — drop the
        whole model and relist from scratch (client-go's informer relist).
        Actuation refs rebuild during the LIST; the errTasks resync FIFO
        survives (its uids re-resolve against the fresh refs, and uids
        whose pods vanished are skipped like any deleted pod)."""
        self.cluster = ClusterInfo()
        self._watch_rv = 0
        self._listed = False
        self._pod_ref.clear()
        self._pg_ref.clear()
        self._deleted_jobs = []
        self._task_by_uid.clear()
        self._other_by_uid.clear()
        self._pvs.clear()
        self._pvcs.clear()
        self._scs.clear()
        self._raw_pod.clear()
        self._claim_pods.clear()
        self._pv_claims.clear()
        if self.delta_sink is not None:
            # the arena's ordinal maps all point into the dropped model
            self.delta_sink.structural("relist")

    def sync(self) -> int:
        """One pump: initial LIST then incremental WATCH; returns events
        applied (WaitForCacheSync + handler goroutines, cache.go:311-351,
        single-threaded)."""
        m = metrics()
        now = self._now()
        # model age at pump time: the gap since the previous pump is how
        # stale the snapshot the NEXT cycle builds from could have been
        if self._last_sync_ts is not None:
            m.gauge_set("cache_snapshot_staleness_seconds", now - self._last_sync_ts)
        self._last_sync_ts = now
        n = 0
        if not self._listed:
            first_rv = None
            for resource in self._LIST_ORDER:
                items, rv = self.api.list(resource)
                if first_rv is None:
                    first_rv = rv
                for obj in items:
                    self._dispatch(resource, ADDED, obj)
                    n += 1
            # Watch from the FIRST list's rv, not the last: a concurrent
            # writer (possible now that the apiserver is an HTTP service)
            # may touch an early-listed resource while later LISTs run;
            # starting low replays some events already reflected in later
            # lists, but every handler is an idempotent upsert/delete, so
            # duplicates are harmless while a gap would be a permanently
            # stale object (informers watch from each LIST's own rv;
            # one global ordered stream lets one low-water mark do it).
            self._watch_rv = max(self._watch_rv, first_rv or 0)
            self._listed = True
            m.counter_add("cache_watch_events_total", n, labels={"phase": "list"})
            if n and self.on_events is not None:
                self.on_events(n)
            return n
        try:
            events = self.api.watch_all(self._watch_rv)
        except ApiError as err:
            # the watch window was compacted past us: relist (the informer
            # response to 410).  Matched by status, not type: the HTTP
            # backend re-raises the server's GoneError as a plain
            # ApiError(status=410) after the wire crossing.  The
            # recursive call takes the LIST branch.
            if err.status != 410:
                raise
            m.counter_add("cache_relists_total")
            self._reset_model()
            return self.sync()
        if self.batch_ingest:
            n = self._apply_event_blocks(events)
        else:
            for rv, resource, etype, obj in events:
                self._dispatch(resource, etype, obj)
                self._watch_rv = rv
                n += 1
            if n:
                m.counter_add(
                    "cache_ingest_rows_total", n, labels={"path": "scalar"}
                )
        m.counter_add("cache_watch_events_total", n, labels={"phase": "watch"})
        if n and self.on_events is not None:
            self.on_events(n)
        return n

    def event_waiter(
        self,
        timeout_s: float = 30.0,
        poll_s: float = 0.5,
        sleep_fn=None,
    ):
        """Build a ``Scheduler.wait_for_event`` seam fed by watch
        delivery: the returned callable pumps :meth:`sync` until the
        apiserver delivers at least one event (True — keep scheduling)
        or ``timeout_s`` of model time elapses (False — exit the loop).
        ``sleep_fn`` is injectable (tests hand a virtual clock's
        sleep); the watches being pull-based, waiting IS polling."""
        sleep = sleep_fn or _time.sleep

        def wait() -> bool:
            deadline = self._now() + timeout_s
            while True:
                if self.sync() > 0:
                    return True
                if self._now() >= deadline:
                    return False
                sleep(poll_s)

        return wait

    def _dispatch(self, resource: str, etype: str, obj: dict) -> None:
        # every scalar-path watch event funnels through here: no blocking
        # calls, no per-element allocation
        handler = self._handlers.get(resource)
        if handler is None:
            return  # kinds the scheduler does not watch (e.g. configmaps)
        handler(etype, obj)

    # ---- batched ingest (the columnar event-block path) ----

    def _apply_event_blocks(self, events) -> int:
        """Batched WATCH application: runs of row-local pod MODIFYs (the
        churn-dominant shape — status flips, kubelet phase updates)
        accumulate into one columnar block applied by
        :meth:`_on_pod_block` with ONE batched delta-sink call; any
        other event flushes the pending block first and takes the
        scalar path, so the apiserver's total event order is preserved
        and completeness never bears correctness.  ``_watch_rv`` only
        advances past a blocked event once its block has applied."""
        n = 0
        batched = 0
        block: List[dict] = []
        block_rv = 0
        for rv, resource, etype, obj in events:
            if (
                resource == "pods"
                and etype == MODIFIED
                and self._pod_block_eligible(obj)
            ):
                block.append(obj)
                block_rv = rv
                continue
            if block:
                self._on_pod_block(block)
                n += len(block)
                batched += len(block)
                self._watch_rv = block_rv
                block = []
            self._dispatch(resource, etype, obj)
            self._watch_rv = rv
            n += 1
        if block:
            self._on_pod_block(block)
            n += len(block)
            batched += len(block)
            self._watch_rv = block_rv
        if n:
            m = metrics()
            if batched:
                m.counter_add(
                    "cache_ingest_rows_total", batched,
                    labels={"path": "batched"},
                )
            if n - batched:
                m.counter_add(
                    "cache_ingest_rows_total", n - batched,
                    labels={"path": "scalar"},
                )
        return n

    def _pod_block_eligible(self, pod: dict) -> bool:
        """Cheap structural probes deciding whether a pod MODIFY is
        row-local (blockable) or must take the scalar handler.  Every
        check mirrors a structural/classification branch of
        :meth:`_on_pod` — anything that could change set membership,
        job membership, the volume plane, or materialize a placeholder
        node falls out to the scalar path.  Eligibility is stable
        across a block: blocked events never add/remove model members,
        so a verdict taken at stream-walk time still holds at flush."""
        md = pod.get("metadata", {})
        name = md.get("name")
        if not name:
            return False  # malformed: let the scalar path raise/refuse
        uid = md.get("uid") or f"{md.get('namespace', 'default')}/{name}"
        old = self._task_by_uid.get(uid)
        if old is None:
            return False  # not ours or not modeled: membership may change
        if uid in self._raw_pod or pod_claims(pod):
            return False  # volume plane implicated: retranslation path
        spec = pod.get("spec", {})
        if spec.get("schedulerName", "") != options().scheduler_name:
            return False  # ours -> foreign flip is structural
        if _job_uid_for_pod(pod) != old.job_uid:
            return False  # job membership change is structural
        if old.job_uid not in self.cluster.jobs:
            return False  # shadow-job creation: scalar handles it
        node = spec.get("nodeName") or ""
        if node and node not in self.cluster.nodes:
            return False  # placeholder-node materialization is structural
        return True

    def _on_pod_block(self, pods: List[dict]) -> None:
        """Apply one columnar block of eligible pod MODIFYs: per row the
        same updatePod == deletePod + addPod model mutation as
        :meth:`_on_pod_inner` (restricted to the row-local shape
        :meth:`_pod_block_eligible` admitted), with the whole block's
        row dirt emitted as ONE ``task_dirty_rows`` delta-sink call —
        the upstream half of the columnar cycle.  The only per-entity
        python left is the wire translation (``pod_to_task``)."""
        sink = self.delta_sink
        col_uids: List[str] = []
        col_nodes: List[str] = []
        rr_memo: dict = {}  # block-scoped container-request parse memo
        for pod in pods:
            md = pod.get("metadata", {})
            uid = md.get("uid") or f"{md.get('namespace', 'default')}/{md['name']}"
            old = self._task_by_uid.get(uid)
            if old is None:
                # raced out of eligibility (defensive; the pump is
                # single-threaded): the scalar handler classifies it
                self._on_pod(MODIFIED, pod)
                continue
            old_node = old.node_name
            if old_node and old_node in self.cluster.nodes:
                node = self.cluster.nodes[old_node]
                if uid in node.tasks:
                    node.remove_task(old)
            job = self.cluster.jobs[old.job_uid]
            # eligibility guaranteed a claim-free pod: zone ""/0 attach,
            # exactly what _volume_info returns for one
            t = pod_to_task_block(pod, old.job_uid, rr_memo)
            job.add_task(t)  # dict upsert: replaces the old row
            job.priority = max(job.priority, t.priority)
            if t.node_name:
                self._host_task(t)
            self._task_by_uid[uid] = t
            self._pod_ref[uid] = (t.namespace, md["name"])
            if sink is not None:
                col_uids.append(uid)
                col_nodes.append(old_node)
                if t.node_name and t.node_name != old_node:
                    # rare (an external rebind): same classification the
                    # scalar wrapper emits
                    sink.node_dirty(t.node_name)
        if sink is not None and col_uids:
            sink.task_dirty_rows(col_uids, col_nodes)

    # ---- handlers (event_handlers.go) ----

    def _remove_task(self, uid: str) -> None:
        t = self._task_by_uid.pop(uid, None)
        if t is not None:
            if t.node_name and t.node_name in self.cluster.nodes:
                node = self.cluster.nodes[t.node_name]
                if uid in node.tasks:
                    node.remove_task(t)
            job = self.cluster.jobs.get(t.job_uid)
            if job is not None:
                job.tasks.pop(uid, None)
        o = self._other_by_uid.pop(uid, None)
        if o is not None:
            if o.node_name and o.node_name in self.cluster.nodes:
                node = self.cluster.nodes[o.node_name]
                if uid in node.tasks:
                    node.remove_task(o)
            self.cluster.others = [x for x in self.cluster.others if x.uid != uid]

    def _host_task(self, t: TaskInfo) -> None:
        """Account the task on its node; a node the informer has not
        delivered yet gets an empty placeholder (event_handlers.go's
        auto-created NodeInfo) whose accounting is skipped until the real
        node object re-hosts its tasks."""
        node = self.cluster.nodes.get(t.node_name)
        if node is None:
            node = NodeInfo(name=t.node_name)
            self.cluster.nodes[t.node_name] = node
        try:
            node.add_task(t)
        except ValueError as err:
            # overcommitted or placeholder node: keep the task in the model
            # without node accounting; the node update re-hosts it
            self.record_event("Unschedulable", t.uid, "NodeOvercommit", str(err))

    def _volume_info(self, pod: dict) -> Tuple[str, int]:
        """Resolve the pod's PVC-backed volumes through the ingested
        PVC -> PV chain: (zone pin, attach count).  An unbound PVC (e.g. a
        WaitForFirstConsumer class) still consumes an attach slot but pins
        no zone — the binder resolves it at actuation, like the
        reference's AllocateVolumes (interface.go:42-49)."""
        md = pod.get("metadata", {})
        ns = md.get("namespace", "default")
        zones = []
        claims = pod_claims(pod)
        for claim in claims:
            pvc = self._pvcs.get((ns, claim))
            if not pvc:
                continue
            vol = pvc.get("spec", {}).get("volumeName", "")
            pv = self._pvs.get(vol)
            if pv:
                z = pv_zone(pv)
                if z and z not in zones:
                    zones.append(z)
        if len(zones) > 1:
            # PVs in conflicting zones: no node can attach all volumes —
            # the reference's VolumeZone predicate fails every node and
            # the pod stays Pending; pin to an impossible sentinel zone
            # (matches no node label) for the same effect, and say why
            self.record_event(
                "Unschedulable",
                md.get("uid") or f"{ns}/{md.get('name', '?')}",
                "VolumeZoneConflict",
                f"volumes pinned to conflicting zones {zones}",
            )
            return "\x00conflicting-zones", len(claims)
        return (zones[0] if zones else ""), len(claims)

    def _index_claims(self, uid: str, pod: dict) -> None:
        ns = pod.get("metadata", {}).get("namespace", "default")
        for claim in pod_claims(pod):
            self._claim_pods.setdefault((ns, claim), set()).add(uid)

    def _unindex_claims(self, uid: str) -> None:
        pod = self._raw_pod.get(uid)
        if pod is None:
            return
        ns = pod.get("metadata", {}).get("namespace", "default")
        for claim in pod_claims(pod):
            members = self._claim_pods.get((ns, claim))
            if members is not None:
                members.discard(uid)
                if not members:
                    del self._claim_pods[(ns, claim)]

    def _on_pod(self, etype: str, pod: dict) -> None:
        """Pod handler + arena delta classification: an in-place update of
        a pod we already model is row-level dirt (the arena refreshes the
        task/node rows and its guards catch signature drift); a pod
        entering or leaving the model — or switching between ours and
        another scheduler's — changes set membership and is structural."""
        sink = self.delta_sink
        if sink is None:
            return self._on_pod_inner(etype, pod)
        md = pod.get("metadata", {})
        uid = md.get("uid") or f"{md.get('namespace', 'default')}/{md['name']}"
        old = self._task_by_uid.get(uid)
        old_other = self._other_by_uid.get(uid)
        prev = old if old is not None else old_other
        old_node = prev.node_name if prev is not None else ""
        old_job = old.job_uid if old is not None else None
        n_nodes = len(self.cluster.nodes)
        self._on_pod_inner(etype, pod)
        if len(self.cluster.nodes) != n_nodes:
            sink.structural("node_added")  # placeholder node materialized
        new = self._task_by_uid.get(uid)
        new_other = self._other_by_uid.get(uid)
        if (old is None) != (new is None) or (old_other is None) != (new_other is None):
            sink.structural("task_set")
        elif new is not None:
            if new.job_uid != old_job:
                sink.structural("job_membership")
            else:
                sink.task_dirty(uid, old_node)
                if new.node_name and new.node_name != old_node:
                    sink.node_dirty(new.node_name)
        elif new_other is not None:
            # foreign pods surface only through node accounting and the
            # per-pack others_used recompute — node dirt is enough
            if old_node:
                sink.node_dirty(old_node)
            if new_other.node_name:
                sink.node_dirty(new_other.node_name)

    def _on_pod_inner(self, etype: str, pod: dict) -> None:
        md = pod.get("metadata", {})
        uid = md.get("uid") or f"{md.get('namespace', 'default')}/{md['name']}"
        # updatePod == deletePod + addPod (event_handlers.go:190-210)
        self._remove_task(uid)
        self._unindex_claims(uid)
        self._raw_pod.pop(uid, None)
        if etype == DELETED:
            self._pod_ref.pop(uid, None)
            return
        spec = pod.get("spec", {})
        responsible = spec.get("schedulerName", "") == options().scheduler_name
        assigned = bool(spec.get("nodeName"))
        status = pod_status(pod)
        terminal = status in (TaskStatus.SUCCEEDED, TaskStatus.FAILED)
        # informer filter (cache.go:254-272): our pods always; other
        # schedulers' pods only while assigned and non-terminated
        if not responsible and not (assigned and not terminal):
            return
        if pod_claims(pod):  # only PVC-bearing pods can need retranslation
            self._raw_pod[uid] = pod
            self._index_claims(uid, pod)
        volume_zone, n_attach = self._volume_info(pod)
        if responsible:
            job_uid = _job_uid_for_pod(pod)
            job = self.cluster.jobs.get(job_uid)
            if job is None:
                # shadow job until its PodGroup arrives (SetPodGroup's
                # queue resolution, job_info.go:166-186)
                ns = md.get("namespace", "default")
                queue = ns if options().namespace_as_queue else options().default_queue
                job = JobInfo(uid=job_uid, name=job_uid, namespace=ns, queue_uid=queue)
                self.cluster.jobs[job_uid] = job
            t = pod_to_task(pod, job_uid, volume_zone, n_attach)
            job.add_task(t)
            job.priority = max(job.priority, t.priority)
            if t.node_name:
                self._host_task(t)
            self._task_by_uid[uid] = t
            self._pod_ref[uid] = (t.namespace, md["name"])
        else:
            t = pod_to_task(pod, "", volume_zone, n_attach)
            self.cluster.others.append(t)
            self._host_task(t)
            self._other_by_uid[uid] = t

    # ---- volume-plane handlers (cache.go:230-238, :288-306) ----

    def _retranslate_claim(self, ns: str, claim: str) -> None:
        """A PV/PVC change can flip zone/attach constraints of pods already
        ingested (the LIST order makes this rare; WATCH races make it
        possible) — re-run the pod handler from the stored raw object."""
        for uid in list(self._claim_pods.get((ns, claim), ())):
            pod = self._raw_pod.get(uid)
            if pod is not None:
                self._on_pod(MODIFIED, pod)

    def _on_pv(self, etype: str, pv: dict) -> None:
        name = pv["metadata"]["name"]
        if etype == DELETED:
            self._pvs.pop(name, None)
        else:
            self._pvs[name] = pv
        # retranslate pods whose bound claims reference this PV (O(1) via
        # the volumeName reverse index maintained by _on_pvc)
        for ns, claim in list(self._pv_claims.get(name, ())):
            self._retranslate_claim(ns, claim)

    def _on_pvc(self, etype: str, pvc: dict) -> None:
        md = pvc.get("metadata", {})
        key = (md.get("namespace", "default"), md["name"])
        old = self._pvcs.get(key)
        old_vol = (old or {}).get("spec", {}).get("volumeName", "")
        if old_vol:
            members = self._pv_claims.get(old_vol)
            if members is not None:
                members.discard(key)
                if not members:  # prune: dynamic provisioning churns names
                    del self._pv_claims[old_vol]
        if etype == DELETED:
            self._pvcs.pop(key, None)
        else:
            self._pvcs[key] = pvc
            vol = pvc.get("spec", {}).get("volumeName", "")
            if vol:
                self._pv_claims.setdefault(vol, set()).add(key)
        self._retranslate_claim(*key)

    def _on_storageclass(self, etype: str, sc: dict) -> None:
        name = sc["metadata"]["name"]
        if etype == DELETED:
            self._scs.pop(name, None)
        else:
            self._scs[name] = sc

    def _on_node(self, etype: str, node_obj: dict) -> None:
        name = node_obj["metadata"]["name"]
        old = self.cluster.nodes.get(name)
        sink = self.delta_sink
        if sink is not None:
            if etype == DELETED or old is None:
                sink.structural("node_set")
            else:
                # in-place update: the arena refreshes the node's rows and
                # falls back itself if the property signature changed
                sink.node_dirty(name)
        if etype == DELETED:
            if old is not None:
                del self.cluster.nodes[name]
            return
        fresh = node_to_info(node_obj)
        # re-host existing tasks, then adopt tasks that referenced this
        # node before it was listed; an overcommit (node shrank below its
        # hosted usage, or placeholder adoption raced) must not kill the
        # watch loop — the task stays in the model without node accounting
        # and the next update re-hosts it (same tolerance as _host_task)
        hostees = list(old.tasks.values()) if old is not None else []
        for t in list(self._task_by_uid.values()) + list(self._other_by_uid.values()):
            if t.node_name == name and t.uid not in {x.uid for x in hostees}:
                hostees.append(t)
        for t in hostees:
            try:
                fresh.add_task(t)
            except ValueError as err:
                self.record_event("Unschedulable", t.uid, "NodeOvercommit", str(err))
        self.cluster.nodes[name] = fresh

    def _on_podgroup(self, etype: str, pg: dict) -> None:
        md = pg.get("metadata", {})
        ns = md.get("namespace", "default")
        job_uid = f"{ns}/{md['name']}"
        if etype == DELETED:
            self._pg_ref.pop(job_uid, None)
            self._deleted_jobs.append((job_uid, self._now()))
            return
        job = self.cluster.jobs.get(job_uid)
        if job is None:
            job = JobInfo(uid=job_uid, name=md["name"], namespace=ns)
            self.cluster.jobs[job_uid] = job
            if self.delta_sink is not None:
                self.delta_sink.structural("job_added")
        # a modified PodGroup (minMember/queue/creation_ts) needs no delta:
        # the arena recomputes the whole job plane every pack
        spec = pg.get("spec", {})
        job.name = md["name"]
        job.min_available = int(spec.get("minMember", 0))
        # queue resolution (job_info.go:166-186): PodGroup queue >
        # namespace-as-queue > --default-queue
        if spec.get("queue"):
            job.queue_uid = spec["queue"]
        elif options().namespace_as_queue:
            job.queue_uid = ns
        else:
            job.queue_uid = options().default_queue
        ts = md.get("creationTimestamp")
        if isinstance(ts, (int, float)):
            job.creation_ts = float(ts)
        self._pg_ref[job_uid] = (ns, md["name"])

    def _on_queue(self, etype: str, q: dict) -> None:
        if options().namespace_as_queue:
            return  # namespaces back the queues instead (cache.go:290-306)
        name = q["metadata"]["name"]
        self._emit_queue_set(name, etype)
        if etype == DELETED:
            self.cluster.queues.pop(name, None)
            return
        self.cluster.queues[name] = QueueInfo(
            uid=name, name=name, weight=int(q.get("spec", {}).get("weight", 1))
        )

    def _emit_queue_set(self, name: str, etype: str) -> None:
        """Queue set-membership delta; weight-only updates need none (the
        arena recomputes the queue plane every pack)."""
        if self.delta_sink is None:
            return
        existed = name in self.cluster.queues
        if (etype == DELETED) == existed:
            self.delta_sink.structural("queue_set")

    def _on_namespace(self, etype: str, ns_obj: dict) -> None:
        if not options().namespace_as_queue:
            return
        name = ns_obj["metadata"]["name"]
        self._emit_queue_set(name, etype)
        if etype == DELETED:
            self.cluster.queues.pop(name, None)
            return
        # namespace-as-queue: weight fixed at 1 (cache.go:290-306)
        self.cluster.queues[name] = QueueInfo(uid=name, name=name, weight=1)

    def _on_pdb(self, etype: str, pdb: dict) -> None:
        md = pdb.get("metadata", {})
        ns = md.get("namespace", "default")
        job_uid = f"{ns}/{md['name']}"
        if etype == DELETED:
            job = self.cluster.jobs.get(job_uid)
            if job is not None:
                job.unset_pdb()
            return
        from ..api.info import PDBInfo

        job = self.cluster.jobs.get(job_uid)
        if job is None:
            job = JobInfo(uid=job_uid, namespace=ns)
            self.cluster.jobs[job_uid] = job
            if self.delta_sink is not None:
                self.delta_sink.structural("job_added")
        job.set_pdb(
            PDBInfo(
                name=md["name"],
                namespace=ns,
                min_available=int(pdb.get("spec", {}).get("minAvailable", 0)),
            ),
            default_queue=options().default_queue,
        )

    # ---- Scheduler backend surface ----

    def record_event(self, kind: str, object_uid: str, reason: str, message: str = "") -> None:
        self.events.append(Event(kind=kind, object_uid=object_uid, reason=reason, message=message))

    def apply_binds(self, binds: Sequence[BindIntent]):
        """POST the binding subresource per intent (async goroutine in the
        reference, cache.go:437-444); failures divert to the resync FIFO.
        Returns the uids that did NOT actuate (diverted or vanished) —
        the decision audit plane marks their rows unactuated so the
        audit trail reconciles with the store, not the intent list."""
        failed = []
        for b in binds:
            ref = self._pod_ref.get(b.task_uid)
            if ref is None:
                failed.append(b.task_uid)
                continue  # pod vanished between snapshot and actuation
            try:
                self.api.bind_pod(ref[0], ref[1], b.node_name)
            except ApiError as err:
                self._defer_resync(b.task_uid, "Bind", str(err))
                failed.append(b.task_uid)
        return failed

    def apply_evicts(self, evicts: Sequence[EvictIntent]):
        failed = []
        for e in evicts:
            ref = self._pod_ref.get(e.task_uid)
            if ref is None:
                failed.append(e.task_uid)
                continue
            try:
                self.api.evict_pod(ref[0], ref[1])
            except ApiError as err:
                self._defer_resync(e.task_uid, "Evict", str(err))
                failed.append(e.task_uid)
                continue
            self.record_event("Evict", e.task_uid, "Evict")
        return failed

    def apply_binds_columnar(self, col):
        """:meth:`apply_binds` over a decode ``BindColumn``: no intent
        objects — the column's identity vectors drive the POST loop and
        wire objects materialize only inside each apiserver call."""
        failed = []
        nodes = col.node_names
        for k, uid in enumerate(col.uids):
            ref = self._pod_ref.get(uid)
            if ref is None:
                failed.append(uid)
                continue  # pod vanished between snapshot and actuation
            try:
                self.api.bind_pod(ref[0], ref[1], nodes[k])
            except ApiError as err:
                self._defer_resync(uid, "Bind", str(err))
                failed.append(uid)
        return failed

    def apply_evicts_columnar(self, col):
        """:meth:`apply_evicts` over a decode ``EvictColumn``."""
        failed = []
        for uid in col.uids:
            ref = self._pod_ref.get(uid)
            if ref is None:
                failed.append(uid)
                continue
            try:
                self.api.evict_pod(ref[0], ref[1])
            except ApiError as err:
                self._defer_resync(uid, "Evict", str(err))
                failed.append(uid)
                continue
            self.record_event("Evict", uid, "Evict")
        return failed

    def update_job_status(self, job_uid: str, status) -> None:
        """PUT PodGroup status (closeSession write-back,
        session.go:130-144 -> cache.go:665-675)."""
        ref = self._pg_ref.get(job_uid)
        if ref is None:
            return
        # wire phase strings per v1alpha1/types.go:28-39
        phase_name = getattr(status.phase, "name", str(status.phase)).capitalize()
        payload = {
            "phase": phase_name,
            "running": status.running,
            "succeeded": status.succeeded,
            "failed": status.failed,
            "conditions": [
                {
                    "type": c.type,
                    "status": c.status,
                    "reason": c.reason,
                    "message": c.message,
                }
                for c in status.conditions
            ],
        }
        try:
            self.api.update_podgroup_status(ref[0], ref[1], payload)
        except ApiError:
            pass  # status write-back is best-effort (reference logs only)

    def update_pod_condition(self, task_uid: str, message: str) -> None:
        """PATCH PodScheduled=False + reason onto the pod
        (taskUnschedulable, cache.go:456-474)."""
        ref = self._pod_ref.get(task_uid)
        if ref is None:
            return
        try:
            self.api.update_pod_condition(
                ref[0],
                ref[1],
                {
                    "type": "PodScheduled",
                    "status": "False",
                    "reason": "Unschedulable",
                    "message": message,
                },
            )
        except ApiError:
            pass  # condition write-back is best-effort (reference logs only)

    def _defer_resync(self, task_uid: str, op: str, message: str) -> None:
        self.resync_queue.append(task_uid)
        self.record_event("FailedScheduling", task_uid, op, message)

    def process_resync(self) -> int:
        """Pump the watch plane, then drain errTasks by re-GETting each pod
        and re-syncing it into the model (cache.go:519-547)."""
        # depth BEFORE the drain: a persistently non-zero gauge is the
        # "actuation keeps failing" signal (errTasks backlog)
        metrics().gauge_set("cache_resync_depth", len(self.resync_queue))
        self.sync()
        repaired = 0
        queue, self.resync_queue = self.resync_queue, []
        for uid in queue:
            ref = self._pod_ref.get(uid)
            if ref is None:
                continue
            pod = self.api.get("pods", ref[0], ref[1])
            if pod is None:
                self._remove_task(uid)
                self._pod_ref.pop(uid, None)
                if self.delta_sink is not None:
                    self.delta_sink.structural("task_set")
            else:
                self._on_pod(MODIFIED, pod)
            repaired += 1
        return repaired

    def collect_garbage(self, now: Optional[float] = None, delay_s: float = 5.0) -> List[str]:
        """Deferred job GC (cache.go:476-517): a deleted PodGroup's job is
        removed once its delay elapsed and no live tasks remain."""
        now = now if now is not None else self._now()
        keep: List[Tuple[str, float]] = []
        collected: List[str] = []
        terminal = {TaskStatus.SUCCEEDED, TaskStatus.FAILED, TaskStatus.UNKNOWN}
        for uid, ts in self._deleted_jobs:
            job = self.cluster.jobs.get(uid)
            if job is None:
                continue
            if now - ts < delay_s or any(
                t.status not in terminal for t in job.tasks.values()
            ):
                keep.append((uid, ts))
                continue
            del self.cluster.jobs[uid]
            collected.append(uid)
        self._deleted_jobs = keep
        if collected and self.delta_sink is not None:
            self.delta_sink.structural("job_removed")
        return collected
