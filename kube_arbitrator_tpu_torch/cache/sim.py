"""Simulated cluster + fake binder/evictor: the actuation plane in sim mode
(the port's copy of kube_arbitrator_tpu/cache/sim.py).

Plays the role of the reference's cache with fake backends that its unit
tests construct (``actions/allocate/allocate_test.go:99-138``: fakeBinder
records binds into a map; fakeEvictor deletes pods) and of the e2e fixture
library (``test/e2e/util.go``) that fabricates gang jobs and nodes.

The SimCluster owns ClusterInfo state, applies committed decisions
(bind/evict intents) back into the model with the exact NodeInfo accounting,
and can generate synthetic clusters at benchmark scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import resource as res
from ..api.info import (
    ZONE_LABEL,
    ClusterInfo,
    JobInfo,
    MatchExpression,
    NodeInfo,
    PDBInfo,
    PodAffinityTerm,
    QueueInfo,
    Taint,
    TaskInfo,
    Toleration,
)
from ..api.types import TaskStatus
from ..options import options


@dataclasses.dataclass
class BindIntent:
    task_uid: str
    node_name: str


@dataclasses.dataclass
class EvictIntent:
    task_uid: str


@dataclasses.dataclass
class Event:
    """Kubernetes-Event equivalent (the user-facing channel,
    cache.go:402,:637-662)."""

    kind: str       # "Evict" | "Unschedulable" | "FailedScheduling"
    object_uid: str
    reason: str
    message: str = ""


class BindFailure(RuntimeError):
    """A binder/evictor backend error (the apiserver POST/DELETE failing);
    triggers the errTasks resync path (cache.go:519-547)."""


@dataclasses.dataclass
class FakeBinder:
    """Records binds, mirroring allocate_test.go's fakeBinder.  Set
    ``fail_uids`` to make specific binds raise (backend-error injection)."""

    binds: Dict[str, str] = dataclasses.field(default_factory=dict)
    fail_uids: set = dataclasses.field(default_factory=set)

    def bind(self, task_uid: str, node_name: str) -> None:
        if task_uid in self.fail_uids:
            raise BindFailure(f"bind {task_uid} failed")
        self.binds[task_uid] = node_name


@dataclasses.dataclass
class FakeEvictor:
    evicts: List[str] = dataclasses.field(default_factory=list)
    fail_uids: set = dataclasses.field(default_factory=set)

    def evict(self, task_uid: str) -> None:
        if task_uid in self.fail_uids:
            raise BindFailure(f"evict {task_uid} failed")
        self.evicts.append(task_uid)


@dataclasses.dataclass
class FakeVolumeBinder:
    """VolumeBinder (cache/interface.go:67-76: AllocateVolumes before node
    accounting, session.go:243-259; BindVolumes at dispatch, :295-316).

    The scheduler already rejects volume-infeasible placements up front —
    attach counts ride the resreq/allocatable 4th resource axis and PV
    zone pinning rides the predicate class table — so like the reference's
    volumebinder this is the actuation-time re-check: zone mismatch or
    attach-limit overflow (state raced since the snapshot) raises
    BindFailure, and the caller's gang-atomic batch rollback plus errTasks
    resync take over.  Tests inject failures via ``fail_*_uids``."""

    allocated: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    bound: List[str] = dataclasses.field(default_factory=list)
    fail_allocate_uids: set = dataclasses.field(default_factory=set)
    fail_bind_uids: set = dataclasses.field(default_factory=set)
    # wired by SimCluster so the re-checks can read live cluster state
    sim: Optional["SimCluster"] = None

    def allocate_volumes(self, task_uid: str, node_name: str, task=None) -> None:
        if task_uid in self.fail_allocate_uids:
            raise BindFailure(f"volume allocate {task_uid} failed")
        if self.sim is not None:
            # the caller (apply_binds) already resolved the task from its
            # batch index; task_by_uid is an O(jobs) scan per call and at
            # bench scale the per-bind scans dominated actuation
            if task is None:
                task = self.sim.cluster.task_by_uid(task_uid)
            node = self.sim.cluster.nodes.get(node_name)
            if task is not None and node is not None:
                zone = node.labels.get(ZONE_LABEL, "")
                if task.volume_zone and task.volume_zone != zone:
                    raise BindFailure(
                        f"volume zone {task.volume_zone} != node zone {zone or '<none>'}"
                    )
                if task.resreq[res.ATTACH] > node.idle[res.ATTACH] + res.EPSILON[res.ATTACH]:
                    raise BindFailure(f"attach limit exceeded on {node_name}")
        self.allocated.append((task_uid, node_name))

    def bind_volumes(self, task_uid: str) -> None:
        if task_uid in self.fail_bind_uids:
            raise BindFailure(f"volume bind {task_uid} failed")
        self.bound.append(task_uid)


class SimCluster:
    """Mutable cluster state + declarative builders + decision application."""

    def __init__(self) -> None:
        self.cluster = ClusterInfo()
        self.binder = FakeBinder()
        self.evictor = FakeEvictor()
        self.volume_binder = FakeVolumeBinder(sim=self)
        self.events: List[Event] = []  # record.EventRecorder equivalent
        # task uid -> PodScheduled=False message (taskUnschedulable channel)
        self.pod_conditions: Dict[str, str] = {}
        self._task_counter = 0
        # errTasks FIFO: binds/evicts whose backend call failed; a resync
        # pass re-reads the source of truth and repairs (cache.go:519-547)
        self.resync_queue: List[str] = []
        # deferred job GC FIFO (cache.go:476-517): (job uid, deletion ts)
        self._deleted_jobs: List[Tuple[str, float]] = []
        # incremental snapshot plane (cache/arena.py SnapshotArena): when
        # attached, every mutation publishes a delta so the arena can
        # refresh rows instead of rebuilding the pack.  None = no arena.
        self.delta_sink = None

    # ---- arena delta emission (no-ops when no arena is attached) ----

    def _emit_structural(self, reason: str) -> None:
        if self.delta_sink is not None:
            self.delta_sink.structural(reason)

    def _emit_task(self, uid: str, node_name: str = "") -> None:
        if self.delta_sink is not None:
            self.delta_sink.task_dirty(uid, node_name)

    def _emit_task_rows(self, uids: List[str], node_names: List[str]) -> None:
        """Batched delta emission: ONE ``task_dirty_rows`` sink call for
        a whole commit's row dirt (the columnar actuation paths), with a
        scalar fallback for sinks predating the batched surface.  Set
        semantics are identical to per-row ``_emit_task`` calls."""
        if self.delta_sink is None or not uids:
            return
        rows = getattr(self.delta_sink, "task_dirty_rows", None)
        if rows is not None:
            rows(uids, node_names)
        else:
            for u, n in zip(uids, node_names):
                self.delta_sink.task_dirty(u, n)

    def update_pod_condition(self, task_uid: str, message: str) -> None:
        """Record the PodScheduled=False condition (the fakeStatusUpdater
        analog of cache.go:456-474's taskUnschedulable)."""
        self.pod_conditions[task_uid] = message

    def record_event(self, kind: str, object_uid: str, reason: str, message: str = "") -> None:
        self.events.append(Event(kind, object_uid, reason, message))

    # ---- builders (e2e util.go fixture equivalents) ----

    def add_queue(self, name: str, weight: int = 1) -> QueueInfo:
        q = QueueInfo(uid=name, name=name, weight=weight)
        self.cluster.queues[name] = q
        self._emit_structural("queue_added")
        return q

    def add_namespace(self, name: str, weight: int = 1) -> Optional[QueueInfo]:
        """Namespace event under --enable-namespace-as-queue: each namespace
        is a queue (event_handlers.go:656-673; informer choice at
        cache.go:290-306).  A no-op when the option is off, like the
        reference's conditional informer registration."""
        if not options().namespace_as_queue:
            return None
        return self.add_queue(name, weight=weight)

    def add_pdb(self, name: str, min_available: int, namespace: str = "default") -> JobInfo:
        """PDB event: the PDB defines/updates the gang job keyed by it
        (event_handlers.go:458-473 setPDB; job created on demand)."""
        uid = f"{namespace}/{name}"
        job = self.cluster.jobs.get(uid)
        if job is None:
            job = JobInfo(uid=uid)
            self.cluster.jobs[uid] = job
        job.set_pdb(
            PDBInfo(name=name, namespace=namespace, min_available=min_available),
            default_queue=options().default_queue
            if not options().namespace_as_queue
            else "",
        )
        self._emit_structural("pdb")
        return job

    def delete_pdb(self, name: str, namespace: str = "default") -> None:
        """deletePDB (event_handlers.go:480-492): job loses its gang size."""
        job = self.cluster.jobs.get(f"{namespace}/{name}")
        if job is None:
            raise KeyError(f"{namespace}/{name}")
        job.unset_pdb()
        self._emit_structural("pdb")

    def add_node(
        self,
        name: str,
        cpu_milli: float = 4000,
        memory: float = 8 * 1024**3,
        gpu_milli: float = 0,
        max_tasks: int = 110,
        labels: Optional[Dict[str, str]] = None,
        taints: Sequence[Taint] = (),
        unschedulable: bool = False,
        attach_limit: int = 40,
    ) -> NodeInfo:
        n = NodeInfo(
            name=name,
            allocatable=res.make(cpu_milli, memory, gpu_milli, attach_limit),
            max_tasks=max_tasks,
            labels=dict(labels or {}),
            taints=list(taints),
            unschedulable=unschedulable,
        )
        self.cluster.nodes[name] = n
        self._emit_structural("node_added")
        return n

    def add_job(
        self,
        name: str,
        queue: Optional[str] = None,
        min_available: int = 0,
        priority: int = 0,
        creation_ts: float = 0.0,
        namespace: str = "default",
    ) -> JobInfo:
        # Queue resolution order of JobInfo.SetPodGroup (job_info.go:166-186):
        # explicit PodGroup queue > namespace (when namespace-as-queue) >
        # the --default-queue option.
        if queue is None:
            queue = namespace if options().namespace_as_queue else options().default_queue
        j = JobInfo(
            uid=name,
            name=name,
            namespace=namespace,
            queue_uid=queue,
            min_available=min_available,
            priority=priority,
            creation_ts=creation_ts,
        )
        self.cluster.jobs[name] = j
        self._emit_structural("job_added")
        return j

    def delete_job(self, uid: str, now: Optional[float] = None) -> None:
        """Mark a job deleted; actual removal is deferred through the GC
        FIFO (cache.go:476-517: deleteJob → processCleanupJob after delay)."""
        import time as _time

        if uid not in self.cluster.jobs:
            raise KeyError(uid)
        self._deleted_jobs.append((uid, now if now is not None else _time.time()))

    def collect_garbage(self, now: Optional[float] = None, delay_s: float = 5.0) -> List[str]:
        """Process the deferred-deletion FIFO: jobs whose delay elapsed and
        whose tasks are all terminal are removed; others are re-queued
        (cache.go:489-517 semantics).  Returns collected job uids."""
        import time as _time

        now = now if now is not None else _time.time()
        keep: List[Tuple[str, float]] = []
        collected: List[str] = []
        terminal = {TaskStatus.SUCCEEDED, TaskStatus.FAILED, TaskStatus.UNKNOWN}
        for uid, ts in self._deleted_jobs:
            job = self.cluster.jobs.get(uid)
            if job is None:
                continue
            if now - ts < delay_s:
                keep.append((uid, ts))
                continue
            if any(t.status not in terminal for t in job.tasks.values()):
                keep.append((uid, ts))  # still has live tasks; retry later
                continue
            del self.cluster.jobs[uid]
            collected.append(uid)
        self._deleted_jobs = keep
        if collected:
            self._emit_structural("job_removed")
        return collected

    def add_task(
        self,
        job: JobInfo,
        cpu_milli: float = 0,
        memory: float = 0,
        gpu_milli: float = 0,
        status: TaskStatus = TaskStatus.PENDING,
        node: str = "",
        priority: int = 1,
        name: str = "",
        node_selector: Optional[Dict[str, str]] = None,
        node_affinity: Sequence[MatchExpression] = (),
        tolerations: Sequence[Toleration] = (),
        host_ports: Sequence[int] = (),
        labels: Optional[Dict[str, str]] = None,
        affinity: Sequence["PodAffinityTerm"] = (),
        volumes: int = 0,
        volume_zone: str = "",
    ) -> TaskInfo:
        self._task_counter += 1
        uid = name or f"{job.uid}-task-{self._task_counter:06d}"
        t = TaskInfo(
            uid=uid,
            job_uid=job.uid,
            name=uid,
            namespace=job.namespace,
            resreq=res.make(cpu_milli, memory, gpu_milli, volumes),
            volume_zone=volume_zone,
            status=status,
            node_name=node,
            priority=priority,
            node_selector=dict(node_selector or {}),
            node_affinity=tuple(node_affinity),
            tolerations=list(tolerations),
            host_ports=tuple(host_ports),
            labels=dict(labels or {}),
            affinity_terms=tuple(affinity),
        )
        # Node placement first: if accounting rejects the task we must not
        # leave a phantom entry in job.tasks.
        if node:
            self.cluster.nodes[node].add_task(t)
        job.add_task(t)
        self._emit_structural("task_added")
        return t

    def add_other_task(
        self, node: str, cpu_milli: float = 0, memory: float = 0, gpu_milli: float = 0
    ) -> TaskInfo:
        """A running task owned by another scheduler (ClusterInfo.Others)."""
        self._task_counter += 1
        t = TaskInfo(
            uid=f"other-{self._task_counter:06d}",
            job_uid="",
            resreq=res.make(cpu_milli, memory, gpu_milli),
            status=TaskStatus.RUNNING,
            node_name=node,
        )
        self.cluster.others.append(t)
        self.cluster.nodes[node].add_task(t)
        self._emit_structural("other_added")
        return t

    # ---- actuation ----

    def _task_index(self) -> Dict[str, TaskInfo]:
        return {uid: t for j in self.cluster.jobs.values() for uid, t in j.tasks.items()}

    def apply_binds(self, binds: Sequence[BindIntent]):
        """Commit bind intents: allocate volumes for the whole job first
        (gang-atomic: a volume failure drops the job's entire batch, the
        stronger form of session.go:243-259 failing the task before any
        accounting), then per task BindVolumes + Bind (session.go:295-316).
        Backend failures divert the task to the resync FIFO instead of
        raising (cache.go:437-444).  Returns the uids that did NOT
        actuate (the decision audit plane marks their rows unactuated)."""
        failed = []
        if not binds:
            return failed  # skip the O(cluster) index build on idle cycles
        index = self._task_index()
        by_job: Dict[str, List[BindIntent]] = {}
        for b in binds:
            task = index.get(b.task_uid)
            if task is None:
                raise KeyError(b.task_uid)
            by_job.setdefault(task.job_uid, []).append(b)
        for job_uid, job_binds in by_job.items():
            try:
                for b in job_binds:
                    self.volume_binder.allocate_volumes(
                        b.task_uid, b.node_name, task=index[b.task_uid]
                    )
            except BindFailure as err:
                for b in job_binds:
                    self._defer_resync(b.task_uid, "AllocateVolumes", str(err))
                    failed.append(b.task_uid)
                continue
            for b in job_binds:
                task = index[b.task_uid]
                node = self.cluster.nodes[b.node_name]
                try:
                    self.volume_binder.bind_volumes(b.task_uid)
                    self.binder.bind(b.task_uid, b.node_name)
                except BindFailure as err:
                    self._defer_resync(b.task_uid, "Bind", str(err))
                    failed.append(b.task_uid)
                    # no model change, but the emission is idempotent and
                    # keeps the failure path indistinguishable to the arena
                    self._emit_task(b.task_uid, b.node_name)
                    continue
                task.status = TaskStatus.BOUND
                task.node_name = b.node_name
                node.add_task(task)
                self._emit_task(b.task_uid, b.node_name)
        return failed

    def apply_evicts(self, evicts: Sequence[EvictIntent]):
        """Evict: running task -> Releasing on its node (cache.go:369-405).
        Returns the uids that did NOT actuate (diverted to resync)."""
        failed = []
        if not evicts:
            return failed
        index = self._task_index()
        for e in evicts:
            task = index.get(e.task_uid)
            if task is None:
                raise KeyError(e.task_uid)
            try:
                self.evictor.evict(e.task_uid)
            except BindFailure as err:
                self._defer_resync(e.task_uid, "Evict", str(err))
                failed.append(e.task_uid)
                continue
            if task.node_name:
                node = self.cluster.nodes[task.node_name]
                node.remove_task(task)
                task.status = TaskStatus.RELEASING
                node.add_task(task)
            else:
                task.status = TaskStatus.RELEASING
            self._emit_task(e.task_uid, task.node_name)
            self.record_event("Evict", e.task_uid, "Evict")
        return failed

    def _resolve_rows(self, col) -> List[TaskInfo]:
        """Resolve a column's rows to the CURRENT model task objects.

        The snapshot index entry for each row supplies the (uid, job_uid)
        identity hint, so the common case is two dict probes per row
        instead of the O(cluster) ``_task_index`` build; a hint miss (the
        live model replaced or re-owned the task since the snapshot)
        falls back to the full index once, preserving the object path's
        exact KeyError behavior for truly-vanished uids."""
        snap_tasks = col.index.tasks
        jobs = self.cluster.jobs
        out: List[TaskInfo] = []
        index = None
        for r in col.rows.tolist():
            hint = snap_tasks[r]
            job = jobs.get(hint.job_uid)
            task = job.tasks.get(hint.uid) if job is not None else None
            if task is None:
                if index is None:
                    index = self._task_index()
                task = index.get(hint.uid)
                if task is None:
                    raise KeyError(hint.uid)
            out.append(task)
        return out

    def _bind_batch_certificate(self, uids, nodes, tasks, reqs):
        """Prove (read-only) that committing the whole bind column can
        fail NOWHERE, so the batched commit may skip every per-row check.

        The certificate requires: no injected binder/volume failures
        armed; no task carries a volume-zone pin (zone re-checks are the
        one volume failure independent of capacity); every target node
        exists; no uid already sits on its target node nor repeats in
        the batch; and every touched node can absorb the SUM of its rows
        (``sums < idle + eps`` per node — which implies every sequential
        per-row ``sub_checked`` prefix AND every attach-axis re-check in
        ``allocate_volumes`` would pass too).  Returns the per-row node
        objects + per-node group arrays on success, None on any doubt —
        the caller then routes through the scalar object path, which
        reproduces the exact failure semantics (diversion order,
        raise row) bit-for-bit."""
        vb = self.volume_binder
        if vb.fail_allocate_uids or vb.fail_bind_uids or self.binder.fail_uids:
            return None
        if vb.sim is not None and any(t.volume_zone for t in tasks):
            return None
        if len(set(uids)) != len(uids):
            return None
        cluster_nodes = self.cluster.nodes
        group_of: Dict[str, int] = {}
        g_nodes: List[NodeInfo] = []
        g_of = np.empty(len(uids), np.intp)
        for k, nm in enumerate(nodes):
            g = group_of.get(nm)
            if g is None:
                node = cluster_nodes.get(nm)
                if node is None:
                    return None
                g = group_of[nm] = len(g_nodes)
                g_nodes.append(node)
            if uids[k] in g_nodes[g].tasks:
                return None
            g_of[k] = g
        sums = np.zeros((len(g_nodes), reqs.shape[1]), dtype=reqs.dtype)
        np.add.at(sums, g_of, reqs)
        idle_mat = np.stack([n.idle for n in g_nodes])
        if not bool(np.all(sums < idle_mat + res.EPSILON)):
            return None
        return g_nodes, g_of, sums

    def apply_binds_columnar(self, col):
        """:meth:`apply_binds` over a decode ``BindColumn``: no intent
        objects exist; the column's cached uid/node identity vectors
        (one batched resolve each) drive a flat commit loop, node
        accounting lands as ONE vectorized idle/used update per touched
        node, and the whole commit's row dirt reaches the arena as ONE
        batched delta-sink call.  A failure-freedom certificate
        (:meth:`_bind_batch_certificate`) gates the fast commit; any
        doubt — injected failures armed, volume-zone pins, missing
        node, duplicate uid, or a batch the touched nodes cannot
        absorb — falls back to the scalar object path wholesale, so
        gang-atomic diversion and raise semantics stay bit-identical.
        Observable equivalences the fast path relies on: resource
        quantities are integral (milli-CPU / bytes) in float64, so the
        per-node summed subtract equals the scalar row-by-row chain
        exactly; and rows are committed in the scalar path's
        job-grouped order so binder records, node.tasks insertion
        order, and delta emission all match.  Returns the uids that
        did NOT actuate."""
        if not len(col):
            return []
        uids, nodes = col.uids, col.node_names
        tasks = self._resolve_rows(col)
        reqs = np.stack([t.resreq for t in tasks])
        cert = self._bind_batch_certificate(uids, nodes, tasks, reqs)
        if cert is None:
            return self.apply_binds(
                [BindIntent(u, n) for u, n in zip(uids, nodes)]
            )
        g_nodes, g_of, sums = cert
        # scalar commit order: jobs by first appearance, rows in order
        # within each job (apply_binds' by_job dict iteration)
        by_job: Dict[str, List[int]] = {}
        for k, task in enumerate(tasks):
            by_job.setdefault(task.job_uid, []).append(k)
        order = [k for ks in by_job.values() for k in ks]
        vb = self.volume_binder
        if vb is not None:
            vb.allocated.extend((uids[k], nodes[k]) for k in order)
            vb.bound.extend(uids[k] for k in order)
        binder_binds = self.binder.binds
        new = TaskInfo.__new__
        bound = TaskStatus.BOUND
        for k in order:
            task = tasks[k]
            nm = nodes[k]
            binder_binds[task.uid] = nm
            task.status = bound
            task.node_name = nm
            # the scalar path's clone(): same shallow field sharing,
            # fresh resreq — __post_init__ re-normalization is skipped
            # because the source is already canonical, and copy.copy's
            # __reduce_ex__ round-trip is skipped because TaskInfo is a
            # plain __dict__ dataclass
            c = new(TaskInfo)
            c.__dict__.update(task.__dict__)
            c.resreq = task.resreq.copy()
            g_nodes[g_of[k]].tasks[task.uid] = c
        for g, node in enumerate(g_nodes):
            node.idle = node.idle - sums[g]
            node.used = node.used + sums[g]
        self._emit_task_rows([uids[k] for k in order], [nodes[k] for k in order])
        return []

    def _evict_batch_certificate(self, uids, tasks):
        """Prove (read-only) that committing the whole evict column can
        fail NOWHERE, so the batched commit may skip every per-row
        try/except and node-accounting chain.

        The certificate requires: no injected evictor failures armed; no
        uid repeats in the batch; every on-node row's node exists and
        holds a resident clone of the uid; no resident clone is already
        RELEASING or PIPELINED (those take different remove_task
        branches — and re-evicting a releasing task is not the fast
        path's business); and each clone's resreq equals the model
        task's (so the remove/add accounting cancels exactly).  Under
        those facts the scalar chain's net node effect is exactly
        ``releasing += Σ resreq`` per touched node — idle and used
        cancel bit-for-bit because resource quantities are integral
        float64 — so the batch may commit it as ONE vectorized update
        per node.  Returns (per-row node-or-None, touched nodes,
        per-node releasing sums) on success, None on any doubt — the
        caller then routes through the scalar path wholesale, which
        reproduces the exact failure semantics (resync diversion order,
        partial-batch actuation) bit-for-bit."""
        if self.evictor.fail_uids:
            return None
        if len(set(uids)) != len(uids):
            return None
        cluster_nodes = self.cluster.nodes
        group_of: Dict[str, int] = {}
        g_nodes: List[NodeInfo] = []
        g_rows: List[int] = []
        req_rows: List[np.ndarray] = []
        row_nodes: List[Optional[NodeInfo]] = []
        for k, task in enumerate(tasks):
            nm = task.node_name
            if not nm:
                row_nodes.append(None)
                continue
            node = cluster_nodes.get(nm)
            if node is None:
                return None
            clone = node.tasks.get(uids[k])
            if clone is None:
                return None
            if clone.status in (TaskStatus.RELEASING, TaskStatus.PIPELINED):
                return None
            if not np.array_equal(clone.resreq, task.resreq):
                return None
            g = group_of.get(nm)
            if g is None:
                g = group_of[nm] = len(g_nodes)
                g_nodes.append(node)
            row_nodes.append(node)
            g_rows.append(g)
            req_rows.append(task.resreq)
        sums = None
        if g_nodes:
            sums = np.zeros(
                (len(g_nodes), req_rows[0].shape[0]), dtype=req_rows[0].dtype
            )
            np.add.at(sums, np.asarray(g_rows, np.intp), np.stack(req_rows))
        return row_nodes, g_nodes, sums

    def apply_evicts_columnar(self, col):
        """:meth:`apply_evicts` over a decode ``EvictColumn`` — same
        model transitions and resync diversion, batched delta emission.
        A failure-freedom certificate (:meth:`_evict_batch_certificate`)
        gates a batch commit whose node accounting lands as ONE
        vectorized ``releasing`` update per touched node; any doubt
        (injected evictor failures, duplicate uids, missing node or
        resident clone, already-releasing rows) falls back to the
        scalar chain wholesale.  Returns the uids that did NOT
        actuate."""
        failed: List[str] = []
        if not len(col):
            return failed
        tasks = self._resolve_rows(col)
        emit_u: List[str] = []
        emit_n: List[str] = []
        cert = self._evict_batch_certificate(col.uids, tasks)
        if cert is None:
            for k, uid in enumerate(col.uids):
                task = tasks[k]
                try:
                    self.evictor.evict(uid)
                except BindFailure as err:
                    self._defer_resync(uid, "Evict", str(err))
                    failed.append(uid)
                    continue
                if task.node_name:
                    node = self.cluster.nodes[task.node_name]
                    node.remove_task(task)
                    task.status = TaskStatus.RELEASING
                    node.add_task(task)
                else:
                    task.status = TaskStatus.RELEASING
                emit_u.append(uid)
                emit_n.append(task.node_name)
                self.record_event("Evict", uid, "Evict")
            self._emit_task_rows(emit_u, emit_n)
            return failed
        row_nodes, g_nodes, sums = cert
        new = TaskInfo.__new__
        releasing = TaskStatus.RELEASING
        for k, uid in enumerate(col.uids):
            task = tasks[k]
            self.evictor.evict(uid)  # certified not to raise; still records
            task.status = releasing
            node = row_nodes[k]
            if node is not None:
                # the scalar chain pops the resident clone and re-adds a
                # fresh clone of the (now RELEASING) task — the uid moves
                # to the END of node.tasks; reproduce both, with the
                # bind path's cheap clone (source already canonical)
                node.tasks.pop(uid)
                c = new(TaskInfo)
                c.__dict__.update(task.__dict__)
                c.resreq = task.resreq.copy()
                node.tasks[uid] = c
            emit_u.append(uid)
            emit_n.append(task.node_name)
            self.record_event("Evict", uid, "Evict")
        for g, node in enumerate(g_nodes):
            node.releasing = node.releasing + sums[g]
        self._emit_task_rows(emit_u, emit_n)
        return failed

    # ---- failure handling (errTasks resync, cache.go:519-547) ----

    def _defer_resync(self, task_uid: str, op: str, message: str) -> None:
        self.resync_queue.append(task_uid)
        self.record_event("FailedScheduling", task_uid, op, message)

    def process_resync(self) -> int:
        """Drain the errTasks FIFO: re-read each task from the source of
        truth (here: the cluster model, the analog of re-GETting the pod,
        event_handlers.go:70-88) and repair its state.  A task whose bind
        or evict never happened stays/returns Pending-off-node; its next
        cycle retries.  Returns tasks repaired."""
        repaired = 0
        index = self._task_index()
        queue, self.resync_queue = self.resync_queue, []
        for uid in queue:
            task = index.get(uid)
            if task is None:
                continue  # deleted meanwhile; nothing to repair
            if task.status in (TaskStatus.PENDING, TaskStatus.RUNNING):
                repaired += 1  # model already consistent (op never applied)
                continue
            # op half-applied (should not happen in sim: accounting follows
            # the backend call) — restore the authoritative pending state
            old_node = task.node_name
            if task.node_name and uid in self.cluster.nodes.get(task.node_name, NodeInfo("")).tasks:
                self.cluster.nodes[task.node_name].remove_task(task)
            task.status = TaskStatus.PENDING
            task.node_name = ""
            self._emit_task(uid, old_node)
            repaired += 1
        return repaired


def generate_cluster(
    num_nodes: int,
    num_jobs: int,
    tasks_per_job: int,
    num_queues: int = 1,
    seed: int = 0,
    node_cpu_milli: float = 32000,
    node_memory: float = 128 * 1024**3,
    node_gpu_milli: float = 8000,
    gang_fraction: float = 0.5,
    gpu_fraction: float = 0.25,
    running_fraction: float = 0.0,
) -> SimCluster:
    """Synthetic cluster generator for the BASELINE configs (1k×100 …
    100k×10k).  Task shapes drawn from a small set of realistic request
    profiles; a fraction of jobs are gangs; optionally pre-populates running
    tasks to exercise fairness/preemption state."""
    rng = np.random.default_rng(seed)
    sim = SimCluster()
    for q in range(num_queues):
        sim.add_queue(f"queue-{q:03d}", weight=int(rng.integers(1, 5)))
    for n in range(num_nodes):
        sim.add_node(
            f"node-{n:05d}",
            cpu_milli=node_cpu_milli,
            memory=node_memory,
            gpu_milli=node_gpu_milli,
            max_tasks=110,
        )
    profiles = [
        (500, 1 * 1024**3, 0),
        (1000, 2 * 1024**3, 0),
        (2000, 4 * 1024**3, 0),
        (4000, 8 * 1024**3, 1000),
        (8000, 16 * 1024**3, 2000),
    ]
    node_names = list(sim.cluster.nodes)
    for ji in range(num_jobs):
        queue = f"queue-{int(rng.integers(0, num_queues)):03d}"
        gang = rng.random() < gang_fraction
        min_avail = int(tasks_per_job * 0.5) if gang else 0
        job = sim.add_job(
            f"job-{ji:05d}", queue=queue, min_available=min_avail, creation_ts=float(ji)
        )
        cpu, mem, gpu = profiles[int(rng.integers(0, len(profiles)))]
        if rng.random() > gpu_fraction:
            gpu = 0
        for _ in range(tasks_per_job):
            if running_fraction > 0 and rng.random() < running_fraction:
                node = node_names[int(rng.integers(0, len(node_names)))]
                try:
                    sim.add_task(job, cpu, mem, gpu, status=TaskStatus.RUNNING, node=node)
                    continue
                except ValueError:
                    pass  # node full; fall through to pending
            sim.add_task(job, cpu, mem, gpu)
    return sim
