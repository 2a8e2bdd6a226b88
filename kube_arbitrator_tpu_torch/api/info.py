"""Host-side in-memory cluster model: Task/Job/Node/Queue/Cluster info
(the port's copy of kube_arbitrator_tpu/api/info.py).

Semantics parity: reference ``pkg/scheduler/api/{job_info,node_info,
queue_info,cluster_info}.go``.  This is the *snapshot plane* data model: it
owns identity, labels, and exact accounting; the decision plane only ever
sees its flattened tensor form (cache/snapshot.py).

Design difference vs the reference: tasks/jobs/nodes
carry integer *ordinals* assigned at snapshot time so every cross-reference
in the tensor encoding is an int32 index, never a string key.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import resource as res
from .types import (
    TaskStatus,
    counts_as_ready,
    counts_as_valid,
    is_allocated_status,
)


# PV zone topology key (the VolumeZone predicate's label; see
# cache/sim.FakeVolumeBinder and cache/snapshot's class table).
ZONE_LABEL = "topology.kubernetes.io/zone"


@dataclasses.dataclass
class Toleration:
    """Subset of v1.Toleration the reference's taint predicate consults."""

    key: str = ""
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: str = ""  # "" matches all effects

    def tolerates(self, taint: "Taint") -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclasses.dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclasses.dataclass(frozen=True)
class MatchExpression:
    """Node-affinity requirement (v1.NodeSelectorRequirement subset used by
    PodMatchNodeSelector, predicates.go:130-141)."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: Tuple[str, ...] = ()

    def matches(self, labels: Dict[str, str]) -> bool:
        has = self.key in labels
        val = labels.get(self.key, "")
        if self.operator == "In":
            return has and val in self.values
        if self.operator == "NotIn":
            return not has or val not in self.values
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator == "Gt":
            return has and _as_int(val) is not None and any(
                _as_int(v) is not None and _as_int(val) > _as_int(v) for v in self.values
            )
        if self.operator == "Lt":
            return has and _as_int(val) is not None and any(
                _as_int(v) is not None and _as_int(val) < _as_int(v) for v in self.values
            )
        return False


def _as_int(s: str):
    try:
        return int(s)
    except ValueError:
        return None


def normalize_node_affinity(aff) -> Tuple[Tuple[MatchExpression, ...], ...]:
    """Canonical node-affinity form: a tuple of nodeSelectorTerms, ORed
    across terms with match expressions ANDed within one (the vendored
    helper the reference's PodMatchNodeSelector calls ORs across ALL
    terms — helpers.go:303-315 MatchNodeSelectorTerms).

    Accepts both shapes for compatibility: a flat sequence of
    MatchExpression (ONE term — the single-term convenience every sim
    test uses) or a sequence of expression sequences (multi-term)."""
    items = tuple(aff or ())
    if not items:
        return ()
    if isinstance(items[0], MatchExpression):
        return (items,)
    return tuple(tuple(term) for term in items)


def node_affinity_matches(aff, labels: Dict[str, str]) -> bool:
    """True when ANY nodeSelectorTerm matches in full (helpers.go:303-315:
    'nil or empty term matches no objects; the terms are ORed') — hence an
    EMPTY term (e.g. a matchFields-only term whose expressions did not
    translate) contributes no match, rather than matching everything."""
    terms = normalize_node_affinity(aff)
    if not terms:
        return True  # no affinity requirement at all
    return any(term and all(e.matches(labels) for e in term) for term in terms)


@dataclasses.dataclass(frozen=True)
class PodAffinityTerm:
    """Required pod (anti-)affinity term (the v1.PodAffinityTerm subset the
    reference's NewPodAffinityPredicate evaluates, predicates.go:186-198):
    a label selector over *pods*, scoped to namespaces, co-located (affinity)
    or excluded (anti-affinity) per topology domain of ``topology_key``."""

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[MatchExpression, ...] = ()
    topology_key: str = "kubernetes.io/hostname"
    anti: bool = False
    # Empty = the owning pod's namespace (the v1 default).
    namespaces: Tuple[str, ...] = ()

    def selector_matches(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.match_labels) and all(
            e.matches(labels) for e in self.match_expressions
        )

    def matches_pod(
        self, pod_namespace: str, pod_labels: Dict[str, str], owner_namespace: str
    ) -> bool:
        ns = self.namespaces or (owner_namespace,)
        return pod_namespace in ns and self.selector_matches(pod_labels)


@dataclasses.dataclass
class TaskInfo:
    """Reference api/job_info.go:36-89 (TaskInfo)."""

    uid: str
    job_uid: str
    name: str = ""
    namespace: str = "default"
    resreq: np.ndarray = dataclasses.field(default_factory=res.zeros)
    node_name: str = ""
    status: TaskStatus = TaskStatus.PENDING
    priority: int = 1
    # Predicate inputs (tensorized via equivalence classes in the snapshot):
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Required node affinity, CANONICAL form: a tuple of nodeSelectorTerms
    # (each a tuple of MatchExpression), ORed across terms with
    # expressions ANDed within one (helpers.go:303-315).  Constructors may
    # pass the flat single-term convenience shape; __post_init__
    # normalizes so every consumer sees terms-of-expressions.
    node_affinity: Tuple = ()
    tolerations: List[Toleration] = dataclasses.field(default_factory=list)
    host_ports: Tuple[int, ...] = ()
    # Pod labels (what other pods' affinity terms select on) and this pod's
    # own required (anti-)affinity terms.
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    affinity_terms: Tuple["PodAffinityTerm", ...] = ()
    # Zone a bound PV pins this task's volumes to ("" = unconstrained) —
    # the predicate face of the k8s volumebinder the reference wires
    # (cache.go:230-238); attach COUNTS ride resreq's 4th axis.
    volume_zone: str = ""
    # Assigned by the snapshot flattener:
    ordinal: int = -1

    def __post_init__(self) -> None:
        # canonicalize at the boundary so every consumer iterates terms
        # (a consumer iterating a flat shape would silently treat terms
        # as expressions)
        self.node_affinity = normalize_node_affinity(self.node_affinity)

    @property
    def best_effort(self) -> bool:
        return res.is_empty(self.resreq)

    def clone(self) -> "TaskInfo":
        return dataclasses.replace(self, resreq=self.resreq.copy())


@dataclasses.dataclass(frozen=True)
class PDBInfo:
    """PodDisruptionBudget subset the reference consumes: when a job has no
    PodGroup, a PDB owned by the same controller supplies its gang size
    (``api/job_info.go:188-205`` SetPDB/UnsetPDB; the PDB informer feeds it
    at ``cache/event_handlers.go:458-492``)."""

    name: str
    namespace: str = "default"
    min_available: int = 0


@dataclasses.dataclass
class JobInfo:
    """Reference api/job_info.go:117-358 (JobInfo). Gang unit == PodGroup."""

    uid: str
    name: str = ""
    namespace: str = "default"
    queue_uid: str = "default"
    priority: int = 0
    min_available: int = 0
    creation_ts: float = 0.0
    tasks: Dict[str, TaskInfo] = dataclasses.field(default_factory=dict)
    ordinal: int = -1
    pdb: Optional[PDBInfo] = None

    def set_pdb(self, pdb: PDBInfo, default_queue: str = "") -> None:
        """SetPDB (job_info.go:188-199): the PDB names the job and its
        MinAvailable; queue = default queue if set, else the namespace."""
        self.name = pdb.name
        self.namespace = pdb.namespace
        self.min_available = pdb.min_available
        self.queue_uid = default_queue or pdb.namespace
        self.pdb = pdb

    def unset_pdb(self) -> None:
        """UnsetPDB (job_info.go:202-205)."""
        self.pdb = None
        self.min_available = 0

    def add_task(self, t: TaskInfo) -> None:
        self.tasks[t.uid] = t

    def tasks_with_status(self, *statuses: TaskStatus) -> List[TaskInfo]:
        want = set(statuses)
        return [t for t in self.tasks.values() if t.status in want]

    @property
    def allocated(self) -> np.ndarray:
        return res.sum_resources(
            t.resreq for t in self.tasks.values() if is_allocated_status(t.status)
        )

    @property
    def total_request(self) -> np.ndarray:
        return res.sum_resources(t.resreq for t in self.tasks.values())

    def ready_task_num(self) -> int:
        """gang.go:44-70: allocated-status + Succeeded + Pipelined."""
        return sum(1 for t in self.tasks.values() if counts_as_ready(t.status))

    def valid_task_num(self) -> int:
        return sum(1 for t in self.tasks.values() if counts_as_valid(t.status))

    def is_ready(self) -> bool:
        return self.ready_task_num() >= self.min_available

    def is_valid(self) -> bool:
        """gang JobValidFn (gang.go:81-102)."""
        return self.valid_task_num() >= self.min_available

    def pending_tasks(self) -> List[TaskInfo]:
        return self.tasks_with_status(TaskStatus.PENDING)


@dataclasses.dataclass
class NodeInfo:
    """Reference api/node_info.go:26-157 with exact Idle/Used/Releasing
    accounting."""

    name: str
    allocatable: np.ndarray = dataclasses.field(default_factory=res.zeros)
    capability: np.ndarray = dataclasses.field(default_factory=res.zeros)
    max_tasks: int = 110
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    taints: List[Taint] = dataclasses.field(default_factory=list)
    unschedulable: bool = False
    ordinal: int = -1

    idle: np.ndarray = dataclasses.field(default_factory=res.zeros)
    used: np.ndarray = dataclasses.field(default_factory=res.zeros)
    releasing: np.ndarray = dataclasses.field(default_factory=res.zeros)
    tasks: Dict[str, TaskInfo] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if res.is_empty(self.idle) and not res.is_empty(self.allocatable):
            self.idle = self.allocatable.copy()
        if res.is_empty(self.capability) and not res.is_empty(self.allocatable):
            self.capability = self.allocatable.copy()

    def add_task(self, task: TaskInfo) -> None:
        """node_info.go:101-127: status-aware accounting."""
        if task.uid in self.tasks:
            raise ValueError(f"task {task.uid} already on node {self.name}")
        t = task.clone()
        if t.status == TaskStatus.RELEASING:
            self.releasing = self.releasing + t.resreq
            self.idle = res.sub_checked(self.idle, t.resreq)
        elif t.status == TaskStatus.PIPELINED:
            self.releasing = res.sub_checked(self.releasing, t.resreq)
        else:
            self.idle = res.sub_checked(self.idle, t.resreq)
        self.used = self.used + t.resreq
        self.tasks[t.uid] = t

    def remove_task(self, task: TaskInfo) -> None:
        """node_info.go:130-157 (inverse accounting)."""
        t = self.tasks.pop(task.uid, None)
        if t is None:
            raise ValueError(f"task {task.uid} not on node {self.name}")
        if t.status == TaskStatus.RELEASING:
            self.releasing = res.sub_checked(self.releasing, t.resreq)
            self.idle = self.idle + t.resreq
        elif t.status == TaskStatus.PIPELINED:
            self.releasing = self.releasing + t.resreq
        else:
            self.idle = self.idle + t.resreq
        self.used = res.sub_checked(self.used, t.resreq)

    def update_task(self, task: TaskInfo) -> None:
        self.remove_task(task)
        self.add_task(task)


@dataclasses.dataclass
class QueueInfo:
    """Reference api/queue_info.go:25-54 + Queue CRD (weight)."""

    uid: str
    name: str = ""
    weight: int = 1
    ordinal: int = -1

    def __post_init__(self) -> None:
        if not self.name:
            self.name = self.uid


@dataclasses.dataclass
class ClusterInfo:
    """Reference api/cluster_info.go:21-29: one cycle's snapshot input."""

    jobs: Dict[str, JobInfo] = dataclasses.field(default_factory=dict)
    nodes: Dict[str, NodeInfo] = dataclasses.field(default_factory=dict)
    queues: Dict[str, QueueInfo] = dataclasses.field(default_factory=dict)
    # Running tasks owned by other schedulers; their usage is subtracted from
    # the proportion plugin's total (proportion.go:61-63).
    others: List[TaskInfo] = dataclasses.field(default_factory=list)

    def task_by_uid(self, uid: str) -> Optional[TaskInfo]:
        for job in self.jobs.values():
            if uid in job.tasks:
                return job.tasks[uid]
        return None
