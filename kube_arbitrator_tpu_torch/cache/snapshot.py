"""The pack: one cycle's dense state, and the host builder that flattens
a cluster into it.

:func:`build_snapshot` (the port of kube_arbitrator_tpu/cache/snapshot.py:
369-917) flattens a :class:`~..api.info.ClusterInfo` into a
:class:`HostPack` of numpy arrays with the reference's field names,
dtypes and padded shapes, plus the :class:`SnapshotIndex` that maps
ordinals back to objects.  The host pack stays numpy; only the decider
moves it to a device (:func:`from_numpy`).

:class:`SnapshotTensors` is the device form: a copy of the fields of the
reference's ``SnapshotTensors`` that the ported actions read (the
reference's :145-274), in the same dtypes (i32 / f32 / bool): the task,
group, node, job and queue tables, the pod-(anti-)affinity tables
(topology domains, pod label classes, term ordinals with their static
per-domain counts; :func:`trivial_pod_affinity` is the no-terms
encoding), and the reclaim canon pack (``rv_*``, built by
:func:`build_reclaim_pack`).

Device resource units are ``[milli-cpu, MiB, milli-gpu, attach x100]``,
in which the reference's epsilon slack is uniformly ``10.0``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..api import resource as res
from ..api.info import (
    ZONE_LABEL, ClusterInfo, JobInfo, NodeInfo, QueueInfo, TaskInfo, node_affinity_matches,
    normalize_node_affinity,
)
from ..api.types import TaskStatus
from ..device import DeviceLike, resolve_device

DEVICE_SCALE = np.array(
    [1.0, 1.0 / (1024.0 * 1024.0), 1.0, 100.0], dtype=np.float64
)
DEVICE_DTYPE = np.float32
DEVICE_EPSILON = 10.0
MAX_PORT_WORDS = 2  # 31 usable bits per int32 word -> 62 host ports/snapshot


_BUCKET_MEMO: dict = {}
_STICKY_BUCKETS = True


def set_sticky_buckets(enabled: bool) -> None:
    """Enable or disable the sticky-shape memo of :func:`_bucket`, and
    clear it (the reference's :71-84)."""
    global _STICKY_BUCKETS
    _STICKY_BUCKETS = enabled
    _BUCKET_MEMO.clear()


def _bucket(n: int, multiple: int, minimum: int, key: str = "") -> int:
    """Round ``n`` up to a padded axis length: multiples of
    max(``multiple``, ~n/16), at least ``minimum`` (the reference's
    :86-115).  With a ``key`` and the sticky memo on, the axis keeps its
    previous length while ``n`` still fits in it with at most ~25%
    padding, so an arena's delta epochs keep their shapes while counts
    drift.  Decisions do not depend on padding."""
    n = max(n, 1)
    gran = max(multiple, 1 << max(0, n.bit_length() - 5))
    b = ((n + gran - 1) // gran) * gran
    b = max(b, minimum)
    if key and _STICKY_BUCKETS:
        prev = _BUCKET_MEMO.get(key)
        if prev is not None and n <= prev and prev * 4 <= b * 5:
            return prev
        _BUCKET_MEMO[key] = b
    return b


def to_device_units(vec_bytes: np.ndarray) -> np.ndarray:
    """Host-unit resource vector -> device units.  The multiply runs in
    float64 (byte counts need it); the cast to float32 happens here."""
    return (vec_bytes * DEVICE_SCALE).astype(DEVICE_DTYPE)


# field -> (numpy dtype, ndim); the pack's dtype contract
SCHEMA: Dict[str, tuple] = {
    "task_resreq": (np.float32, 2),
    "task_job": (np.int32, 1),
    "task_status": (np.int32, 1),
    "task_priority": (np.int32, 1),
    "task_uid_rank": (np.int32, 1),
    "task_klass": (np.int32, 1),
    "task_node": (np.int32, 1),
    "task_ports": (np.int32, 2),
    "task_valid": (np.bool_, 1),
    "task_best_effort": (np.bool_, 1),
    "task_group": (np.int32, 1),
    "task_group_rank": (np.int32, 1),
    "group_job": (np.int32, 1),
    "group_resreq": (np.float32, 2),
    "group_klass": (np.int32, 1),
    "group_ports": (np.int32, 2),
    "group_size": (np.int32, 1),
    "group_priority": (np.int32, 1),
    "group_uid_rank": (np.int32, 1),
    "group_best_effort": (np.bool_, 1),
    "group_valid": (np.bool_, 1),
    "node_idle": (np.float32, 2),
    "node_releasing": (np.float32, 2),
    "node_alloc": (np.float32, 2),
    "node_max_tasks": (np.int32, 1),
    "node_num_tasks": (np.int32, 1),
    "node_klass": (np.int32, 1),
    "node_ports": (np.int32, 2),
    "node_unsched": (np.bool_, 1),
    "node_valid": (np.bool_, 1),
    "job_queue": (np.int32, 1),
    "job_min_available": (np.int32, 1),
    "job_priority": (np.int32, 1),
    "job_creation_rank": (np.int32, 1),
    "job_valid": (np.bool_, 1),
    "queue_weight": (np.float32, 1),
    "queue_uid_rank": (np.int32, 1),
    "queue_valid": (np.bool_, 1),
    "class_fit": (np.bool_, 2),
    "task_pa_class": (np.int32, 1),
    "group_pa_class": (np.int32, 1),
    "group_aff_terms": (np.int32, 2),
    "group_anti_terms": (np.int32, 2),
    "node_dom": (np.int32, 2),
    "aff_key": (np.int32, 1),
    "anti_key": (np.int32, 1),
    "aff_static": (np.int32, 2),
    "anti_static": (np.int32, 2),
    "aff_static_total": (np.int32, 1),
    "aff_match": (np.bool_, 2),
    "anti_match": (np.bool_, 2),
    "symm_ok": (np.bool_, 2),
    "others_used": (np.float32, 1),
    "rv_idx": (np.int32, 1),
    "rv_valid": (np.bool_, 1),
    "rv_nj_start": (np.bool_, 1),
    "rv_nq_start": (np.bool_, 1),
    "rv_block_start": (np.int32, 1),
}

# Reference pack fields the port does not read: the traced real-queue
# count (the port's round loops read the active-queue count instead).
IGNORED_FIELDS = frozenset({"n_valid_queues"})

# the host pack's dtype contract: every device field and the real-queue
# count, in the reference's field order (its analysis/contracts.py
# SNAPSHOT_SCHEMA)
HOST_SCHEMA: Dict[str, tuple] = {}
for _name, _spec in SCHEMA.items():
    HOST_SCHEMA[_name] = _spec
    if _name == "others_used":
        HOST_SCHEMA["n_valid_queues"] = (np.int32, 0)


# One cycle's dense state on the host: numpy arrays named and typed as
# HOST_SCHEMA says, and the static ``rv_window``.
HostPack = dataclasses.make_dataclass(
    "HostPack",
    [(name, np.ndarray) for name in HOST_SCHEMA]
    + [("rv_window", int, dataclasses.field(default=0))],
    frozen=True,
)


def assert_pack_dtypes(pack) -> None:
    """Raise TypeError when a field of ``pack`` is not of the dtype and
    rank :data:`HOST_SCHEMA` declares (the reference's
    ``_assert_pack_dtypes``, :124)."""
    for name, (dtype, ndim) in HOST_SCHEMA.items():
        a = np.asarray(getattr(pack, name))
        if a.dtype != np.dtype(dtype) or a.ndim != ndim:
            raise TypeError(
                f"snapshot pack dtype contract violation: {name} built as "
                f"{a.dtype}[{a.ndim}d], contract says {np.dtype(dtype)}[{ndim}d]"
            )


@dataclasses.dataclass(frozen=True)
class SnapshotTensors:
    """One cycle's dense state; every field a tensor on one device."""

    task_resreq: torch.Tensor      # f32[T, R]
    task_job: torch.Tensor         # i32[T]
    task_status: torch.Tensor      # i32[T] TaskStatus
    task_priority: torch.Tensor    # i32[T]
    task_uid_rank: torch.Tensor    # i32[T]
    task_klass: torch.Tensor       # i32[T]
    task_node: torch.Tensor        # i32[T] node ordinal, -1 if none
    task_ports: torch.Tensor       # i32[T, W]
    task_valid: torch.Tensor       # bool[T]
    task_best_effort: torch.Tensor  # bool[T]
    task_group: torch.Tensor       # i32[T] group ordinal (-1 none)
    task_group_rank: torch.Tensor  # i32[T] rank within group (by uid)
    group_job: torch.Tensor        # i32[G]
    group_resreq: torch.Tensor     # f32[G, R]
    group_klass: torch.Tensor      # i32[G]
    group_ports: torch.Tensor      # i32[G, W]
    group_size: torch.Tensor       # i32[G] pending tasks in group
    group_priority: torch.Tensor   # i32[G]
    group_uid_rank: torch.Tensor   # i32[G]
    group_best_effort: torch.Tensor  # bool[G]
    group_valid: torch.Tensor      # bool[G]
    node_idle: torch.Tensor        # f32[N, R]
    node_releasing: torch.Tensor   # f32[N, R]
    node_alloc: torch.Tensor       # f32[N, R]
    node_max_tasks: torch.Tensor   # i32[N]
    node_num_tasks: torch.Tensor   # i32[N]
    node_klass: torch.Tensor       # i32[N]
    node_ports: torch.Tensor       # i32[N, W]
    node_unsched: torch.Tensor     # bool[N]
    node_valid: torch.Tensor       # bool[N]
    job_queue: torch.Tensor        # i32[J]
    job_min_available: torch.Tensor  # i32[J]
    job_priority: torch.Tensor     # i32[J]
    job_creation_rank: torch.Tensor  # i32[J]
    job_valid: torch.Tensor        # bool[J]
    queue_weight: torch.Tensor     # f32[Q]
    queue_uid_rank: torch.Tensor   # i32[Q]
    queue_valid: torch.Tensor      # bool[Q]
    class_fit: torch.Tensor        # bool[CT, CN]
    # pod (anti-)affinity: each (topology key, node label value) is one
    # GLOBAL domain ordinal (distinct across keys); pod label classes CP
    # are the distinct (namespace, labels) of pending tasks; each distinct
    # term is an ordinal on the TF (affinity) or TA (anti) axis with the
    # per-domain counts of matching existing pods.  Zero-sized term axes
    # when no task carries terms.
    task_pa_class: torch.Tensor    # i32[T] pod label class (pending tasks)
    group_pa_class: torch.Tensor   # i32[G]
    group_aff_terms: torch.Tensor  # i32[G, MA] term ordinals, -1 padding
    group_anti_terms: torch.Tensor  # i32[G, MB]
    node_dom: torch.Tensor         # i32[K, N] domain per topology key, -1 none
    aff_key: torch.Tensor          # i32[TF] topology-key row per term
    anti_key: torch.Tensor         # i32[TA]
    aff_static: torch.Tensor       # i32[TF, D] existing matching pods per domain
    anti_static: torch.Tensor      # i32[TA, D]
    aff_static_total: torch.Tensor  # i32[TF] cluster-wide existing matches
    aff_match: torch.Tensor        # bool[TF, CP] class cp matches the selector
    anti_match: torch.Tensor       # bool[TA, CP]
    symm_ok: torch.Tensor          # bool[CS, N] existing anti terms vs class (CS 0: none)
    others_used: torch.Tensor      # f32[R]
    # reclaim canon pack: RUNNING tasks sorted by (node, queue, job,
    # priority, uid), so node blocks and (node, job) / (node, queue)
    # segments are contiguous; empty when the pack has none
    rv_idx: torch.Tensor           # i32[Vp] task index
    rv_valid: torch.Tensor         # bool[Vp]
    rv_nj_start: torch.Tensor      # bool[Vp] (node, job) segment start
    rv_nq_start: torch.Tensor      # bool[Vp] (node, queue) segment start
    rv_block_start: torch.Tensor   # i32[N+1] canon position of node blocks
    rv_window: int = 0             # max node-block length (bucketed)

    @property
    def device(self) -> torch.device:
        return self.task_resreq.device

    @property
    def num_tasks(self) -> int:
        return self.task_resreq.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_idle.shape[0]

    @property
    def num_groups(self) -> int:
        return self.group_job.shape[0]

    @property
    def num_jobs(self) -> int:
        return self.job_queue.shape[0]

    @property
    def num_queues(self) -> int:
        return self.queue_weight.shape[0]

    @property
    def num_domains(self) -> int:
        """D, the length of the domain axis of the static counts."""
        if self.aff_static.shape[0]:
            return self.aff_static.shape[1]
        return self.anti_static.shape[1]


def pa_enabled(st: SnapshotTensors) -> bool:
    """Does this pack carry pod-affinity terms (ops/podaffinity.py:64-70
    in the reference)?"""
    return (
        st.group_aff_terms.shape[1] > 0
        or st.group_anti_terms.shape[1] > 0
        or st.symm_ok.shape[0] > 0
    )


def from_numpy(
    arrays: Mapping[str, Any], device: DeviceLike = None
) -> SnapshotTensors:
    """The reference pack's fields (a mapping of numpy arrays, e.g.
    ``dataclasses.asdict`` of its SnapshotTensors) -> a port pack on
    ``device``.  Dtypes and ranks are checked against :data:`SCHEMA`;
    ``rv_window`` is a plain int."""
    dev = resolve_device(device)
    unknown = sorted(
        k for k in arrays
        if k not in SCHEMA and k not in IGNORED_FIELDS and k != "rv_window"
    )
    if unknown:
        raise ValueError(f"unknown pack fields: {unknown}")
    out = {}
    for name, (dtype, ndim) in SCHEMA.items():
        if name not in arrays:
            raise ValueError(f"pack field {name} is missing")
        a = np.asarray(arrays[name])
        if a.dtype != np.dtype(dtype) or a.ndim != ndim:
            raise TypeError(
                f"pack field {name}: got {a.dtype}[{a.ndim}d], "
                f"want {np.dtype(dtype)}[{ndim}d]"
            )
        out[name] = torch.from_numpy(np.array(a)).to(dev)  # a copy the port owns
    return SnapshotTensors(**out, rv_window=int(arrays.get("rv_window", 0)))


def trivial_pod_affinity(T: int, N: int, G: int) -> Dict[str, np.ndarray]:
    """The no-terms encoding (a copy of the reference's cache/snapshot.py:
    480-500, with the group columns): zero-sized term axes and a single
    pod label class."""
    return dict(
        task_pa_class=np.zeros(T, dtype=np.int32),
        group_pa_class=np.zeros(G, dtype=np.int32),
        group_aff_terms=np.full((G, 0), -1, dtype=np.int32),
        group_anti_terms=np.full((G, 0), -1, dtype=np.int32),
        node_dom=np.zeros((0, N), dtype=np.int32),
        aff_key=np.zeros(0, dtype=np.int32),
        anti_key=np.zeros(0, dtype=np.int32),
        aff_static=np.zeros((0, 1), dtype=np.int32),
        anti_static=np.zeros((0, 1), dtype=np.int32),
        aff_static_total=np.zeros(0, dtype=np.int32),
        aff_match=np.zeros((0, 1), dtype=bool),
        anti_match=np.zeros((0, 1), dtype=bool),
        symm_ok=np.zeros((0, N), dtype=bool),
    )


def build_reclaim_pack(
    task_status: np.ndarray,
    task_node: np.ndarray,
    task_valid: np.ndarray,
    task_job: np.ndarray,
    task_priority: np.ndarray,
    task_uid_rank: np.ndarray,
    job_queue: np.ndarray,
    num_nodes: int,
    sticky: bool = False,
) -> Dict[str, Any]:
    """Host-side canon ordering of reclaim victim candidates (a copy of
    the reference's cache/snapshot.py:277-365).

    Candidates are the RUNNING tasks on a node, sorted by (node, queue,
    job, priority, uid) so that node blocks, (node, queue) segments and
    (node, job) segments are contiguous.  ``rv_window`` (the longest node
    block, bucketed) bounds the per-claim eviction window; the arrays
    carry at least that much padding past the last block, so a window
    never runs off the end.  ``sticky`` keys the two buckets into the
    sticky memo, as the reference always does; the synthetic generator
    leaves it off (decisions do not depend on padding)."""
    from ..api.types import TaskStatus

    running = (
        (np.asarray(task_status) == int(TaskStatus.RUNNING))
        & np.asarray(task_valid)
        & (np.asarray(task_node) >= 0)
    )
    idx = np.nonzero(running)[0].astype(np.int32)
    tj = np.asarray(task_job)[idx]
    tq = np.asarray(job_queue)[tj]
    order = np.lexsort((
        np.asarray(task_uid_rank)[idx],
        np.asarray(task_priority)[idx],
        tj,
        tq,
        np.asarray(task_node)[idx],
    ))
    idx = idx[order]
    V = len(idx)
    counts0 = np.bincount(np.asarray(task_node)[idx], minlength=num_nodes)[:num_nodes]
    window = int(counts0.max()) if V else 0
    window = _bucket(window, 32, 32, key="rv_window" if sticky else "")
    Vp = _bucket(V + window, 1024, 1024, key="rv_vp" if sticky else "")
    rv_idx = np.zeros(Vp, np.int32)
    rv_idx[:V] = idx
    rv_valid = np.zeros(Vp, bool)
    rv_valid[:V] = True

    node_s = np.full(Vp, num_nodes, np.int32)
    node_s[:V] = np.asarray(task_node)[idx]
    job_s = np.full(Vp, -1, np.int32)
    job_s[:V] = np.asarray(task_job)[idx]
    queue_s = np.full(Vp, -1, np.int32)
    queue_s[:V] = np.asarray(job_queue)[job_s[:V]]

    def seg_start(*keys):
        s = np.zeros(Vp, bool)
        s[0] = True
        for k in keys:
            s[1:] |= k[1:] != k[:-1]
        return s

    rv_block_start = np.zeros(num_nodes + 1, np.int32)
    rv_block_start[1:] = np.cumsum(counts0).astype(np.int32)
    return dict(
        rv_idx=rv_idx,
        rv_valid=rv_valid,
        rv_nj_start=seg_start(node_s, job_s),
        rv_nq_start=seg_start(node_s, queue_s),
        rv_block_start=rv_block_start,
        rv_window=window,
    )


@dataclasses.dataclass
class Snapshot:
    """A pack and its ordinal -> identity lookup: a :class:`HostPack` and
    a :class:`SnapshotIndex` from :func:`build_snapshot` or the arena, or
    a device :class:`SnapshotTensors` and a ``cache/synth.SynthIndex``
    from the synthetic generator."""

    tensors: Any
    index: Any


@dataclasses.dataclass
class SnapshotIndex:
    """Host-side decode tables: ordinal -> object, for actuation."""

    tasks: List[TaskInfo]
    nodes: List[NodeInfo]
    jobs: List[JobInfo]
    queues: List[QueueInfo]
    port_universe: List[int]


def _constraint_signature(t: TaskInfo) -> Tuple:
    return (
        tuple(sorted(t.node_selector.items())),
        # OR-of-terms structure: per-term sorted expression tuples, terms
        # sorted — two pods share a class iff their term SETS agree
        tuple(sorted(
            tuple(sorted((e.key, e.operator, e.values) for e in term))
            for term in normalize_node_affinity(t.node_affinity)
        )),
        tuple(sorted((tl.key, tl.operator, tl.value, tl.effect) for tl in t.tolerations)),
        t.volume_zone,
    )


def _property_signature(n: NodeInfo) -> Tuple:
    return (
        tuple(sorted(n.labels.items())),
        tuple(sorted((tn.key, tn.value, tn.effect) for tn in n.taints)),
    )


def _selector_matches(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    """PodMatchNodeSelector exact-label part: every selector k=v present in
    labels (predicates.go:130-141)."""
    return all(labels.get(k) == v for k, v in selector.items())


def _node_affinity_matches(task: TaskInfo, labels: Dict[str, str]) -> bool:
    """Required node affinity (the requiredDuringScheduling half of
    PodMatchNodeSelector): expressions AND within a term, terms ORed
    (helpers.go:303-315 MatchNodeSelectorTerms)."""
    return node_affinity_matches(task.node_affinity, labels)


def _volume_zone_matches(task: TaskInfo, node: NodeInfo) -> bool:
    """PV zone pinning as a predicate class: a task whose bound volumes
    live in a zone only fits nodes of that zone (the VolumeZone predicate
    the k8s volumebinder enforces; reference wires it at cache.go:230-238
    and checks at session.go:243-259 AllocateVolumes)."""
    if not task.volume_zone:
        return True
    return node.labels.get(ZONE_LABEL, "") == task.volume_zone


def _tolerates_all(task: TaskInfo, node: NodeInfo) -> bool:
    """PodToleratesNodeTaints: every NoSchedule/NoExecute taint must be
    tolerated (predicates.go:172-183)."""
    for taint in node.taints:
        if taint.effect == "PreferNoSchedule":
            continue
        if not any(tol.tolerates(taint) for tol in task.tolerations):
            return False
    return True


def _ports_mask(ports, universe_pos: Dict[int, int]) -> np.ndarray:
    mask = np.zeros(MAX_PORT_WORDS, dtype=np.int32)
    for p in ports:
        pos = universe_pos[p]
        mask[pos // 31] |= np.int32(1 << (pos % 31))
    return mask


def group_signature(
    t: TaskInfo,
    job_ordinal: int,
    klass: int,
    pa_class: int = 0,
    aff_ids=(),
    anti_ids=(),
) -> Tuple:
    """The interchangeability key of the allocate unit: tasks of one job
    sharing this key are placed by *count* (see the task-group section of
    :class:`SnapshotTensors`).  ONE definition, shared by
    :func:`build_snapshot` and the incremental arena (cache/arena.py), so
    the full-rebuild and delta paths can never disagree on what makes two
    tasks interchangeable — a drift here would break the arena's
    byte-identity contract, not just performance."""
    return (
        int(job_ordinal),
        tuple(np.round(t.resreq, 6)),
        int(klass),
        t.host_ports,
        t.priority,
        t.best_effort,
        int(pa_class),
        tuple(sorted(set(aff_ids))),
        tuple(sorted(set(anti_ids))),
    )


def _build_pod_affinity(
    tasks: List[TaskInfo],
    nodes: List[NodeInfo],
    T: int,
    N: int,
) -> Dict[str, np.ndarray]:
    """Host-side pod-(anti-)affinity encoding; see SnapshotTensors docs."""
    if not any(t.affinity_terms for t in tasks):
        # the no-terms encoding without the group columns (build_snapshot
        # fills those per group)
        pa = trivial_pod_affinity(T, N, 0)
        for name in ("group_pa_class", "group_aff_terms", "group_anti_terms"):
            del pa[name]
        return dict(pa, task_aff={}, task_anti={})
    pending = [t for t in tasks if t.status == TaskStatus.PENDING]

    # pod label classes over pending tasks (namespace + labels is all a
    # selector can observe)
    cls_of: Dict[Tuple, int] = {}
    cls_rep: List[TaskInfo] = []
    task_pa_class = np.zeros(T, dtype=np.int32)
    for t in pending:
        sig = (t.namespace, tuple(sorted(t.labels.items())))
        c = cls_of.setdefault(sig, len(cls_of))
        if c == len(cls_rep):
            cls_rep.append(t)
        task_pa_class[t.ordinal] = c
    CP = max(1, len(cls_of))

    # term universes (pending tasks' terms, namespaces resolved)
    def term_sig(t: TaskInfo, term) -> Tuple:
        ns = term.namespaces or (t.namespace,)
        return (
            term.match_labels,
            term.match_expressions,
            term.topology_key,
            tuple(sorted(ns)),
        )

    aff_sigs: Dict[Tuple, int] = {}
    anti_sigs: Dict[Tuple, int] = {}
    aff_terms: List = []   # resolved representative terms
    anti_terms: List = []
    task_aff: Dict[int, List[int]] = {}
    task_anti: Dict[int, List[int]] = {}
    for t in pending:
        for term in t.affinity_terms:
            sig = term_sig(t, term)
            table, reps, per = (
                (anti_sigs, anti_terms, task_anti)
                if term.anti
                else (aff_sigs, aff_terms, task_aff)
            )
            tid = table.setdefault(sig, len(table))
            if tid == len(reps):
                reps.append((term, term.namespaces or (t.namespace,)))
            per.setdefault(t.ordinal, []).append(tid)
    TF, TA = len(aff_terms), len(anti_terms)

    # topology keys + global domains (only keys used by pending terms)
    keys: Dict[str, int] = {}
    for term, _ns in aff_terms + anti_terms:
        keys.setdefault(term.topology_key, len(keys))
    K = len(keys)
    dom_of: Dict[Tuple[str, str], int] = {}
    node_dom = np.full((K, N), -1, dtype=np.int32)
    for n in nodes:
        for key, ki in keys.items():
            v = n.labels.get(key)
            if v is None:
                continue
            node_dom[ki, n.ordinal] = dom_of.setdefault((key, v), len(dom_of))
    D = max(1, len(dom_of))

    # existing pods = everything currently holding a node (any status)
    existing = [
        (nn, tt) for nn in nodes for tt in nn.tasks.values()
    ]

    aff_key = np.zeros(TF, dtype=np.int32)
    anti_key = np.zeros(TA, dtype=np.int32)
    aff_static = np.zeros((TF, D), dtype=np.int32)
    anti_static = np.zeros((TA, D), dtype=np.int32)
    aff_static_total = np.zeros(TF, dtype=np.int32)
    aff_match = np.zeros((TF, CP), dtype=bool)
    anti_match = np.zeros((TA, CP), dtype=bool)
    for reps, key_arr, static, match, total in (
        (aff_terms, aff_key, aff_static, aff_match, aff_static_total),
        (anti_terms, anti_key, anti_static, anti_match, None),
    ):
        for tid, (term, ns) in enumerate(reps):
            key_arr[tid] = keys[term.topology_key]
            for c, rep in enumerate(cls_rep):
                match[tid, c] = rep.namespace in ns and term.selector_matches(rep.labels)
            for nn, tt in existing:
                if tt.namespace in ns and term.selector_matches(tt.labels):
                    if total is not None:
                        total[tid] += 1
                    v = nn.labels.get(term.topology_key)
                    if v is not None:
                        static[tid, dom_of[(term.topology_key, v)]] += 1

    # static symmetry: existing pods' anti terms must not match an incoming
    # class in the same domain (satisfiesExistingPodsAntiAffinity)
    symm_ok = np.ones((CP, N), dtype=bool)
    any_symm = False
    for nn, tt in existing:
        for term in tt.affinity_terms:
            if not term.anti:
                continue
            v = nn.labels.get(term.topology_key)
            if v is None:
                continue
            same_dom = np.array(
                [m.labels.get(term.topology_key) == v for m in nodes], dtype=bool
            )
            blocked_nodes = np.zeros(N, dtype=bool)
            blocked_nodes[: len(nodes)] = same_dom
            for c, rep in enumerate(cls_rep):
                if term.matches_pod(rep.namespace, rep.labels, tt.namespace):
                    symm_ok[c] &= ~blocked_nodes
                    any_symm = True
    if not any_symm:
        symm_ok = np.ones((0, N), dtype=bool)

    return dict(
        task_pa_class=task_pa_class,
        task_aff=task_aff,
        task_anti=task_anti,
        node_dom=node_dom,
        aff_key=aff_key,
        anti_key=anti_key,
        aff_static=aff_static,
        anti_static=anti_static,
        aff_static_total=aff_static_total,
        aff_match=aff_match,
        anti_match=anti_match,
        symm_ok=symm_ok,
    )


def build_snapshot(cluster: ClusterInfo) -> Snapshot:
    """Flatten ClusterInfo into a :class:`HostPack` + decode index, equal
    to the reference's ``build_snapshot`` in every field, dtype and
    shape (given the same sticky-bucket memo state)."""
    queues = sorted(cluster.queues.values(), key=lambda q: q.uid)
    jobs = sorted(cluster.jobs.values(), key=lambda j: j.uid)
    nodes = sorted(cluster.nodes.values(), key=lambda n: n.name)
    tasks: List[TaskInfo] = []
    for j in jobs:
        tasks.extend(sorted(j.tasks.values(), key=lambda t: t.uid))

    for i, q in enumerate(queues):
        q.ordinal = i
    for i, j in enumerate(jobs):
        j.ordinal = i
    for i, n in enumerate(nodes):
        n.ordinal = i
    for i, t in enumerate(tasks):
        t.ordinal = i

    queue_ord = {q.uid: q.ordinal for q in queues}
    node_ord = {n.name: n.ordinal for n in nodes}

    T = _bucket(len(tasks), 8, 8, key="tasks")
    N = _bucket(len(nodes), 128, 128, key="nodes")
    J = _bucket(len(jobs), 32, 32, key="jobs")
    Q = _bucket(len(queues), 8, 8, key="queues")
    R = res.NUM_RESOURCES
    W = MAX_PORT_WORDS

    # --- predicate equivalence classes ---
    task_sigs: Dict[Tuple, int] = {}
    task_klass = np.zeros(T, dtype=np.int32)
    t_rep: Dict[int, TaskInfo] = {}
    for t in tasks:
        sig = _constraint_signature(t)
        c = task_sigs.setdefault(sig, len(task_sigs))
        t_rep.setdefault(c, t)
        task_klass[t.ordinal] = c
    node_sigs: Dict[Tuple, int] = {}
    node_klass = np.zeros(N, dtype=np.int32)
    n_rep: Dict[int, NodeInfo] = {}
    for n in nodes:
        sig = _property_signature(n)
        c = node_sigs.setdefault(sig, len(node_sigs))
        n_rep.setdefault(c, n)
        node_klass[n.ordinal] = c

    CT, CN = max(1, len(task_sigs)), max(1, len(node_sigs))
    # one representative per class is enough — that is the whole point
    class_fit = np.ones((CT, CN), dtype=bool)
    for ct, trep in t_rep.items():
        for cn, nrep in n_rep.items():
            class_fit[ct, cn] = (
                _selector_matches(trep.node_selector, nrep.labels)
                and _node_affinity_matches(trep, nrep.labels)
                and _tolerates_all(trep, nrep)
                and _volume_zone_matches(trep, nrep)
            )

    # --- pod (anti-)affinity encoding ---
    pa = _build_pod_affinity(tasks, nodes, T, N)
    task_pa_class = pa["task_pa_class"]
    task_aff_ids: Dict[int, List[int]] = pa["task_aff"]
    task_anti_ids: Dict[int, List[int]] = pa["task_anti"]

    # --- host-port universe ---
    universe: List[int] = sorted(
        {p for t in tasks for p in t.host_ports}
        | {p for n in nodes for tt in n.tasks.values() for p in tt.host_ports}
    )
    if len(universe) > MAX_PORT_WORDS * 31:
        raise ValueError(
            f"snapshot uses {len(universe)} distinct host ports; max {MAX_PORT_WORDS * 31}"
        )
    upos = {p: i for i, p in enumerate(universe)}

    # --- task tensors ---
    task_resreq = np.zeros((T, R), dtype=np.float32)
    task_job = np.zeros(T, dtype=np.int32)
    task_status = np.full(T, int(TaskStatus.UNKNOWN), dtype=np.int32)
    task_priority = np.zeros(T, dtype=np.int32)
    task_uid_rank = np.zeros(T, dtype=np.int32)
    task_node = np.full(T, -1, dtype=np.int32)
    task_ports = np.zeros((T, W), dtype=np.int32)
    task_valid = np.zeros(T, dtype=bool)
    task_best_effort = np.zeros(T, dtype=bool)

    uid_sorted = sorted(tasks, key=lambda t: t.uid)
    for rank, t in enumerate(uid_sorted):
        task_uid_rank[t.ordinal] = rank
    job_of_task: Dict[str, int] = {}
    for j in jobs:
        for t in j.tasks.values():
            job_of_task[t.uid] = j.ordinal
    for t in tasks:
        i = t.ordinal
        task_resreq[i] = to_device_units(t.resreq)
        task_job[i] = job_of_task[t.uid]
        task_status[i] = int(t.status)
        task_priority[i] = t.priority
        task_node[i] = node_ord.get(t.node_name, -1)
        task_ports[i] = _ports_mask(t.host_ports, upos)
        task_valid[i] = True
        task_best_effort[i] = t.best_effort

    # --- task groups (pending tasks only; the allocate unit) ---
    group_key_to_ord: Dict[Tuple, int] = {}
    group_members: List[List[TaskInfo]] = []
    for t in tasks:
        if t.status != TaskStatus.PENDING:
            continue
        key = group_signature(
            t,
            job_of_task[t.uid],
            task_klass[t.ordinal],
            task_pa_class[t.ordinal],
            task_aff_ids.get(t.ordinal, ()),
            task_anti_ids.get(t.ordinal, ()),
        )
        g = group_key_to_ord.setdefault(key, len(group_members))
        if g == len(group_members):
            group_members.append([])
        group_members[g].append(t)

    # floor 32: the pending-group count breathes every cycle under live
    # churn (each arrival is a fresh group until placed)
    G = _bucket(len(group_members), 32, 32, key="groups")
    task_group = np.full(T, -1, dtype=np.int32)
    task_group_rank = np.zeros(T, dtype=np.int32)
    group_job = np.zeros(G, dtype=np.int32)
    group_resreq = np.zeros((G, R), dtype=np.float32)
    group_klass = np.zeros(G, dtype=np.int32)
    group_ports_arr = np.zeros((G, W), dtype=np.int32)
    group_size = np.zeros(G, dtype=np.int32)
    group_priority = np.zeros(G, dtype=np.int32)
    group_uid_rank = np.zeros(G, dtype=np.int32)
    group_best_effort = np.zeros(G, dtype=bool)
    group_valid = np.zeros(G, dtype=bool)
    for g, members in enumerate(group_members):
        members.sort(key=lambda t: task_uid_rank[t.ordinal])
        for rank, t in enumerate(members):
            task_group[t.ordinal] = g
            task_group_rank[t.ordinal] = rank
        rep = members[0]
        group_job[g] = job_of_task[rep.uid]
        group_resreq[g] = to_device_units(rep.resreq)
        group_klass[g] = task_klass[rep.ordinal]
        group_ports_arr[g] = _ports_mask(rep.host_ports, upos)
        group_size[g] = len(members)
        group_priority[g] = rep.priority
        group_uid_rank[g] = task_uid_rank[rep.ordinal]
        group_best_effort[g] = rep.best_effort
        group_valid[g] = True

    # per-group pod-affinity columns (term axes sized 0 when unused, so
    # the decision plane skips the feature)
    MA = max((len(set(v)) for v in task_aff_ids.values()), default=0)
    MB = max((len(set(v)) for v in task_anti_ids.values()), default=0)
    group_pa_class = np.zeros(G, dtype=np.int32)
    group_aff_terms = np.full((G, MA), -1, dtype=np.int32)
    group_anti_terms = np.full((G, MB), -1, dtype=np.int32)
    for g, members in enumerate(group_members):
        rep = members[0]
        group_pa_class[g] = task_pa_class[rep.ordinal]
        for m, tid in enumerate(sorted(set(task_aff_ids.get(rep.ordinal, ())))):
            group_aff_terms[g, m] = tid
        for m, tid in enumerate(sorted(set(task_anti_ids.get(rep.ordinal, ())))):
            group_anti_terms[g, m] = tid

    # --- node tensors ---
    node_idle = np.zeros((N, R), dtype=np.float32)
    node_releasing = np.zeros((N, R), dtype=np.float32)
    node_alloc = np.zeros((N, R), dtype=np.float32)
    node_max_tasks = np.zeros(N, dtype=np.int32)
    node_num_tasks = np.zeros(N, dtype=np.int32)
    node_ports = np.zeros((N, W), dtype=np.int32)
    node_unsched = np.zeros(N, dtype=bool)
    node_valid = np.zeros(N, dtype=bool)
    for n in nodes:
        i = n.ordinal
        node_idle[i] = to_device_units(n.idle)
        node_releasing[i] = to_device_units(n.releasing)
        node_alloc[i] = to_device_units(n.allocatable)
        node_max_tasks[i] = n.max_tasks
        node_num_tasks[i] = len(n.tasks)
        for t in n.tasks.values():
            node_ports[i] |= _ports_mask(t.host_ports, upos)
        node_unsched[i] = n.unschedulable
        node_valid[i] = True

    # --- job tensors ---
    job_queue = np.zeros(J, dtype=np.int32)
    job_min_available = np.zeros(J, dtype=np.int32)
    job_priority = np.zeros(J, dtype=np.int32)
    job_creation_rank = np.zeros(J, dtype=np.int32)
    job_valid = np.zeros(J, dtype=bool)
    for rank, j in enumerate(sorted(jobs, key=lambda j: (j.creation_ts, j.uid))):
        job_creation_rank[j.ordinal] = rank
    for j in jobs:
        i = j.ordinal
        job_queue[i] = queue_ord.get(j.queue_uid, 0)
        job_min_available[i] = j.min_available
        job_priority[i] = j.priority
        job_valid[i] = j.queue_uid in queue_ord

    # --- queue tensors ---
    queue_weight = np.zeros(Q, dtype=np.float32)
    # queues were ordinal-assigned in uid order, so uid rank == ordinal
    queue_uid_rank = np.arange(Q, dtype=np.int32)
    queue_valid = np.zeros(Q, dtype=bool)
    for q in queues:
        queue_weight[q.ordinal] = float(q.weight)
        queue_valid[q.ordinal] = True

    others_used = to_device_units(res.sum_resources(t.resreq for t in cluster.others)) if cluster.others else np.zeros(R, dtype=np.float32)

    tensors = HostPack(
        task_resreq=task_resreq,
        task_job=task_job,
        task_status=task_status,
        task_priority=task_priority,
        task_uid_rank=task_uid_rank,
        task_klass=task_klass,
        task_node=task_node,
        task_ports=task_ports,
        task_valid=task_valid,
        task_best_effort=task_best_effort,
        task_group=task_group,
        task_group_rank=task_group_rank,
        group_job=group_job,
        group_resreq=group_resreq,
        group_klass=group_klass,
        group_ports=group_ports_arr,
        group_size=group_size,
        group_priority=group_priority,
        group_uid_rank=group_uid_rank,
        group_best_effort=group_best_effort,
        group_valid=group_valid,
        node_idle=node_idle,
        node_releasing=node_releasing,
        node_alloc=node_alloc,
        node_max_tasks=node_max_tasks,
        node_num_tasks=node_num_tasks,
        node_klass=node_klass,
        node_ports=node_ports,
        node_unsched=node_unsched,
        node_valid=node_valid,
        job_queue=job_queue,
        job_min_available=job_min_available,
        job_priority=job_priority,
        job_creation_rank=job_creation_rank,
        job_valid=job_valid,
        queue_weight=queue_weight,
        queue_uid_rank=queue_uid_rank,
        queue_valid=queue_valid,
        class_fit=class_fit,
        task_pa_class=task_pa_class,
        group_pa_class=group_pa_class,
        group_aff_terms=group_aff_terms,
        group_anti_terms=group_anti_terms,
        node_dom=pa["node_dom"],
        aff_key=pa["aff_key"],
        anti_key=pa["anti_key"],
        aff_static=pa["aff_static"],
        anti_static=pa["anti_static"],
        aff_static_total=pa["aff_static_total"],
        aff_match=pa["aff_match"],
        anti_match=pa["anti_match"],
        symm_ok=pa["symm_ok"],
        others_used=others_used,
        n_valid_queues=np.int32(len(queues)),
        **build_reclaim_pack(
            task_status, task_node, task_valid, task_job,
            task_priority, task_uid_rank, job_queue, N, sticky=True,
        ),
    )
    assert_pack_dtypes(tensors)
    index = SnapshotIndex(tasks=tasks, nodes=nodes, jobs=jobs, queues=queues, port_universe=universe)
    return Snapshot(tensors=tensors, index=index)
