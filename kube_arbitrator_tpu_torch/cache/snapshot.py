"""The pack: one cycle's dense state as torch tensors.

A copy of the fields of the reference's ``cache/snapshot.SnapshotTensors``
that the ported actions read (kube_arbitrator_tpu/cache/snapshot.py:
145-274), in the same dtypes (i32 / f32 / bool): the task, group, node,
job and queue tables, the pod-(anti-)affinity tables (topology domains,
pod label classes, term ordinals with their static per-domain counts;
:func:`trivial_pod_affinity` is the no-terms encoding), and the reclaim
canon pack (``rv_*``, built by :func:`build_reclaim_pack`).

Device resource units are ``[milli-cpu, MiB, milli-gpu, attach x100]``,
in which the reference's epsilon slack is uniformly ``10.0``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

DEVICE_SCALE = np.array(
    [1.0, 1.0 / (1024.0 * 1024.0), 1.0, 100.0], dtype=np.float64
)
DEVICE_DTYPE = np.float32
DEVICE_EPSILON = 10.0
MAX_PORT_WORDS = 2  # 31 usable bits per int32 word -> 62 host ports/snapshot


def _bucket(n: int, multiple: int, minimum: int) -> int:
    """Round ``n`` up to a padded axis length: multiples of
    max(``multiple``, ~n/16), at least ``minimum`` — the reference's
    geometric buckets without its process-level sticky memo."""
    n = max(n, 1)
    gran = max(multiple, 1 << max(0, n.bit_length() - 5))
    b = ((n + gran - 1) // gran) * gran
    return max(b, minimum)


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
) -> Dict[str, Any]:
    """Host-side canon ordering of reclaim victim candidates (a copy of
    the reference's cache/snapshot.py:277-365).

    Candidates are the RUNNING tasks on a node, sorted by (node, queue,
    job, priority, uid) so that node blocks, (node, queue) segments and
    (node, job) segments are contiguous.  ``rv_window`` (the longest node
    block, bucketed) bounds the per-claim eviction window; the arrays
    carry at least that much padding past the last block, so a window
    never runs off the end.  The buckets are the reference's geometric
    ones without its process-level sticky memo (which only damps jit
    recompiles under churn; decisions do not depend on padding)."""
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
    window = _bucket(window, 32, 32)
    Vp = _bucket(V + window, 1024, 1024)
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
    tensors: SnapshotTensors
    index: Any  # ordinal -> identity lookup (cache/synth.SynthIndex)
