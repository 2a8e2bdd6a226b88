"""The pack: one cycle's dense state as torch tensors.

A copy of the fields of the reference's ``cache/snapshot.SnapshotTensors``
that allocate and backfill read (kube_arbitrator_tpu/cache/snapshot.py:
145-274), in the same dtypes (i32 / f32 / bool).  The pod-affinity term
axes are kept only so that :func:`from_numpy` can refuse packs that use
them; the reclaim canon fields (``rv_*``) are left out.

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
    "group_aff_terms": (np.int32, 2),
    "group_anti_terms": (np.int32, 2),
    "symm_ok": (np.bool_, 2),
    "others_used": (np.float32, 1),
}

# Reference pack fields this slice does not read: the reclaim canon pack
# and the pod-affinity tables (which only matter when terms exist, and
# packs with terms are refused).
IGNORED_FIELDS = frozenset({
    "task_pa_class", "group_pa_class", "node_dom", "aff_key", "anti_key",
    "aff_static", "anti_static", "aff_static_total", "aff_match",
    "anti_match", "n_valid_queues",
})


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
    group_aff_terms: torch.Tensor  # i32[G, MA] (MA == 0 in accepted packs)
    group_anti_terms: torch.Tensor  # i32[G, MB] (MB == 0)
    symm_ok: torch.Tensor          # bool[CS, N] (CS == 0)
    others_used: torch.Tensor      # f32[R]

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
    ``rv_*`` and the pod-affinity tables are ignored.  Packs with
    pod-affinity terms raise NotImplementedError (a later slice ports
    the immediate path they need)."""
    dev = resolve_device(device)
    unknown = sorted(
        k for k in arrays
        if k not in SCHEMA and k not in IGNORED_FIELDS and not k.startswith("rv_")
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
    st = SnapshotTensors(**out)
    if pa_enabled(st):
        raise NotImplementedError(
            "pod-affinity packs need the immediate allocate path "
            "(port slice 4: ops/podaffinity.py)"
        )
    return st


@dataclasses.dataclass
class Snapshot:
    tensors: SnapshotTensors
    index: Any  # ordinal -> identity lookup (cache/synth.SynthIndex)
