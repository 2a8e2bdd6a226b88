"""O(T) vectorized synthetic world generator (the port's own copy of the
reference's cache/synth.py:77-261).

One predicate class, no ports, no pod affinity; jobs with drawn resource
profiles across Q queues, a gang fraction, and a running fraction
pre-placed round-robin across nodes with exact node accounting.  The
arrays are built with numpy from ``seed`` and equal the reference's field
for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..api import resource as res
from ..api.types import TaskStatus
from ..device import DeviceLike
from .snapshot import (
    MAX_PORT_WORDS, Snapshot, _bucket, build_reclaim_pack, from_numpy, to_device_units,
)

# (cpu milli, memory bytes, gpu milli) request profiles
_PROFILES = np.array(
    [
        [500, 1 * 1024**3, 0],
        [1000, 2 * 1024**3, 0],
        [2000, 4 * 1024**3, 0],
        [4000, 8 * 1024**3, 1000],
        [1000, 16 * 1024**3, 0],
    ],
    dtype=np.float64,
)


@dataclasses.dataclass
class SynthIndex:
    """Ordinal-lookup decode index: uids/names are functions of the
    ordinal."""

    num_tasks: int
    num_nodes: int

    def task_uid(self, i: int) -> str:
        return f"synth-t{i:07d}"

    def node_name(self, n: int) -> str:
        return f"synth-n{n:06d}"


def build_synthetic_arrays(
    num_tasks: int,
    num_nodes: int,
    num_queues: int = 8,
    tasks_per_job: int = 1000,
    seed: int = 0,
    running_fraction: float = 0.0,
    gang_fraction: float = 0.5,
    fit_fraction: float = 1.2,
    max_tasks_per_node: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], SynthIndex]:
    """The pack of a ``num_tasks`` x ``num_nodes`` world as numpy arrays.
    ``fit_fraction`` sizes node capacity as that multiple of total demand;
    ``running_fraction`` of JOBS are pre-placed RUNNING."""
    rng = np.random.default_rng(seed)
    T_real, N_real = int(num_tasks), int(num_nodes)
    J_real = max(1, -(-T_real // tasks_per_job))
    Q_real = max(1, int(num_queues))
    R = res.NUM_RESOURCES
    W = MAX_PORT_WORDS

    T = _bucket(T_real, 8, 8)
    N = _bucket(N_real, 128, 128)
    J = _bucket(J_real, 32, 32)
    Q = _bucket(Q_real, 8, 8)

    # ---- jobs: contiguous task blocks, drawn profiles ----
    task_ids = np.arange(T_real, dtype=np.int64)
    tjob = task_ids // tasks_per_job
    job_start = np.arange(J_real, dtype=np.int64) * tasks_per_job
    job_len = np.minimum(job_start + tasks_per_job, T_real) - job_start
    prof = rng.integers(0, len(_PROFILES), J_real)
    job_req_host = np.zeros((J_real, R), dtype=np.float64)
    job_req_host[:, :3] = _PROFILES[prof]
    job_req_dev = to_device_units(job_req_host)

    running_job = rng.random(J_real) < running_fraction
    gang_job = rng.random(J_real) < gang_fraction

    # ---- node capacity from total demand ----
    total_dev = (job_req_dev.astype(np.float64) * job_len[:, None]).sum(axis=0)
    per_node = total_dev * float(fit_fraction) / max(N_real, 1)
    # floor at one largest-profile task so single placements always fit
    per_node = np.maximum(per_node, job_req_dev.max(axis=0).astype(np.float64))
    node_alloc_row = per_node.astype(np.float32)

    # ---- task tensors ----
    task_resreq = np.zeros((T, R), dtype=np.float32)
    task_resreq[:T_real] = job_req_dev[tjob]
    task_job = np.zeros(T, dtype=np.int32)
    task_job[:T_real] = tjob
    task_status = np.full(T, int(TaskStatus.UNKNOWN), dtype=np.int32)
    run_task = running_job[tjob]
    task_status[:T_real] = np.where(
        run_task, int(TaskStatus.RUNNING), int(TaskStatus.PENDING)
    )
    task_node = np.full(T, -1, dtype=np.int32)
    run_rows = np.nonzero(run_task)[0]
    node_of_run = (np.arange(len(run_rows)) % N_real).astype(np.int32)
    task_node[run_rows] = node_of_run
    task_uid_rank = np.zeros(T, dtype=np.int32)
    task_uid_rank[:T_real] = task_ids
    task_valid = np.zeros(T, dtype=bool)
    task_valid[:T_real] = True

    # ---- groups: one per PENDING job ----
    pending_job = ~running_job
    g_of_job = np.cumsum(pending_job) - 1
    G_real = int(pending_job.sum())
    G = _bucket(max(G_real, 1), 32, 32)
    task_group = np.full(T, -1, dtype=np.int32)
    pend_rows = np.nonzero(~run_task)[0]
    task_group[pend_rows] = g_of_job[tjob[pend_rows]]
    task_group_rank = np.zeros(T, dtype=np.int32)
    task_group_rank[:T_real] = task_ids - job_start[tjob]

    pjobs = np.nonzero(pending_job)[0]
    group_job = np.zeros(G, dtype=np.int32)
    group_job[:G_real] = pjobs
    group_resreq = np.zeros((G, R), dtype=np.float32)
    group_resreq[:G_real] = job_req_dev[pjobs]
    group_size = np.zeros(G, dtype=np.int32)
    group_size[:G_real] = job_len[pjobs]
    group_uid_rank = np.zeros(G, dtype=np.int32)
    group_uid_rank[:G_real] = job_start[pjobs]
    group_valid = np.zeros(G, dtype=bool)
    group_valid[:G_real] = True

    # ---- node accounting (exact: used = scatter of running requests) ----
    used = np.zeros((N, R), dtype=np.float64)
    for r in range(R):
        used[:N_real, r] = np.bincount(
            node_of_run, weights=job_req_dev[tjob[run_rows], r].astype(np.float64),
            minlength=N_real,
        )[:N_real]
    node_alloc = np.zeros((N, R), dtype=np.float32)
    node_alloc[:N_real] = node_alloc_row[None, :]
    node_idle = np.zeros((N, R), dtype=np.float32)
    node_idle[:N_real] = (
        node_alloc[:N_real].astype(np.float64) - used[:N_real]
    ).astype(np.float32)
    node_num_tasks = np.zeros(N, dtype=np.int32)
    node_num_tasks[:N_real] = np.bincount(node_of_run, minlength=N_real)[:N_real]
    if max_tasks_per_node is None:
        max_tasks_per_node = int(-(-2 * T_real // max(N_real, 1))) + 8
    node_max_tasks = np.zeros(N, dtype=np.int32)
    node_max_tasks[:N_real] = max_tasks_per_node
    node_valid = np.zeros(N, dtype=bool)
    node_valid[:N_real] = True

    # ---- jobs / queues ----
    job_queue = np.zeros(J, dtype=np.int32)
    job_queue[:J_real] = np.arange(J_real) % Q_real
    job_min_available = np.zeros(J, dtype=np.int32)
    job_min_available[:J_real] = np.where(gang_job, job_len // 2 + 1, 0)
    job_creation_rank = np.zeros(J, dtype=np.int32)
    job_creation_rank[:J_real] = np.arange(J_real)
    job_valid = np.zeros(J, dtype=bool)
    job_valid[:J_real] = True
    queue_weight = np.zeros(Q, dtype=np.float32)
    queue_weight[:Q_real] = 1.0
    queue_valid = np.zeros(Q, dtype=bool)
    queue_valid[:Q_real] = True

    arrays = dict(
        task_resreq=task_resreq,
        task_job=task_job,
        task_status=task_status,
        task_priority=np.zeros(T, dtype=np.int32),
        task_uid_rank=task_uid_rank,
        task_klass=np.zeros(T, dtype=np.int32),
        task_node=task_node,
        task_ports=np.zeros((T, W), dtype=np.int32),
        task_valid=task_valid,
        task_best_effort=np.zeros(T, dtype=bool),
        task_group=task_group,
        task_group_rank=task_group_rank,
        group_job=group_job,
        group_resreq=group_resreq,
        group_klass=np.zeros(G, dtype=np.int32),
        group_ports=np.zeros((G, W), dtype=np.int32),
        group_size=group_size,
        group_priority=np.zeros(G, dtype=np.int32),
        group_uid_rank=group_uid_rank,
        group_best_effort=np.zeros(G, dtype=bool),
        group_valid=group_valid,
        node_idle=node_idle,
        node_releasing=np.zeros((N, R), dtype=np.float32),
        node_alloc=node_alloc,
        node_max_tasks=node_max_tasks,
        node_num_tasks=node_num_tasks,
        node_klass=np.zeros(N, dtype=np.int32),
        node_ports=np.zeros((N, W), dtype=np.int32),
        node_unsched=np.zeros(N, dtype=bool),
        node_valid=node_valid,
        job_queue=job_queue,
        job_min_available=job_min_available,
        job_priority=np.zeros(J, dtype=np.int32),
        job_creation_rank=job_creation_rank,
        job_valid=job_valid,
        queue_weight=queue_weight,
        queue_uid_rank=np.arange(Q, dtype=np.int32),
        queue_valid=queue_valid,
        class_fit=np.ones((1, 1), dtype=bool),
        group_aff_terms=np.full((G, 0), -1, dtype=np.int32),
        group_anti_terms=np.full((G, 0), -1, dtype=np.int32),
        symm_ok=np.zeros((0, N), dtype=bool),
        others_used=np.zeros(R, dtype=np.float32),
        **build_reclaim_pack(
            task_status, task_node, task_valid, task_job,
            np.zeros(T, dtype=np.int32), task_uid_rank, job_queue, N,
        ),
    )
    return arrays, SynthIndex(T_real, N_real)


def build_synthetic_snapshot(
    num_tasks: int,
    num_nodes: int,
    num_queues: int = 8,
    tasks_per_job: int = 1000,
    seed: int = 0,
    running_fraction: float = 0.0,
    gang_fraction: float = 0.5,
    fit_fraction: float = 1.2,
    max_tasks_per_node: Optional[int] = None,
    device: DeviceLike = None,
) -> Snapshot:
    """:func:`build_synthetic_arrays` packed onto ``device``."""
    arrays, index = build_synthetic_arrays(
        num_tasks, num_nodes, num_queues, tasks_per_job, seed,
        running_fraction, gang_fraction, fit_fraction, max_tasks_per_node,
    )
    return Snapshot(tensors=from_numpy(arrays, device), index=index)
