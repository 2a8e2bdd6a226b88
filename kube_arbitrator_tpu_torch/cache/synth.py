"""O(T) vectorized synthetic world generator (the port's own copy of the
reference's cache/synth.py:77-261).

One predicate class, no ports; jobs with drawn resource profiles across Q
queues, a gang fraction, and a running fraction pre-placed round-robin
across nodes with exact node accounting.  The arrays are built with numpy
from ``seed`` and equal the reference's field for field.

``pod_affinity=True`` adds topology labels and a per-job mix of pod
(anti-)affinity terms (:func:`pod_affinity_tables`), encoded in the
layout of the reference's ``_build_pod_affinity`` (cache/snapshot.py:
503-636); the other arrays are the same as without it.

``priority_mix=True`` draws job, pending-group and running-task
priorities from ``PRIORITIES`` and leaves a pending tail on a share of
the running jobs (:func:`priority_tables`), so preempt's phase 2 (a
pending group evicting lower-priority running tasks of its own job) has
work.  With it off every array is the same as before the mix existed.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Optional, Tuple

import numpy as np

from ..api import resource as res
from ..api.types import TaskStatus
from ..device import DeviceLike
from .snapshot import (
    MAX_PORT_WORDS, Snapshot, _bucket, build_reclaim_pack, from_numpy, to_device_units,
    trivial_pod_affinity,
)

HOSTNAME_KEY = "kubernetes.io/hostname"
RACK_KEY = "topology.kubernetes.io/rack"
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"  # the k8s 1.13 zone label
NODES_PER_RACK = 40
NUM_ZONES = 4
# per-job draw of the pod-affinity mix: (cumulative bound, category)
PA_MIX = ((0.2, "self_aff_rack"), (0.4, "self_anti_host"), (0.5, "aff_zone_cache"),
          (0.6, "anti_host_noisy"))
PA_CACHE_RUNNING = 0.05    # RUNNING jobs labelled tier=cache
PA_NOISY_RUNNING = 0.05    # RUNNING jobs labelled tier=noisy (with an anti term)
PA_LATENCY_PENDING = 0.10  # pending jobs labelled tier=latency
# the priority mix: pod priorities 1-3 as the reference bench's ingest row
# draws them (bench.py:991); the running jobs that scale up keep the last
# quarter of their tasks pending as one group of their own
PRIORITIES = (1, 3)
PRIO_SCALE_UP = 0.5
PRIO_TAIL = 0.25

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
    pod_affinity: bool = False,
    priority_mix: bool = False,
) -> Tuple[Dict[str, np.ndarray], SynthIndex]:
    """The pack of a ``num_tasks`` x ``num_nodes`` world as numpy arrays.
    ``fit_fraction`` sizes node capacity as that multiple of total demand;
    ``running_fraction`` of JOBS are pre-placed RUNNING; ``pod_affinity``
    adds the affinity mix of :func:`pod_affinity_tables`, ``priority_mix``
    the priorities of :func:`priority_tables` (not both)."""
    if pod_affinity and priority_mix:
        raise ValueError("the priority mix gives running jobs pending groups, which the "
                         "pod-affinity mix does not label; pick one")
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
    prio = priority_tables(seed, running_job, job_len) if priority_mix else None
    # pending tasks at the end of each running job (none without the mix)
    tail = prio["tail"] if prio else np.zeros(J_real, np.int64)

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
    run_task = running_job[tjob] & (task_ids < job_start[tjob] + job_len[tjob] - tail[tjob])
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

    # ---- groups: one per job with pending tasks ----
    pending_job = ~running_job | (tail > 0)
    g_of_job = np.cumsum(pending_job) - 1
    G_real = int(pending_job.sum())
    # first pending task of each job, relative to the job's start
    group_first = np.where(running_job, job_len - tail, 0)
    G = _bucket(max(G_real, 1), 32, 32)
    task_group = np.full(T, -1, dtype=np.int32)
    pend_rows = np.nonzero(~run_task)[0]
    task_group[pend_rows] = g_of_job[tjob[pend_rows]]
    task_group_rank = np.zeros(T, dtype=np.int32)
    task_group_rank[:T_real] = task_ids - job_start[tjob]
    task_group_rank[pend_rows] -= group_first[tjob[pend_rows]].astype(np.int32)

    pjobs = np.nonzero(pending_job)[0]
    group_job = np.zeros(G, dtype=np.int32)
    group_job[:G_real] = pjobs
    group_resreq = np.zeros((G, R), dtype=np.float32)
    group_resreq[:G_real] = job_req_dev[pjobs]
    group_size = np.zeros(G, dtype=np.int32)
    group_size[:G_real] = (job_len - group_first)[pjobs]
    group_uid_rank = np.zeros(G, dtype=np.int32)
    group_uid_rank[:G_real] = (job_start + group_first)[pjobs]
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

    task_priority = np.zeros(T, dtype=np.int32)
    group_priority = np.zeros(G, dtype=np.int32)
    job_priority = np.zeros(J, dtype=np.int32)
    if prio:
        job_priority[:J_real] = prio["job"]
        group_priority[:G_real] = prio["group"][pjobs]
        task_priority[:T_real] = np.where(run_task, prio["task"], prio["group"][tjob])

    arrays = dict(
        task_resreq=task_resreq,
        task_job=task_job,
        task_status=task_status,
        task_priority=task_priority,
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
        group_priority=group_priority,
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
        job_priority=job_priority,
        job_creation_rank=job_creation_rank,
        job_valid=job_valid,
        queue_weight=queue_weight,
        queue_uid_rank=np.arange(Q, dtype=np.int32),
        queue_valid=queue_valid,
        class_fit=np.ones((1, 1), dtype=bool),
        others_used=np.zeros(R, dtype=np.float32),
        **build_reclaim_pack(
            task_status, task_node, task_valid, task_job,
            task_priority, task_uid_rank, job_queue, N,
        ),
    )
    if pod_affinity:
        arrays.update(pod_affinity_tables(
            seed, N_real, T, N, G, task_job, task_status, task_node, task_valid, running_job,
            pjobs,
        ))
    else:
        arrays.update(trivial_pod_affinity(T, N, G))
    return arrays, SynthIndex(T_real, N_real)


def priority_tables(seed: int, running_job: np.ndarray, job_len: np.ndarray) -> Dict[str, np.ndarray]:
    """The priority mix of a world, drawn from ``seed`` with a generator of
    its own (the base world's draws are unchanged): per job a priority
    and its pending group's priority, per task a priority that its
    running tasks keep (pending tasks take their group's), all in
    ``PRIORITIES``; and per job the length of its pending tail —
    ``PRIO_TAIL`` of the tasks (at least one, never all) of a
    ``PRIO_SCALE_UP`` share of the running jobs, 0 elsewhere."""
    rng = np.random.default_rng([seed, 0x9B])
    lo, hi = PRIORITIES
    J_real = running_job.shape[0]
    job = rng.integers(lo, hi + 1, J_real)
    group = rng.integers(lo, hi + 1, J_real)
    task = rng.integers(lo, hi + 1, int(job_len.sum()))
    scale_up = running_job & (rng.random(J_real) < PRIO_SCALE_UP)
    tail = np.where(scale_up, np.minimum(np.ceil(job_len * PRIO_TAIL), job_len - 1), 0)
    return dict(job=job, group=group, task=task, tail=tail.astype(np.int64))


@dataclasses.dataclass(frozen=True)
class Term:
    """One required pod (anti-)affinity term with a one-label selector,
    scoped to the world's single namespace."""

    label: Tuple[str, str]
    key: str
    anti: bool


def pa_world_labels(seed: int, num_jobs: int, running_job: np.ndarray):
    """The affinity mix of a world, drawn from ``seed`` with a generator of
    its own (the base world's draws are unchanged).  Every job is labelled
    ``app=job-<k>``.  Per pending job: 20% self-affinity on the rack key
    (a gang that wants one rack), 20% self-anti-affinity on hostname (one
    replica per node), 10% affinity on zone to ``tier=cache``, 10%
    anti-affinity on hostname to ``tier=noisy``, the rest none; 10% of
    pending jobs are labelled ``tier=latency``.  5% of RUNNING jobs are
    labelled ``tier=cache`` and 5% ``tier=noisy``, and the noisy pods
    carry an anti term of their own against ``tier=latency`` on hostname.
    Returns (tier label per job or "", the pending jobs' term lists, the
    running jobs' term lists), term lists as dicts job -> [Term]."""
    rng = np.random.default_rng([seed, 0x9A])
    u = rng.random(num_jobs)
    v = rng.random(num_jobs)
    w = rng.random(num_jobs)
    tier = np.full(num_jobs, "", dtype=object)
    tier[running_job & (v < PA_CACHE_RUNNING)] = "cache"
    tier[running_job & (v >= PA_CACHE_RUNNING) & (v < PA_CACHE_RUNNING + PA_NOISY_RUNNING)] = "noisy"
    tier[~running_job & (w < PA_LATENCY_PENDING)] = "latency"
    pending_terms: Dict[int, list] = {}
    lo = 0.0
    for hi, cat in PA_MIX:
        for k in np.nonzero(~running_job & (u >= lo) & (u < hi))[0].tolist():
            app = ("app", f"job-{k}")
            pending_terms[k] = [{
                "self_aff_rack": Term(app, RACK_KEY, False),
                "self_anti_host": Term(app, HOSTNAME_KEY, True),
                "aff_zone_cache": Term(("tier", "cache"), ZONE_KEY, False),
                "anti_host_noisy": Term(("tier", "noisy"), HOSTNAME_KEY, True),
            }[cat]]
        lo = hi
    running_terms = {k: [Term(("tier", "latency"), HOSTNAME_KEY, True)]
                     for k in np.nonzero(tier == "noisy")[0].tolist()}
    return tier, pending_terms, running_terms


def node_label_value(key: str, n: np.ndarray) -> np.ndarray:
    """i64 label value id of nodes ``n`` under ``key``: hostname is the
    node, racks hold NODES_PER_RACK consecutive nodes, zones take racks
    round-robin."""
    rack = n // NODES_PER_RACK
    return {HOSTNAME_KEY: n, RACK_KEY: rack, ZONE_KEY: rack % NUM_ZONES}[key]


def pod_affinity_tables(seed, N_real, T, N, G, task_job, task_status, task_node, task_valid,
                        running_job, pjobs) -> Dict[str, np.ndarray]:
    """The pa fields of the synthetic world in the reference's layout:
    pod label classes, terms and domains numbered in first-appearance
    order, the static counts over every existing pod (a task holding a
    node), ``symm_ok`` [0, N] when no existing anti term matches a class.
    Vectorized over pods: O(T + terms x classes)."""
    J_real = running_job.shape[0]
    tier, pending_terms, running_terms = pa_world_labels(seed, J_real, running_job)
    if not pending_terms and not running_terms:
        return trivial_pod_affinity(T, N, G)
    pending = task_valid & (task_status == int(TaskStatus.PENDING))
    # ---- pod label classes: one per pending job (its labels differ) ----
    cls_of_job = np.full(J_real, -1, np.int64)
    cls_of_job[pjobs] = np.arange(len(pjobs))
    task_pa_class = np.zeros(T, np.int32)
    task_pa_class[pending] = cls_of_job[task_job[pending]]
    CP = max(1, len(pjobs))
    # ---- terms, in first-appearance order over the pending jobs ----
    aff_terms, anti_terms = {}, {}
    job_aff, job_anti = {}, {}
    for k in pjobs.tolist():
        for term in pending_terms.get(k, ()):
            table, per = (anti_terms, job_anti) if term.anti else (aff_terms, job_aff)
            per.setdefault(k, []).append(table.setdefault(term, len(table)))
    aff_list, anti_list = list(aff_terms), list(anti_terms)
    keys: Dict[str, int] = {}
    for term in aff_list + anti_list:
        keys.setdefault(term.key, len(keys))
    # ---- global domains, first appearance over (node, key) ----
    K = len(keys)
    nodes = np.arange(N_real)
    vals = np.stack([node_label_value(key, nodes) for key in keys]) if K else np.zeros((0, N_real), np.int64)
    code = (np.arange(K)[:, None] * (N_real + 1) + vals).T.reshape(-1)  # node-major
    uniq, first = np.unique(code, return_index=True)
    ordinal = np.empty(len(uniq), np.int64)
    ordinal[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    node_dom = np.full((K, N), -1, np.int32)
    node_dom[:, :N_real] = ordinal[np.searchsorted(uniq, code)].reshape(N_real, K).T
    D = max(1, len(uniq))
    # ---- static counts over existing pods ----
    existing = np.nonzero(task_valid & (task_node >= 0))[0]
    ex_job = task_job[existing]
    ex_node = task_node[existing].astype(np.int64)
    ex_tier = tier[ex_job]
    by_job = np.argsort(ex_job, kind="stable")
    job_start = np.searchsorted(ex_job[by_job], np.arange(J_real + 1))

    def pods_matching(label):
        """Indices into ``existing``: a job's own pods by its slice of
        ``by_job``, a tier's by one pass (two tier selectors exist)."""
        name, value = label
        if name == "app":
            k = int(value[len("job-"):])
            return by_job[job_start[k]:job_start[k + 1]]
        return np.nonzero(ex_tier == value)[0]

    def static(terms, key_arr):
        out = np.zeros((len(terms), D), np.int32)
        total = np.zeros(len(terms), np.int32)
        for tid, term in enumerate(terms):
            key_arr[tid] = keys[term.key]
            m = pods_matching(term.label)
            total[tid] = len(m)
            out[tid] = np.bincount(node_dom[keys[term.key], ex_node[m]], minlength=D)[:D]
        return out, total

    aff_key = np.zeros(len(aff_list), np.int32)
    anti_key = np.zeros(len(anti_list), np.int32)
    aff_static, aff_static_total = static(aff_list, aff_key)
    anti_static, _ = static(anti_list, anti_key)
    # ---- selector x class ----
    cls_app = pjobs.astype(np.int64)
    cls_tier = tier[pjobs]

    def match(terms):
        out = np.zeros((len(terms), CP), bool)
        for tid, term in enumerate(terms):
            name, value = term.label
            if name == "app":
                out[tid, :len(pjobs)] = cls_app == int(value[len("job-"):])
            else:
                out[tid, :len(pjobs)] = cls_tier == value
        return out

    # ---- static symmetry: existing pods' anti terms vs incoming classes.
    # Every running term is (tier=latency, hostname): it blocks its own
    # node for the latency classes ----
    symm_ok = np.ones((CP, N), bool)
    ex_anti = np.isin(ex_job, np.fromiter(running_terms, np.int64, len(running_terms)))
    lat_cls = np.nonzero(cls_tier == "latency")[0]
    if ex_anti.any() and len(lat_cls):
        symm_ok[np.ix_(lat_cls, np.unique(ex_node[ex_anti]))] = False
    else:
        symm_ok = np.ones((0, N), bool)
    # ---- per-group columns (one group per pending job) ----
    MA = max((len(v) for v in job_aff.values()), default=0)
    MB = max((len(v) for v in job_anti.values()), default=0)
    group_pa_class = np.zeros(G, np.int32)
    group_pa_class[:len(pjobs)] = np.arange(len(pjobs))
    group_aff_terms = np.full((G, MA), -1, np.int32)
    group_anti_terms = np.full((G, MB), -1, np.int32)
    for g, k in enumerate(pjobs.tolist()):
        for m, tid in enumerate(sorted(job_aff.get(k, ()))):
            group_aff_terms[g, m] = tid
        for m, tid in enumerate(sorted(job_anti.get(k, ()))):
            group_anti_terms[g, m] = tid
    return dict(
        task_pa_class=task_pa_class, group_pa_class=group_pa_class,
        group_aff_terms=group_aff_terms, group_anti_terms=group_anti_terms, node_dom=node_dom,
        aff_key=aff_key, anti_key=anti_key, aff_static=aff_static, anti_static=anti_static,
        aff_static_total=aff_static_total, aff_match=match(aff_list),
        anti_match=match(anti_list), symm_ok=symm_ok,
    )


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
    pod_affinity: bool = False,
    device: DeviceLike = None,
    priority_mix: bool = False,
) -> Snapshot:
    """:func:`build_synthetic_arrays` packed onto ``device``."""
    arrays, index = build_synthetic_arrays(
        num_tasks, num_nodes, num_queues, tasks_per_job, seed,
        running_fraction, gang_fraction, fit_fraction, max_tasks_per_node, pod_affinity,
        priority_mix,
    )
    return Snapshot(tensors=from_numpy(arrays, device), index=index)


# ---------------------------------------------------------------------------
# the serving path's delta stream: array-level churn between epochs


def _no_pod_affinity(arrays: Dict[str, np.ndarray]) -> None:
    if (arrays["group_aff_terms"].shape[1] or arrays["group_anti_terms"].shape[1]
            or arrays["symm_ok"].shape[0]):
        raise ValueError("the pack carries pod-affinity terms, whose per-domain counts "
                         "move with every completion; rebuild it instead")


def pick_churn(arrays: Dict[str, np.ndarray], frac: float, cycle: int) -> np.ndarray:
    """Ascending rows of the RUNNING tasks to complete before epoch
    ``cycle``: ``max(1, int(frac * running))`` of them, drawn by the seeded
    sample of the reference bench's ``_pipe_churn`` (bench.py:717-744)
    over the running rows in ordinal order."""
    running = np.nonzero((arrays["task_status"] == int(TaskStatus.RUNNING))
                         & arrays["task_valid"])[0]
    if not len(running):
        return running
    k = min(len(running), max(1, int(len(running) * frac)))
    pick = random.Random(f"kat-pipe-churn:{cycle}").sample(range(len(running)), k)
    return np.sort(running[np.asarray(pick, np.int64)])


def complete_running(arrays: Dict[str, np.ndarray], rows: np.ndarray) -> Dict[str, np.ndarray]:
    """The pack after the RUNNING tasks at ``rows`` complete, as a
    reference arena packs it: they turn SUCCEEDED and keep their node
    ordinal; each node gets their requests back in idle, loses them from
    its task count and recomputes its host-port mask from the tasks left
    on it; the reclaim canon pack is rebuilt.  Returns a new mapping that
    shares the unchanged arrays.  Packs with pod-affinity terms raise."""
    _no_pod_affinity(arrays)
    rows = np.asarray(rows, np.int64)
    status = arrays["task_status"]
    if len(np.unique(rows)) != len(rows):
        raise ValueError("complete_running: a row repeats")
    if not ((status[rows] == int(TaskStatus.RUNNING)) & arrays["task_valid"][rows]
            & (arrays["task_node"][rows] >= 0)).all():
        raise ValueError("complete_running: a row is not a placed RUNNING task")
    out = dict(arrays)
    status = out["task_status"] = status.copy()
    status[rows] = int(TaskStatus.SUCCEEDED)
    nodes = arrays["task_node"][rows].astype(np.int64)
    idle = out["node_idle"] = arrays["node_idle"].copy()
    np.add.at(idle, nodes, arrays["task_resreq"][rows])
    num = out["node_num_tasks"] = arrays["node_num_tasks"].copy()
    np.subtract.at(num, nodes, 1)
    touched = np.unique(nodes)
    ports = out["node_ports"] = arrays["node_ports"].copy()
    ports[touched] = 0
    on_node = (arrays["task_valid"] & np.isin(arrays["task_node"], touched)
               & (status != int(TaskStatus.SUCCEEDED)) & (status != int(TaskStatus.FAILED)))
    t = np.nonzero(on_node)[0]
    np.bitwise_or.at(ports, arrays["task_node"][t].astype(np.int64), arrays["task_ports"][t])
    rv = build_reclaim_pack(status, out["task_node"], out["task_valid"], out["task_job"],
                            out["task_priority"], out["task_uid_rank"], out["job_queue"],
                            idle.shape[0])
    out.update(rv)
    return out


def cordon(arrays: Dict[str, np.ndarray], rows: np.ndarray) -> Dict[str, np.ndarray]:
    """The pack with ``node_unsched`` flipped at node ``rows`` (a cordon
    or an uncordon); a new mapping sharing the other arrays."""
    out = dict(arrays)
    unsched = out["node_unsched"] = arrays["node_unsched"].copy()
    unsched[rows] = ~unsched[rows]
    return out


def epoch_stream(arrays: Dict[str, np.ndarray], epochs: int, churn: float = 0.04,
                 cordon_frac: float = 0.0, seed: int = 0):
    """Epochs 1..``epochs`` of a served world from its pack ``arrays``:
    (epoch, pack, PackMeta).  Epoch 1 has no base; before each later epoch
    e the ``churn`` share of the running tasks that ``pick_churn(pack,
    churn, e)`` draws complete, and ``cordon_frac`` of the valid nodes
    (drawn from ``seed``) flip their cordon; its PackMeta names the fields
    that changed."""
    from .arena import PackMeta, changed_fields

    rng = np.random.default_rng(seed)
    nodes = np.nonzero(arrays["node_valid"])[0]
    meta = PackMeta(key="epoch-1", base_key=None, changed_fields=())
    yield 1, arrays, meta
    for e in range(2, epochs + 1):
        new = complete_running(arrays, pick_churn(arrays, churn, e))
        if cordon_frac:
            new = cordon(new, rng.choice(nodes, int(len(nodes) * cordon_frac), replace=False))
        meta = PackMeta(key=f"epoch-{e}", base_key=meta.key, changed_fields=changed_fields(arrays, new))
        arrays = new
        yield e, arrays, meta
