"""Per-job and per-pod "why not scheduled" diagnostics (the port's copy of
kube_arbitrator_tpu/ops/diagnostics.py).

Reproduces the reference's FitError histogram channel
(``api/job_info.go:329-358``: per-node fit deltas aggregated into
"0/3 nodes are available: 2 Insufficient cpu, 1 Insufficient memory" pod
conditions, surfaced via events in ``cache.go:637-662``) and the per-pod
``PodScheduled=False`` condition channel (``cache.go:456-474``
taskUnschedulable, stamped on every Pending/Allocated task of an
unschedulable job).

Computed host-side in numpy against the *end-of-cycle* node state carried
in CycleDecisions (so a node filled by this cycle's own placements reads
as insufficient, matching what the scheduler actually saw).  The pack and
the decisions are host numpy here (``framework.TorchDecider`` hands its
decisions back so); a HostView gathers the arrays once;
the histogram itself is one vectorized pass per batch of (resreq, class,
ports) rows — pods of the same scheduling group share a message, so the
per-pod channel costs O(G·N), not O(T·N).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..api.resource import RESOURCE_NAMES
from ..api.types import TaskStatus
from ..cache.snapshot import DEVICE_EPSILON, Snapshot


@dataclasses.dataclass
class HostView:
    """One-time host copies of the arrays diagnostics consult."""

    task_valid: np.ndarray
    task_status0: np.ndarray
    task_status1: np.ndarray
    task_job: np.ndarray
    task_resreq: np.ndarray
    task_klass: np.ndarray
    task_ports: np.ndarray
    node_valid: np.ndarray
    node_klass: np.ndarray
    node_unsched: np.ndarray
    node_idle: np.ndarray
    node_num_tasks: np.ndarray
    node_max_tasks: np.ndarray
    node_ports: np.ndarray
    class_fit: np.ndarray

    @classmethod
    def build(cls, snap: Snapshot, decisions) -> "HostView":
        t = snap.tensors
        return cls(
            task_valid=np.asarray(t.task_valid),
            task_status0=np.asarray(t.task_status),
            task_status1=np.asarray(decisions.task_status),
            task_job=np.asarray(t.task_job),
            task_resreq=np.asarray(t.task_resreq),
            task_klass=np.asarray(t.task_klass),
            task_ports=np.asarray(t.task_ports),
            node_valid=np.asarray(t.node_valid),
            node_klass=np.asarray(t.node_klass),
            node_unsched=np.asarray(t.node_unsched),
            node_idle=np.asarray(decisions.node_idle),
            node_num_tasks=np.asarray(decisions.node_num_tasks),
            node_max_tasks=np.asarray(t.node_max_tasks),
            node_ports=np.asarray(decisions.node_ports),
            class_fit=np.asarray(t.class_fit),
        )


def _fit_histograms(
    req: np.ndarray,    # f32[k, R] per-row resreq
    klass: np.ndarray,  # i32[k]
    ports: np.ndarray,  # i32[k, W]
    h: HostView,
) -> Tuple[List[Dict[str, int]], np.ndarray, int]:
    """Per-row FitError reason histograms for ``k`` (resreq, class,
    ports) rows at once: per node the FIRST failing reason in
    predicate-chain order is attributed (job_info.go:329-358's reason
    counts).  Returns ``(reason-counts per row, fitting-node counts,
    valid-node total)`` — the structured form behind both the message
    formatter and the ``pending_reason_total`` metric channel."""
    n_nodes = int(h.node_valid.sum())
    pods_full = h.node_num_tasks >= h.node_max_tasks
    cf = h.class_fit[klass][:, h.node_klass]                          # [k, N]
    ports_conflict = (
        np.bitwise_and(ports[:, None, :], h.node_ports[None, :, :]) != 0
    ).any(axis=-1)                                                    # [k, N]
    insufficient = req[:, None, :] >= h.node_idle[None, :, :] + DEVICE_EPSILON

    seen = np.broadcast_to(~h.node_valid, cf.shape).copy()
    counts = {}
    for mask, label in (
        (np.broadcast_to(h.node_unsched, cf.shape), "node(s) were unschedulable"),
        (~cf, "node(s) didn't match node selector/affinity/taints"),
        (np.broadcast_to(pods_full, cf.shape), "too many pods"),
        (ports_conflict, "node(s) had conflicting host ports"),
    ):
        hit = mask & ~seen
        counts[label] = hit.sum(axis=1)
        seen = seen | hit
    res_fail = (insufficient & ~seen[:, :, None]).sum(axis=1)         # [k, R]
    fits = (~seen & ~insufficient.any(axis=-1)).sum(axis=1)

    hists: List[Dict[str, int]] = []
    for i in range(req.shape[0]):
        reasons = {label: int(c[i]) for label, c in counts.items() if int(c[i])}
        for r in range(req.shape[1]):
            if int(res_fail[i, r]):
                reasons[f"Insufficient {RESOURCE_NAMES[r]}"] = int(res_fail[i, r])
        hists.append(reasons)
    return hists, fits, n_nodes


def dominant_reason(reasons: Dict[str, int]) -> str:
    """The ONE reason attributed to a pod for the ``pending_reason_total``
    metric: the reason blocking the most nodes (ties break
    lexicographically, so attribution is deterministic)."""
    if not reasons:
        return "unknown"
    return min(reasons.items(), key=lambda kv: (-kv[1], kv[0]))[0]


def _format_fit_message(reasons: Dict[str, int], fit: int, n_nodes: int) -> str:
    """ONE formatter for the FitError condition text — the per-job
    channel, the per-pod channel, and the with-reasons variant all
    format through here so the wording cannot diverge between paths."""
    parts = [f"{cnt} {reason}" for reason, cnt in sorted(reasons.items())]
    tail = f": {', '.join(parts)}." if parts else "."
    return f"{int(fit)}/{n_nodes} nodes are available{tail}"


def _fit_messages(
    req: np.ndarray,    # f32[k, R] per-row resreq
    klass: np.ndarray,  # i32[k]
    ports: np.ndarray,  # i32[k, W]
    h: HostView,
) -> List[str]:
    """FitError histogram messages for ``k`` (resreq, class, ports) rows at
    once — the single implementation behind both the per-job and the
    per-pod channels (formatting over :func:`_fit_histograms`)."""
    hists, fits, n_nodes = _fit_histograms(req, klass, ports, h)
    return [
        _format_fit_message(reasons, fits[i], n_nodes)
        for i, reasons in enumerate(hists)
    ]


def explain_pending_tasks_with_reasons(
    snap: Snapshot, decisions, group_chunk: int = 256
) -> Tuple[Dict[str, str], Dict[str, int]]:
    """Per-POD "why unschedulable" messages for EVERY unplaced pending or
    session-Allocated task of every gang-unready job — the parity channel
    for ``taskUnschedulable`` (cache.go:456-474) and the per-pod event
    messages (:637-662); the reference's status loop covers both Allocated
    and Pending tasks (cache.go:654-661) — plus the aggregate ``reason ->
    pod count`` histogram: each unplaced pod is attributed its group's
    :func:`dominant_reason`.

    Pods of the same scheduling group (job, resreq, class, ports) see the
    same cluster, so the histogram is computed once per GROUP (chunked
    [group_chunk, N] passes) and broadcast to member pods."""
    t = snap.tensors
    job_ready = np.asarray(decisions.job_ready)
    task_status1 = np.asarray(decisions.task_status)
    task_status0 = np.asarray(t.task_status)
    task_valid = np.asarray(t.task_valid)
    task_job = np.asarray(t.task_job)
    task_group = np.asarray(t.task_group)

    # unready_alloc IS the "allocated this cycle but gang-uncommitted"
    # half of unplaced-ness (commit_cycle exports it for exactly this
    # channel: valid & was-PENDING & now-ALLOCATED & ~job_ready); the
    # still-PENDING half is the only part derived locally
    unplaced = (
        task_valid
        & (task_status0 == int(TaskStatus.PENDING))
        & (task_status1 == int(TaskStatus.PENDING))
        & ~job_ready[task_job]
    ) | np.asarray(decisions.unready_alloc)
    if not unplaced.any():
        return {}, {}

    group_ids = np.unique(task_group[unplaced & (task_group >= 0)])
    g_res = np.asarray(t.group_resreq)
    g_klass = np.asarray(t.group_klass)
    g_ports = np.asarray(t.group_ports)
    h = HostView.build(snap, decisions)
    group_msg: Dict[int, str] = {}
    group_reason: Dict[int, str] = {}
    for lo in range(0, len(group_ids), group_chunk):
        gs = group_ids[lo : lo + group_chunk]
        hists, fits, n_nodes = _fit_histograms(
            g_res[gs], g_klass[gs], g_ports[gs], h
        )
        for g, reasons, fit in zip(gs, hists, fits):
            group_msg[int(g)] = _format_fit_message(reasons, fit, n_nodes)
            # a group with fitting nodes but unplaced pods is gang-blocked,
            # not node-blocked — attribute that, not a phantom node reason
            group_reason[int(g)] = (
                dominant_reason(reasons) if int(fit) == 0 else "gang not ready"
            )

    # Per-pod write-back residue, batched (the audit-record
    # assembly idiom): one np.nonzero + one searchsorted + one
    # ``.tolist()`` per column, and the reason histogram is a bincount
    # over per-group member counts — no per-pod numpy scalar indexing,
    # no per-pod dict lookups on numpy objects.
    rows = np.nonzero(unplaced & (task_group >= 0))[0]
    gs = task_group[rows]
    pos = np.searchsorted(group_ids, gs)  # group_ids is sorted-unique
    tasks = snap.index.tasks
    gid_l = group_ids.tolist()
    msg_of = [group_msg[g] for g in gid_l]
    reason_of = [group_reason[g] for g in gid_l]
    pos_l = pos.tolist()
    out = {
        tasks[i].uid: msg_of[p] for i, p in zip(rows.tolist(), pos_l)
    }
    counts = np.bincount(pos, minlength=len(group_ids)).tolist()
    reason_counts: Dict[str, int] = {}
    for r, c in zip(reason_of, counts):
        if c:
            reason_counts[r] = reason_counts.get(r, 0) + c
    return out, reason_counts
