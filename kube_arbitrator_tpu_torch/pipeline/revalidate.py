"""The commit gate: revalidate-or-discard for speculative decisions (the
port's copy of kube_arbitrator_tpu/pipeline/revalidate.py).

Decisions the pipelined executor commits were computed from a frozen
epoch while the cluster moved on.  Before actuation, every bind/evict
whose task or node the :class:`.journal.DeltaJournal` marked dirty is
re-checked against the LIVE model — the same pattern as the actuation
fence (a stale-looking lease gets one storage-backed re-validation; only
a failed one discards), applied per decision instead of per cycle.
Decisions that conflict with mid-flight reality are dropped and counted
in ``pipeline_discards_total{reason=...}``; everything else actuates
exactly as a sequential cycle would have.

Discard reasons:

==================  =====================================================
``task_gone``        the bind/evict target left the model (pod deleted,
                     job GC'd, relist dropped it).
``already_bound``    the bind target is no longer Pending-off-node —
                     another actor (or an earlier retried request)
                     placed it; k8s bindings are immutable, so a second
                     bind would 409 or, worse, double-count.
``node_gone``        the target node left the model.
``node_unsched``     the target node was cordoned mid-flight.
``capacity_shrunk``  the target node can no longer hold the task:
                     current idle+releasing (minus binds this commit
                     already accepted onto it) does not fit its resreq,
                     or the pod-count cap is exhausted.
``not_evictable``    the evict victim is no longer in an evictable
                     state (already Releasing/terminal).
``claim_conflict``   NOT emitted by this gate: the optimistic reclaim
                     engine's in-round commit gate (K15,
                     ops/preempt._reclaim_canon_optimistic) discards a
                     speculative cross-queue claim whose inputs an
                     earlier accepted claim invalidated; the count rides
                     the same ``pipeline_discards_total{reason=...}``
                     family so both speculation gates share one
                     vocabulary and one dashboard query.
==================  =====================================================

The journal bounds the work: untouched tasks/nodes committed against
state identical to the frozen pack and pass without a lookup, so the
quiescent-stream gate is O(decisions) set probes and the pipelined
decision stream is bit-identical to sequential.  Any structural event
flips to conservative full revalidation of every decision.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import resource as res
from ..api.types import TaskStatus

DISCARD_REASONS = (
    "task_gone",
    "already_bound",
    "node_gone",
    "node_unsched",
    "capacity_shrunk",
    "not_evictable",
    # optimistic-reclaim speculation discarded in-kernel (see table)
    "claim_conflict",
)

# states an eviction still makes sense against: the victim occupies (or
# is about to occupy) capacity some claimant was promised
_EVICTABLE = (
    TaskStatus.RUNNING,
    TaskStatus.BOUND,
    TaskStatus.BINDING,
    TaskStatus.ALLOCATED,
    TaskStatus.PIPELINED,
)


@dataclasses.dataclass(frozen=True)
class Discard:
    """One dropped decision, for the repro trail and metrics."""

    kind: str      # "bind" | "evict"
    task_uid: str
    reason: str
    detail: str = ""


# implicated-intent count past which one full model pass beats per-uid
# job scans (task_by_uid is O(jobs) per call; the full index is O(tasks))
_INDEX_THRESHOLD = 64


class _TaskLookup:
    """Task lookup sized to the work: a handful of implicated intents
    resolve via per-uid scans; past the threshold one full model pass
    builds the dict.  Keeps the common journal-gated commit (a few dirty
    rows) at O(implicated), not O(cluster)."""

    def __init__(self, cluster, expected: int):
        self._cluster = cluster
        self._index: Optional[Dict[str, object]] = (
            {
                uid: t
                for job in cluster.jobs.values()
                for uid, t in job.tasks.items()
            }
            if expected > _INDEX_THRESHOLD
            else None
        )

    def get(self, uid: str):
        if self._index is not None:
            return self._index.get(uid)
        return self._cluster.task_by_uid(uid)


def _check_bind(
    uid: str,
    node_name: str,
    t_checked: bool,
    n_checked: bool,
    index: "_TaskLookup",
    cluster,
    tentative_res: Dict[str, np.ndarray],
    tentative_cnt: Dict[str, int],
) -> Tuple[Optional[str], str]:
    """One bind's revalidation checks + tentative accounting — the ONE
    rule body both the object gate and the columnar gate run, so their
    keep/discard verdicts (and discard details) cannot diverge.  Returns
    (reason, detail); a None reason means KEPT, and the node's tentative
    ledger was charged (when the task resolved and the node was
    implicated)."""
    reason = detail = None
    task = index.get(uid)
    if t_checked:
        if task is None:
            reason = "task_gone"
        elif task.status != TaskStatus.PENDING or task.node_name:
            reason = "already_bound"
            detail = f"status={task.status.name} node={task.node_name or '-'}"
    if reason is None and n_checked:
        node = cluster.nodes.get(node_name)
        if node is None:
            reason = "node_gone"
        elif node.unschedulable:
            reason = "node_unsched"
        elif task is not None:
            # current headroom: idle + releasing (eviction-backed
            # placements are legitimate — the victim's resources are
            # committed to a claimant) minus what this commit already
            # accepted onto the node
            avail = node.idle + node.releasing
            used_here = tentative_res.get(node_name)
            if used_here is not None:
                avail = avail - used_here
            n_here = len(node.tasks) + tentative_cnt.get(node_name, 0)
            if not res.less_equal(np.asarray(task.resreq), avail):
                reason = "capacity_shrunk"
                detail = f"resreq {np.asarray(task.resreq).tolist()} > avail {avail.tolist()}"
            elif n_here >= node.max_tasks:
                reason = "capacity_shrunk"
                detail = f"pod count {n_here} >= max_tasks {node.max_tasks}"
    if reason is None:
        # binds this commit already accepted per node, so two stale binds
        # cannot pass one shrunken node's capacity check independently
        if task is not None and n_checked:
            prev = tentative_res.get(node_name)
            r = np.asarray(task.resreq)
            tentative_res[node_name] = r if prev is None else prev + r
            tentative_cnt[node_name] = tentative_cnt.get(node_name, 0) + 1
        return None, ""
    return reason, detail or ""


def _check_evict(uid: str, index: "_TaskLookup") -> Tuple[Optional[str], str]:
    """One evict's revalidation checks (shared by both gates)."""
    task = index.get(uid)
    if task is None:
        return "task_gone", ""
    if task.status not in _EVICTABLE:
        return "not_evictable", f"status={task.status.name}"
    return None, ""


def revalidate_decisions(
    cluster,
    binds: Sequence,
    evicts: Sequence,
    journal,
) -> Tuple[List, List, List[Discard]]:
    """Gate ``binds``/``evicts`` (decoded intents) against the live
    ``cluster`` model, checking only decisions the ``journal`` implicates
    (all of them after a structural event).  Returns (kept binds, kept
    evicts, discards)."""
    if journal is None or journal.empty:
        return list(binds), list(evicts), []
    check_all = bool(journal.structural)
    dirty_tasks = journal.dirty_tasks
    dirty_nodes = journal.dirty_nodes
    expected = (
        len(binds) + len(evicts)
        if check_all
        else sum(
            1 for b in binds
            if b.task_uid in dirty_tasks or b.node_name in dirty_nodes
        ) + sum(1 for e in evicts if e.task_uid in dirty_tasks)
    )
    index = _TaskLookup(cluster, expected)
    discards: List[Discard] = []
    kept_binds: List = []
    tentative_res: Dict[str, np.ndarray] = {}
    tentative_cnt: Dict[str, int] = {}
    for b in binds:
        t_checked = check_all or b.task_uid in dirty_tasks
        n_checked = check_all or b.node_name in dirty_nodes
        if not t_checked and not n_checked:
            kept_binds.append(b)  # untouched by the window: passes as-is
            continue
        reason, detail = _check_bind(
            b.task_uid, b.node_name, t_checked, n_checked,
            index, cluster, tentative_res, tentative_cnt,
        )
        if reason is None:
            kept_binds.append(b)
        else:
            discards.append(
                Discard(kind="bind", task_uid=b.task_uid, reason=reason,
                        detail=detail)
            )
    kept_evicts: List = []
    for e in evicts:
        if not (check_all or e.task_uid in dirty_tasks):
            kept_evicts.append(e)
            continue
        reason, detail = _check_evict(e.task_uid, index)
        if reason is None:
            kept_evicts.append(e)
        else:
            discards.append(
                Discard(kind="evict", task_uid=e.task_uid, reason=reason,
                        detail=detail)
            )
    return kept_binds, kept_evicts, discards


def revalidate_batch(
    cluster,
    binds,
    evicts,
    journal,
) -> Tuple[object, object, List[Discard]]:
    """The columnar gate: same verdicts as :func:`revalidate_decisions`
    (both run :func:`_check_bind`/:func:`_check_evict`), consuming and
    returning :class:`..cache.decode.BindColumn` / ``EvictColumn``
    instead of intent lists — no per-decision objects are built for the
    decisions that survive.

    Implication is resolved as batched membership probes over the
    columns' cached uid/node identity vectors (strings the apiserver
    wire needs anyway); only implicated rows pay a model lookup.  A
    quiescent window returns the input columns untouched (identity, not
    copies)."""
    if journal is None or journal.empty:
        return binds, evicts, []
    check_all = bool(journal.structural)
    dirty_tasks = journal.dirty_tasks
    dirty_nodes = journal.dirty_nodes
    nb, ne = len(binds), len(evicts)
    b_uids, b_nodes = binds.uids, binds.node_names
    e_uids = evicts.uids
    if check_all:
        bt = bn = [True] * nb
        et = [True] * ne
    else:
        # batched gathers against the journal's implicated sets
        bt = [u in dirty_tasks for u in b_uids]
        bn = [n in dirty_nodes for n in b_nodes]
        et = [u in dirty_tasks for u in e_uids]
    expected = sum(t or n for t, n in zip(bt, bn)) + sum(et)
    if expected == 0:
        return binds, evicts, []
    index = _TaskLookup(cluster, expected)
    discards: List[Discard] = []
    tentative_res: Dict[str, np.ndarray] = {}
    tentative_cnt: Dict[str, int] = {}
    keep_b: List[int] = []
    for k in range(nb):
        t_checked, n_checked = bt[k], bn[k]
        if not t_checked and not n_checked:
            keep_b.append(k)
            continue
        reason, detail = _check_bind(
            b_uids[k], b_nodes[k], t_checked, n_checked,
            index, cluster, tentative_res, tentative_cnt,
        )
        if reason is None:
            keep_b.append(k)
        else:
            discards.append(
                Discard(kind="bind", task_uid=b_uids[k], reason=reason,
                        detail=detail)
            )
    keep_e: List[int] = []
    for k in range(ne):
        if not et[k]:
            keep_e.append(k)
            continue
        reason, detail = _check_evict(e_uids[k], index)
        if reason is None:
            keep_e.append(k)
        else:
            discards.append(
                Discard(kind="evict", task_uid=e_uids[k], reason=reason,
                        detail=detail)
            )
    out_b = binds if len(keep_b) == nb else binds.select(keep_b)
    out_e = evicts if len(keep_e) == ne else evicts.select(keep_e)
    return out_b, out_e, discards
