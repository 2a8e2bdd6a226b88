"""Host-side session: one cycle = snapshot → decision kernels → status
(the port of kube_arbitrator_tpu/framework/session.py).

The reference's OpenSession/CloseSession (``framework/framework.go:26-54``)
split into: tensor snapshot (cache/snapshot.py), the fused decision program
(ops/cycle.py — plugin OnSessionOpen aggregates live inside it), and this
module's close-side bookkeeping: PodGroup status recomputation
(``session.go:159-197`` jobStatus) and Unschedulable conditions for jobs
that ended the cycle gang-unready (``gang.go:169-190`` OnSessionClose).

The decider is ``framework.TorchDecider``: on the card unless the caller
passes ``TorchDecider("cpu")``.  It takes the host pack (with the
arena's :class:`~..cache.arena.PackMeta`) and keeps it resident on its
device itself, so the session hands it the host pack in every case; the
reference's device-pack and mesh branches of ``upload_phase`` are not
ported.  The decider's own upload time is reported as ``upload_ms`` and
its cycle time as ``kernel_ms``.
"""
from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.info import ClusterInfo
from ..api.types import (
    COND_UNSCHEDULABLE,
    PodGroupPhase,
    TaskStatus,
    counts_as_ready,
    is_allocated_status,
)
from ..cache.decode import decode_batch, decode_batch_compact, decode_lists_present
from ..cache.sim import BindIntent, EvictIntent
from ..cache.snapshot import Snapshot, build_snapshot
from ..ops.cycle import CycleDecisions
from ..ops.diagnostics import HostView, _fit_messages
from .conf import SchedulerConfig

# Cap on per-cycle FitError explanations: the first N unready gangs get the
# full reason histogram; beyond that only the count message (bounds close
# cost on pathologically saturated clusters).
MAX_EXPLAINED_JOBS = 100

def _decode_parity_armed() -> bool:
    """KAT_DECODE_PARITY=1: every compact decode is cross-checked
    against the dense-mask oracle (an O(T) pass per cycle — test/chaos
    posture only).  Read per call, not at import: harnesses arm it
    AFTER this module loads (pytest monkeypatch.setenv, the chaos
    lane's env prefix) and must not be silently ignored."""
    return os.environ.get("KAT_DECODE_PARITY", "") == "1"

# The process-wide default decider: Sessions constructed without one all
# share this TorchDecider (the card), so back-to-back cycles keep one
# resident pack.  Decide calls are sequential.
_default_decider = None


def default_decider():
    global _default_decider
    if _default_decider is None:
        from .decider import TorchDecider

        _default_decider = TorchDecider()
    return _default_decider


# The decode lists (optional as a unit: absent, the dense masks decode)
DECODE_LISTS_SCHEMA: Dict[str, Tuple[type, int]] = {
    "bind_idx": (np.int32, 1),
    "bind_node": (np.int32, 1),
    "evict_idx": (np.int32, 1),
    "bind_count": (np.int32, 0),
    "evict_count": (np.int32, 0),
}
# What the actuation decode and the close census read, with the audit
# columns: field -> (dtype, rank) (the reference's analysis/contracts.py
# DECISIONS_SCHEMA)
DECISIONS_SCHEMA: Dict[str, Tuple[type, int]] = {
    "task_node": (np.int32, 1),
    "task_status": (np.int32, 1),
    "bind_mask": (np.bool_, 1),
    "evict_mask": (np.bool_, 1),
    "job_ready": (np.bool_, 1),
    "unready_alloc": (np.bool_, 1),
    "node_idle": (np.float32, 2),
    "node_num_tasks": (np.int32, 1),
    "node_ports": (np.int32, 2),
    "evict_claimant": (np.int32, 1),
    "evict_phase": (np.int32, 1),
    "evict_round": (np.int32, 1),
    "queue_deserved": (np.float32, 2),
    "queue_alloc": (np.float32, 2),
    **DECODE_LISTS_SCHEMA,
}


def _assert_decision_dtypes(dec: CycleDecisions) -> None:
    """Decisions-side twin of cache/snapshot.assert_pack_dtypes: every
    array the actuation decode and the close census read must carry the
    declared dtype and rank (:data:`DECISIONS_SCHEMA`)."""
    for name, (dtype, ndim) in DECISIONS_SCHEMA.items():
        arr = getattr(dec, name, None)
        if arr is None and name in DECODE_LISTS_SCHEMA:
            # the decode lists are optional; absent, decode_phase falls
            # back to the dense masks — present but drifted is not legal
            continue
        got = np.dtype(arr.dtype)
        if got != np.dtype(dtype) or arr.ndim != ndim:
            raise TypeError(
                f"decision contract violation: {name} arrived as "
                f"{got}[{arr.ndim}d], contract says {np.dtype(dtype)}[{ndim}d]"
            )


@dataclasses.dataclass
class PodGroupCondition:
    """v1alpha1.PodGroupCondition equivalent (types.go:41-45)."""

    type: str
    status: bool
    transition_id: str
    reason: str = ""
    message: str = ""
    last_transition: float = 0.0


@dataclasses.dataclass
class PodGroupStatus:
    """v1alpha1.PodGroupStatus equivalent."""

    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = dataclasses.field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclasses.dataclass
class CycleResult:
    session_uid: str
    snapshot: Snapshot
    decisions: CycleDecisions
    # Sequence, not List: the scheduling loop ships columnar
    # BindColumn/EvictColumn (cache/decode.py) — iteration still yields
    # intents, but columnar consumers read .uids/.node_names directly
    binds: Sequence[BindIntent]
    evicts: Sequence[EvictIntent]
    job_status: Dict[str, PodGroupStatus]
    # uid -> "why unschedulable" for EVERY unplaced pending pod of every
    # gang-unready job: the PodScheduled=False condition channel
    # (cache.go:456-474 taskUnschedulable + :637-662 event messages).
    # Computed lazily — the close path stays bounded; backends that
    # consume pod conditions trigger it (Scheduler fills it in)
    task_conditions: Dict[str, str] = dataclasses.field(default_factory=dict)
    snapshot_ms: float = 0.0
    kernel_ms: float = 0.0
    decode_ms: float = 0.0
    close_ms: float = 0.0
    # decide wall minus the decider's upload and cycle time
    transport_ms: float = 0.0
    # host->device pack placement: the decider's own upload of the pack
    # (full, delta rows through K18, or reuse)
    upload_ms: float = 0.0
    # stage -> wall ms and action -> rounds from the decider (empty
    # unless the decider fills them)
    action_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    action_rounds: Dict[str, int] = dataclasses.field(default_factory=dict)
    # task uids whose bind/evict intent did NOT actuate (diverted to the
    # errTasks resync FIFO or vanished mid-cycle) — filled by the
    # Scheduler after actuation
    failed_actuations: set = dataclasses.field(default_factory=set)


class Session:
    """One scheduling cycle over a ClusterInfo.

    ``decider`` runs the decision program: the process-wide
    ``TorchDecider()`` on the card by default; ``TorchDecider("cpu")``
    for the CPU.  ``arena`` (cache/arena.SnapshotArena) switches the
    snapshot phase from a full rebuild to incremental delta maintenance,
    and its epoch keys let the decider write only the changed rows into
    its resident pack.  ``phase_hook`` is called with the phase name after each
    completed phase (snapshot/upload/kernel/decode) — the explicit seam
    the chaos plane uses to inject mid-cycle faults (e.g. a leader-lease
    usurpation between kernel and commit) without monkeypatching; None
    costs nothing."""

    def __init__(
        self,
        cluster: ClusterInfo,
        config: Optional[SchedulerConfig] = None,
        decider=None,
        arena=None,
        phase_hook=None,
        status_cache: Optional[Dict[str, tuple]] = None,
    ):
        self.cluster = cluster
        self.config = config or SchedulerConfig.default()
        self.decider = decider
        self.arena = arena
        self.phase_hook = phase_hook
        # Delta write-back seam (the Scheduler passes its own dict, kept
        # across cycles): uid -> packed status signature of the last
        # PodGroupStatus built for the job.  On a QUIET cycle (no binds,
        # no evicts — nothing in the pack moved) jobs whose signature is
        # unchanged skip object construction entirely, so a saturated
        # steady-state cycle allocates ZERO per-job status objects.
        # None (Sessions built directly) keeps the build-everything
        # behavior.
        self.status_cache = status_cache
        self.uid = str(uuid.uuid4())
        # "compact" / "dense" / "overflowed": how decode_phase decoded
        self.last_decode_path: Optional[str] = None

    def _decider(self):
        return self.decider if self.decider is not None else default_decider()

    # ---- the cycle stages ----
    #
    # run() composes them sequentially; each stage is self-contained:
    # phase hook inside, timing by caller.

    def snapshot_phase(self) -> Snapshot:
        snap = (
            self.arena.snapshot()
            if self.arena is not None
            else build_snapshot(self.cluster)
        )
        if self.phase_hook is not None:
            self.phase_hook("snapshot")
        return snap

    def upload_phase(self, snap: Snapshot):
        """What the decider consumes: (host pack, pack_meta).  With an
        arena, pack_meta is the epoch's :class:`~..cache.arena.PackMeta`
        (its key, base key and changed fields, which the decider turns
        into a delta upload); without one,
        None (the decider uploads the pack whole)."""
        st, pack_meta = snap.tensors, None
        if self.arena is not None:
            pack_meta = self.arena.pack_meta
            if self.phase_hook is not None:
                self.phase_hook("upload")
        return st, pack_meta

    def decide_phase(self, snap: Snapshot, st, pack_meta):
        """Run the decision program; returns (decisions, kernel_ms,
        upload_ms, transport_ms).  kernel_ms is the decider's cycle time
        (``last_cycle_ms``) and upload_ms its upload time
        (``last_upload_ms``), where it reports them (else the whole call
        and 0); transport is the decide wall minus both."""
        decider = self._decider()
        t0 = time.perf_counter()
        if pack_meta is not None:
            dec, call_ms = decider.decide(st, self.config, pack_meta=pack_meta)
        else:
            dec, call_ms = decider.decide(st, self.config)
        wall_ms = (time.perf_counter() - t0) * 1000
        kernel_ms = float(getattr(decider, "last_cycle_ms", call_ms))
        upload_ms = float(getattr(decider, "last_upload_ms", 0.0))
        if self.phase_hook is not None:
            self.phase_hook("kernel")
        # hold the decisions to the declared contract before decoding
        # them into binds/evicts — a drifted dtype here corrupts
        # actuation host-side without raising
        _assert_decision_dtypes(dec)
        return dec, kernel_ms, upload_ms, max(wall_ms - kernel_ms - upload_ms, 0.0)

    def decode_phase(self, snap: Snapshot, dec: CycleDecisions):
        """Ints-out fast path first: the kernel's compact index lists
        (one bounded gather, O(decisions)); the dense [T]-mask decode
        remains the fallback for overflowed caps or absent lists, and the
        parity ORACLE the fast path is held to (``KAT_DECODE_PARITY=1``
        cross-checks every cycle).

        Both paths return COLUMNS (cache/decode.BindColumn/EvictColumn):
        no intent objects are built here — batched actuation consumes the
        ordinals.  ``last_decode_path`` records which path decoded:
        "compact", "dense" (no lists) or "overflowed" (the lists were
        present but a count passed its cap)."""
        batch = decode_batch_compact(snap, dec)
        if batch is not None:
            binds, evicts = batch.binds, batch.evicts
            self.last_decode_path = "compact"
            if _decode_parity_armed():
                ref = decode_batch(snap, dec)
                if not (
                    np.array_equal(binds.rows, ref.binds.rows)
                    and np.array_equal(binds.node_ords, ref.binds.node_ords)
                    and np.array_equal(evicts.rows, ref.evicts.rows)
                ):
                    raise AssertionError(
                        "decode contract violation: compact ints-out "
                        "columns diverged from the dense-mask oracle "
                        f"({len(binds)}/{len(ref.binds)} binds, "
                        f"{len(evicts)}/{len(ref.evicts)} evicts)"
                    )
        else:
            # lists fully present but a count exceeded its cap: the
            # bounded-list contract overflowed this cycle (a PARTIAL set
            # is absence, not overflow)
            self.last_decode_path = "overflowed" if decode_lists_present(dec) else "dense"
            ref = decode_batch(snap, dec)
            binds, evicts = ref.binds, ref.evicts
        if self.phase_hook is not None:
            self.phase_hook("decode")
        return binds, evicts

    def close_phase(self, snap: Snapshot, dec: CycleDecisions) -> Dict[str, PodGroupStatus]:
        return self._close(snap, dec)

    def run(self) -> CycleResult:
        t0 = time.perf_counter()
        snap = self.snapshot_phase()
        t1 = time.perf_counter()
        st, pack_meta = self.upload_phase(snap)
        t_up = time.perf_counter()
        dec, kernel_ms, upload_ms, transport_ms = self.decide_phase(snap, st, pack_meta)
        t2 = time.perf_counter()
        binds, evicts = self.decode_phase(snap, dec)
        t3 = time.perf_counter()
        job_status = self.close_phase(snap, dec)
        t4 = time.perf_counter()
        return CycleResult(
            session_uid=self.uid,
            snapshot=snap,
            decisions=dec,
            binds=binds,
            evicts=evicts,
            job_status=job_status,
            snapshot_ms=(t1 - t0) * 1000,
            kernel_ms=kernel_ms,
            decode_ms=(t3 - t2) * 1000,
            close_ms=(t4 - t3) * 1000,
            transport_ms=transport_ms,
            upload_ms=(t_up - t1) * 1000 + upload_ms,
            action_ms=dict(
                getattr(self._decider(), "last_action_ms", None) or {}
            ),
            action_rounds=dict(
                getattr(self._decider(), "last_action_rounds", None) or {}
            ),
        )

    # ---- CloseSession ----

    def _close(self, snap: Snapshot, dec: CycleDecisions) -> Dict[str, PodGroupStatus]:
        """Close-side status census — a pure function of the PACK
        (snapshot tensors + decisions) plus the index's immutable
        identities (job uid/ordinal).  It deliberately never reads live
        task objects (``job.tasks`` / ``job.ready_task_num()``)."""
        job_ready = np.asarray(dec.job_ready)
        task_status = np.asarray(dec.task_status)
        statuses: Dict[str, PodGroupStatus] = {}
        now = time.time()
        host = None
        explained = 0
        # Per-job SESSION-status counts, vectorized: one bincount per
        # status class over the real task rows replaces the per-task
        # python loop (50k TaskStatus() constructions ≈ 100 ms/cycle at
        # the 50k rung; this is ~1 ms).  Row o's job IS task_job[o], so
        # the grouped counts equal the per-job ordinal-walk exactly.
        n_real = len(snap.index.tasks)
        n_jobs = len(snap.index.jobs)
        ts = task_status[:n_real]
        ts0 = np.asarray(snap.tensors.task_status)[:n_real]
        tj = np.asarray(snap.tensors.task_job)[:n_real]
        job_min_avail = np.asarray(snap.tensors.job_min_available)

        def _cnt(mask: np.ndarray) -> np.ndarray:
            return np.bincount(tj[mask], minlength=n_jobs)

        zeros = np.zeros(n_jobs, dtype=np.int64)
        if n_real:
            n_running = _cnt(ts == int(TaskStatus.RUNNING))
            n_succeeded = _cnt(ts == int(TaskStatus.SUCCEEDED))
            n_failed = _cnt(ts == int(TaskStatus.FAILED))
            alloc_vals = np.array(
                [int(s) for s in TaskStatus if is_allocated_status(s)]
            )
            n_allocated = _cnt(np.isin(ts, alloc_vals))
            # gang message inputs from SNAPSHOT statuses (what the live
            # walk's job.ready_task_num()/len(job.tasks) read, frozen)
            ready_vals = np.array(
                [int(s) for s in TaskStatus if counts_as_ready(s)]
            )
            n_ready0 = _cnt(np.isin(ts0, ready_vals))
            n_tasks = np.bincount(tj, minlength=n_jobs)
        else:
            n_running = n_succeeded = n_failed = n_allocated = zeros
            n_ready0 = n_tasks = zeros
        # Batched ``.tolist()`` gathers (the audit-record assembly
        # idiom): one host conversion per COLUMN, so the per-job loop
        # below reads plain Python ints instead of minting a numpy
        # scalar object per (job, column) cell.
        ready_l = job_ready.tolist()
        min_l = job_min_avail.tolist()
        run_l = n_running.tolist()
        alloc_l = n_allocated.tolist()
        succ_l = n_succeeded.tolist()
        fail_l = n_failed.tolist()
        ready0_l = n_ready0.tolist()
        ntasks_l = n_tasks.tolist()
        cache = self.status_cache
        # The node-side state the explain messages read, digested: one
        # blake2b over the consulted node arrays (~O(N·R) hash,
        # microseconds at the 50k rung), computed EVERY cycle.  A match
        # means nothing the reason histograms consult moved — no binds,
        # no evicts on any node, and no externally-driven change (a
        # cordon, a drain, capacity drift via the watch) — so an unready
        # gang whose count signature is also unchanged can skip even on
        # cycles that bound or evicted elsewhere (any edge that lands on
        # a node perturbs node_idle/num_tasks and misses the digest).
        nodes_unchanged = False
        if cache is not None:
            import hashlib

            hd = hashlib.blake2b(digest_size=16)
            t = snap.tensors
            for arr in (
                dec.node_idle, dec.node_num_tasks, dec.node_ports,
                t.node_unsched, t.node_valid, t.node_max_tasks,
                t.node_klass, t.class_fit,
            ):
                hd.update(np.asarray(arr).tobytes())
            node_sig = hd.hexdigest()
            nodes_unchanged = cache.get("__node_sig__") == node_sig
            cache["__node_sig__"] = node_sig
        to_emit: List[list] = []    # [job, o, sig, min_avail, msg]
        explain_at: List[Tuple[int, int]] = []  # (to_emit idx, ordinal)
        for job in snap.index.jobs:
            o = job.ordinal
            sig = (
                ready_l[o], min_l[o], run_l[o], alloc_l[o], succ_l[o],
                fail_l[o], ready0_l[o], ntasks_l[o],
            )
            if cache is not None and cache.get(job.uid) == sig and (
                nodes_unchanged or ready_l[o] or not min_l[o]
            ):
                # Unchanged: zero objects constructed.  A ready gang's
                # status (and a min_available==0 job's) is a pure
                # function of the signature, so it skips on ACTIVE
                # cycles too; an unready gang's Unschedulable message
                # embeds the per-node reason histogram, so it
                # additionally needs the node digest to match.
                continue
            msg = None
            min_avail = min_l[o]
            if not ready_l[o] and min_avail > 0:
                # gang.go:169-190: stamp Unschedulable for unready gangs,
                # with the FitError-style per-node reason histogram
                # (job_info.go:329-358) appended
                missing = min_avail - ready0_l[o]
                msg = f"{missing}/{ntasks_l[o]} tasks in gang unschedulable"
                if explained < MAX_EXPLAINED_JOBS:
                    explained += 1
                    explain_at.append((len(to_emit), o))
            to_emit.append([job, o, sig, min_avail, msg])
        if explain_at:
            # The explain pass, vectorized: ONE host pass finds every
            # explained gang's first unplaced pending row and ONE
            # _fit_messages call builds all their histograms — replacing
            # a per-job explain chain (an O(T) scan plus a k=1
            # histogram pass EACH) on active cycles.
            if host is None:
                host = HostView.build(snap, dec)
            unplaced = (
                host.task_valid
                & (host.task_status0 == int(TaskStatus.PENDING))
                & (host.task_status1 == int(TaskStatus.PENDING))
            )
            rows = np.nonzero(unplaced)[0]
            first_row = np.full(n_jobs, -1, np.int64)
            if len(rows):
                # rows ascend; reversed assignment leaves each job's
                # FIRST unplaced row
                first_row[host.task_job[rows[::-1]]] = rows[::-1]
            ks = [
                (i, int(first_row[o])) for i, o in explain_at
                if 0 <= o < n_jobs and first_row[o] >= 0
            ]
            if ks:
                ridx = np.asarray([r for _, r in ks], np.int64)
                whys = _fit_messages(
                    host.task_resreq[ridx],
                    host.task_klass[ridx],
                    host.task_ports[ridx],
                    host,
                )
                for (i, _), why in zip(ks, whys):
                    if why:
                        to_emit[i][4] = f"{to_emit[i][4]}: {why}"
        for job, o, sig, min_avail, msg in to_emit:
            unsched_cond = None
            if msg is not None:
                unsched_cond = PodGroupCondition(
                    type=COND_UNSCHEDULABLE,
                    status=True,
                    transition_id=self.uid,
                    reason="NotEnoughResources",
                    message=msg,
                    last_transition=now,
                )
            statuses[job.uid] = self._job_status(
                unsched_cond,
                running=run_l[o],
                allocated=alloc_l[o],
                succeeded=succ_l[o],
                failed=fail_l[o],
                min_available=min_avail,
            )
            if cache is not None:
                cache[job.uid] = sig
        return statuses

    def _job_status(
        self,
        unsched: Optional[PodGroupCondition],
        running: int,
        allocated: int,
        succeeded: int,
        failed: int,
        min_available: int,
    ) -> PodGroupStatus:
        """session.go:159-197 jobStatus semantics (incl. the strict '>'
        on minMember).  Counts come from the SESSION-side statuses
        (``dec.task_status``): the reference's jobStatus reads the
        session's TaskStatusIndex, which includes this cycle's Allocated/
        Pipelined transitions (ssn.Allocate's UpdateTaskStatus) — not the
        pre-actuation cache state.  ``_close`` computes them vectorized,
        ``min_available`` included (the pack's row, not the live
        object's, so the whole census is worker-thread-safe)."""
        st = PodGroupStatus()
        if unsched is not None:
            st.conditions.append(unsched)
        if running != 0 and unsched is not None:
            st.phase = PodGroupPhase.UNKNOWN
        else:
            st.phase = (
                PodGroupPhase.RUNNING
                if allocated > min_available
                else PodGroupPhase.PENDING
            )
        st.running = running
        st.succeeded = succeeded
        st.failed = failed
        return st
