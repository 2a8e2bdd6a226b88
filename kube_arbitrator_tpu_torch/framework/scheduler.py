"""The scheduler loop: periodic cycles against a cluster backend (the port
of kube_arbitrator_tpu/framework/scheduler.py).

Reference ``pkg/scheduler/scheduler.go:32-93``: load conf, then
``wait.Until(runOnce, schedulePeriod)``; each runOnce opens a session, runs
the configured actions, closes the session (status write-back).  The
backend is a ``SimCluster`` (cache/sim.py) or a ``LiveCache``
(cache/live.py: list/watch from an apiserver, binds POSTed, evicts
DELETEd, PodGroup statuses PUT and pod conditions PATCHed); any object
with their surface will do.

One cycle is ``Session.run`` (snapshot or arena epoch → ``TorchDecider``
→ decode) → :meth:`Scheduler._commit_fence` (the lease check) →
:meth:`Scheduler._actuate` (columnar actuation) →
:meth:`Scheduler._write_back` (PodGroup status, pod conditions, events).
The decider is ``TorchDecider()`` (the card) unless the caller passes
one; ``TorchDecider("cpu")`` runs on the CPU.  With an ``elector``
(framework/leader.py) only the leader schedules: ``run`` acquires the
lease before the first cycle and renews it before each, and a cycle
whose lease went stale between decision and commit is discarded with
``LeaderLost`` and nothing actuated.

Not ported (the constructor has no argument for them, so passing one is
a TypeError): the flight recorder and its cycle SLO, the decision
audit, the metric time series, session capture, the trace recorder, the
profiler directory, the pipelined executor (``run_pipelined``), the
tracer spans, ``conf_path`` (the caller loads a YAML conf with
:func:`~.conf.load_conf_file`), and ``schedule_period_s``, which the
reference stores and reads nowhere: cycles run back to back.
:func:`classify_cycle_error` has no gRPC branch: the port has no RPC
transport.  :meth:`Scheduler._actuate` has no intent-list fallback: both
backends have the columnar entry points, and the session decodes into
columns.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..api.types import TaskStatus
from ..cache.arena import ArenaDivergence, SnapshotArena
from ..cache.decode import BindColumn, EvictColumn
from ..cache.fakeapi import ApiError
from ..cache.sim import SimCluster
from ..ops.diagnostics import explain_pending_tasks_with_reasons
from ..utils.metrics import metrics, record_kernel_rounds
from .conf import SchedulerConfig
from .leader import LeaderElector, LeaderLost, TransientLockError
from .session import CycleResult, PodGroupStatus, Session


def classify_cycle_error(err: BaseException) -> str:
    """``"fatal"`` | ``"retryable"`` for an exception that killed a cycle.

    Retryable errors are environmental — the next cycle runs against a
    world that may have healed (apiserver conflict or timeout, a
    lease-storage blip, a dropped connection).  Fatal errors are evidence
    the scheduler's own state or contracts broke (arena divergence, dtype
    contract violations, invariant breaches, lost leadership) — retrying
    would actuate decisions computed from corrupt state, so they
    re-raise.  Exceptions may self-classify via a boolean ``retryable``
    attribute; unknown errors default to fatal, the conservative route."""
    if isinstance(err, LeaderLost):
        return "fatal"
    retryable = getattr(err, "retryable", None)
    if retryable is not None:
        return "retryable" if retryable else "fatal"
    if isinstance(err, (ArenaDivergence, AssertionError)):
        return "fatal"
    if isinstance(err, TypeError) and "contract" in str(err):
        return "fatal"
    if isinstance(err, (ApiError, TransientLockError, TimeoutError, ConnectionError)):
        return "retryable"
    return "fatal"


@dataclasses.dataclass
class CycleStats:
    cycle_ms: float
    snapshot_ms: float
    binds: int
    evicts: int
    pending_before: int
    kernel_ms: float = 0.0
    decode_ms: float = 0.0
    close_ms: float = 0.0
    actuate_ms: float = 0.0
    transport_ms: float = 0.0
    upload_ms: float = 0.0
    # the decider's upload this cycle: "full", "delta" or "reuse", and
    # the bytes it moved to the device
    upload_mode: str = ""
    upload_bytes: int = 0


class Scheduler:
    """Owns the cluster backend + conf; runs cycles."""

    def __init__(
        self,
        sim: SimCluster,
        config: Optional[SchedulerConfig] = None,
        decider=None,
        arena=None,
        phase_hook=None,
        max_cycle_retries: int = 8,
        elector: Optional[LeaderElector] = None,
        wait_for_event=None,
    ):
        # a YAML conf file is loaded by the caller (framework.conf.load_conf_file)
        self.sim = sim
        self.config = config or SchedulerConfig.default()
        # framework/leader.py: LeaderElector (a file lease) or
        # ApiLeaderElector (a lease object in the apiserver); None
        # schedules without election
        self.elector = elector
        # one decider per scheduler, so two loops in one process never
        # share a resident pack; the card unless the caller passes one
        if decider is None:
            from .decider import TorchDecider

            decider = TorchDecider()
        self.decider = decider
        # incremental snapshot plane: True builds a SnapshotArena over the
        # backend; a pre-built arena is also accepted.  None/False keeps
        # the per-cycle full rebuild.
        if arena is True:
            arena = SnapshotArena(sim)
        self.arena = arena or None
        # called with the phase name at each cycle phase boundary
        # (snapshot/upload/kernel/decode in Session, commit here just
        # before actuation); None costs nothing
        self.phase_hook = phase_hook
        # run(): consecutive RETRYABLE cycle errors tolerated before the
        # loop escalates
        self.max_cycle_retries = max_cycle_retries
        # until_idle seam: a no-progress cycle calls this instead of
        # exiting; True = an event arrived, keep scheduling, False =
        # timed out, exit.  LiveCache.event_waiter() builds one fed by
        # watch delivery; None stops when idle.
        self.wait_for_event = wait_for_event
        self._consecutive_cycle_errors = 0
        self.job_status: Dict[str, PodGroupStatus] = {}
        # delta write-back signatures (Session.status_cache): lets quiet
        # steady-state cycles skip per-job status object construction
        self._status_cache: Dict[str, tuple] = {}
        self.history: List[CycleStats] = []
        self._last_event_msg: Dict[tuple, str] = {}

    def _pre_cycle(self, census: bool = True) -> Optional[int]:
        """Cycle-start maintenance + pending census; returns the pending
        count (None when ``census=False``).  Runs as goroutines in the
        reference: errTasks resync (cache.go:519-547) and deferred job GC
        (:476-517).  Arena cycles skip the live-object census — an
        O(tasks) walk — and derive the same numbers from the pack via
        :meth:`_pending_from_snapshot`."""
        self.sim.process_resync()
        self.sim.collect_garbage()
        if not census:
            return None
        return sum(len(j.pending_tasks()) for j in self.sim.cluster.jobs.values())

    def _pending_from_snapshot(self, snap) -> int:
        """Pending census from the freshly built pack (vectorized twin of
        the live-object walk; the pack holds the same state the cycle
        decides from)."""
        n_real = len(snap.index.tasks)
        ts = np.asarray(snap.tensors.task_status)[:n_real]
        return int((ts == int(TaskStatus.PENDING)).sum())


    def _commit_fence(self, n_binds: int, n_evicts: int) -> None:
        """Actuation fence: a decision can outlast the lease (a stalled
        cycle), during which a standby legitimately takes over — the
        run() loop's renew() happens BEFORE the cycle, so without this
        gate the ex-leader would still apply its stale binds/evicts once.
        The clock-only check can FALSE-POSITIVE on a slow-but-healthy
        cycle in the (renew_deadline, lease_duration] window (no standby
        can have usurped yet), so a stale-looking lease gets one
        storage-backed re-validation — the record still naming us + a
        successful renew means actuation is safe.  Only a failed
        re-validation discards the cycle."""
        if self.phase_hook is not None:
            self.phase_hook("commit")
        if self.elector is not None and not self.elector.lease_fresh():
            revalidate = getattr(self.elector, "revalidate", None)
            ok = bool(revalidate()) if revalidate is not None else False
            metrics().counter_add(
                "leader_fence_revalidations_total",
                labels={"outcome": "renewed" if ok else "lost"},
            )
            if not ok:
                raise LeaderLost(
                    f"lease stale after decision phase; discarding cycle "
                    f"({n_binds} binds, {n_evicts} evicts "
                    f"not actuated) — holder {self.elector.identity}"
                )

    def _actuate(self, binds: BindColumn, evicts: EvictColumn) -> set:
        """Apply the decisions; returns the uids that did NOT actuate
        (the backend diverts failures to the errTasks resync FIFO).  The
        columns ``Session.decode_phase`` gives go to the backend's
        batched ``apply_*_columnar`` entry points (SimCluster, LiveCache)
        with no intent objects."""
        failed = set(self.sim.apply_binds_columnar(binds) or ())
        failed |= set(self.sim.apply_evicts_columnar(evicts) or ())
        return failed

    def _write_back(self, result: CycleResult) -> None:
        """Close-side status/condition/event write-back (the reference's
        closeSession -> cache.UpdateJobStatus path).  A backend with
        ``update_job_status`` (a LiveCache, which PUTs it to the
        apiserver) gets every PodGroup status of the cycle; each
        unschedulable pod gets its PodScheduled=False condition, and the
        reasons are counted in ``pending_reason_total{reason}``."""
        self.job_status.update(result.job_status)  # cache.UpdateJobStatus equivalent
        # live backends PUT the PodGroup status back to the apiserver
        # (closeSession -> cache.UpdateJobStatus, session.go:130-144)
        if hasattr(self.sim, "update_job_status"):
            for uid, st in result.job_status.items():
                self.sim.update_job_status(uid, st)
        # per-pod PodScheduled=False conditions (cache.go:456-474)
        result.task_conditions, pending_reasons = explain_pending_tasks_with_reasons(
            result.snapshot, result.decisions
        )
        for uid, msg in result.task_conditions.items():
            self.sim.update_pod_condition(uid, msg)
        for reason, n in (pending_reasons or {}).items():
            metrics().counter_add("pending_reason_total", n, labels={"reason": reason})
        # user-facing Unschedulable events (cache.go:637-662 parity),
        # deduplicated like the kube EventRecorder aggregates repeats
        for uid, st in result.job_status.items():
            for cond in st.conditions:
                key = ("Unschedulable", uid, cond.reason)
                if self._last_event_msg.get(key) != cond.message:
                    self._last_event_msg[key] = cond.message
                    self.sim.record_event("Unschedulable", uid, cond.reason, cond.message)

    def run_once(self) -> CycleResult:
        t0 = time.perf_counter()
        pending = self._pre_cycle(census=self.arena is None)
        session = Session(
            self.sim.cluster, self.config, decider=self.decider,
            arena=self.arena, phase_hook=self.phase_hook,
            status_cache=self._status_cache,
        )
        result = session.run()
        if pending is None:  # arena cycle: census from the pack instead
            pending = self._pending_from_snapshot(result.snapshot)
        t1 = time.perf_counter()
        self._commit_fence(len(result.binds), len(result.evicts))
        result.failed_actuations = self._actuate(result.binds, result.evicts)
        self._write_back(result)
        t2 = time.perf_counter()
        stats = CycleStats(
            cycle_ms=(t2 - t0) * 1000,
            snapshot_ms=result.snapshot_ms,
            binds=len(result.binds),
            evicts=len(result.evicts),
            pending_before=pending,
            kernel_ms=result.kernel_ms,
            decode_ms=result.decode_ms,
            close_ms=result.close_ms,
            actuate_ms=(t2 - t1) * 1000,
            transport_ms=result.transport_ms,
            upload_ms=result.upload_ms,
            upload_mode=self.decider.last_mode,
            upload_bytes=self.decider.last_upload_bytes,
        )
        self.history.append(stats)
        self._record_metrics(stats, result.action_ms, result.action_rounds)
        return result

    def _record_metrics(self, s: CycleStats, action_ms: Dict[str, float],
                        action_rounds: Optional[Dict[str, int]] = None) -> None:
        m = metrics()
        m.observe("e2e_scheduling_duration_seconds", s.cycle_ms / 1000)
        for phase, ms in (
            ("snapshot", s.snapshot_ms),
            ("upload", s.upload_ms),
            ("kernel", s.kernel_ms),
            ("decode", s.decode_ms),
            ("close", s.close_ms),
            ("actuate", s.actuate_ms),
            ("transport", s.transport_ms),
        ):
            m.observe("cycle_phase_duration_seconds", ms / 1000, labels={"phase": phase})
        for stage, ms in action_ms.items():
            m.observe("kernel_action_duration_seconds", ms / 1000, labels={"action": stage})
        record_kernel_rounds(m, action_rounds)
        m.counter_add("cycles_total")
        m.counter_add("binds_total", s.binds)
        m.counter_add("evicts_total", s.evicts)
        m.gauge_set("pending_tasks", s.pending_before)

    def run(self, max_cycles: int = 0, until_idle: bool = True) -> int:
        """Run cycles back to back.  Stops after max_cycles (0 =
        unlimited) or when a cycle makes no progress and nothing is
        pending (with ``wait_for_event``: when it returns False).

        With an elector only the leader schedules: acquisition blocks
        like RunOrDie (server.go:102-125), the lease is renewed before
        every cycle, and a lost lease raises :class:`LeaderLost`.

        Cycle errors are classified (:func:`classify_cycle_error`):
        retryable ones (apiserver conflict, lease-storage blip, timeout)
        are swallowed — the failed cycle counts, the loop moves on — up to
        ``max_cycle_retries`` CONSECUTIVE failures; fatal ones (arena
        divergence, contract/invariant violations, lost leadership)
        re-raise."""
        if not until_idle and not max_cycles:
            raise ValueError("until_idle=False requires max_cycles > 0")
        # a fresh run gets the full retry budget
        self._consecutive_cycle_errors = 0
        if self.elector is not None and not self.elector.is_leader:
            self.elector.acquire_blocking()
        cycles = 0
        while True:
            if self.elector is not None and not self.elector.renew():
                raise LeaderLost(f"leader lease lost by {self.elector.identity}")
            try:
                result = self.run_once()
            except LeaderLost:
                raise  # leadership is gone; only a supervisor re-acquires
            except Exception as err:
                kind = classify_cycle_error(err)
                metrics().counter_add("cycle_errors_total", labels={"class": kind})
                if kind == "fatal":
                    raise
                self._consecutive_cycle_errors += 1
                if self._consecutive_cycle_errors > self.max_cycle_retries:
                    raise
                cycles += 1
                if max_cycles and cycles >= max_cycles:
                    return cycles
                continue
            self._consecutive_cycle_errors = 0
            cycles += 1
            if max_cycles and cycles >= max_cycles:
                return cycles
            if until_idle and not result.binds and not result.evicts:
                # no progress: with a wait seam (a LiveCache's
                # event_waiter) block for the next event; a timeout
                # (False) or no seam stops instead of spinning
                if self.wait_for_event is None or not self.wait_for_event():
                    return cycles
