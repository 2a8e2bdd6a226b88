"""The pipelined cycle executor: overlap stages instead of sequencing them
(the port of kube_arbitrator_tpu/pipeline/executor.py).

A sequential cycle pays sum(stages): snapshot + upload + kernel + decode
+ close + actuate, every cycle.  This executor runs the stages as a
two-deep pipeline over the arena:

* **freeze** (ingest thread): pump resync/GC, drain pending deltas into
  the arena's next pack (``SnapshotArena.snapshot()`` ships fresh copies —
  the frozen buffer), open a new speculation window
  (``DeltaJournal.reset``).  No device work: the port's session hands
  the decider the host pack, and the upload is the decider's.
* **decide** (worker thread): the decider's upload (K18 on a delta
  epoch) and cycle, the decode and the close-side census run against the
  frozen epoch, while the ingest thread keeps working.  Every launch of
  the step comes from this thread: the worker pins itself as the
  process's launching thread (ops/kernels/build.pin_launch_thread), so a
  launch from the ingest thread raises instead of racing the plans'
  shared outputs and K16's count words.
* **ingest** (ingest thread, while decide is in flight): pump the watch
  plane; deltas land in the arena's dirty sets (for the NEXT pack) and in
  the journal (for THIS commit's gate).  Bounded by
  ``max_ingest_per_wait`` — when ingest outruns decide the executor
  stops pumping and blocks (``pipeline_backpressure_total``).
* **commit** (ingest thread): the revalidate-or-discard gate
  (:mod:`.revalidate`) checks every decision against mid-flight deltas,
  then the leader fence, then actuation — after which the NEXT epoch
  freezes and submits, so its decide overlaps this epoch's write-back.

Effective cadence (commit-to-commit) tends to max(decide, host work)
instead of their sum only as far as the two threads run at once.  The
reference relies on XLA releasing the GIL during its decide; the port's
decide is Python that enqueues launches and holds the GIL except inside
its ctypes launches and its blocking host reads (ops/steps.py), so the
two threads contend for the interpreter.  ``pipeline_stage_busy_seconds
{stage}`` / ``pipeline_stage_occupancy{stage}`` show where the balance
sits.

``deterministic=True`` pins ingest to exactly one pump per decide
window, placed BEFORE the decide is submitted — the event stream becomes
a pure function of the inputs instead of host scheduling jitter — and
does not pre-submit the next epoch (no wall-clock overlap: replay mode).

Thread discipline: the ingest/commit thread is the ONLY mutator of the
cluster model, the arena and the journal; the worker only runs the
decider on the frozen pack (fresh copies) and decodes against immutable
uid/name fields.  The sole cross-thread edge is the one-deep Future.

Not ported: the reference's capture, audit and trace-recorder tees (their
planes are not ported).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from ..framework.scheduler import CycleStats, Scheduler
from ..framework.session import CycleResult, Session
from ..ops.kernels import build
from ..utils.metrics import metrics
from ..utils.tracing import tracer
from .journal import DeltaJournal
from .revalidate import Discard, revalidate_batch, revalidate_decisions

PIPELINE_STAGES = ("ingest", "freeze", "decide", "revalidate", "actuate", "close")


@dataclasses.dataclass
class _Epoch:
    """One frozen cycle in flight."""

    seq: int
    corr: Optional[str]
    session: Session
    snap: object
    pending: int
    ts: float                     # wall-clock at freeze (flight recorder)
    snapshot_ms: float
    upload_ms: float
    future: Optional[Future] = None


@dataclasses.dataclass
class StepOutcome:
    """What one committed epoch did (the pipelined run loop's view)."""

    seq: int
    binds: List
    evicts: List
    discards: List[Discard]
    period_ms: float              # commit-to-commit effective cadence
    stats: CycleStats


class PipelinedExecutor:
    """Drives a :class:`framework.Scheduler`'s world as a pipeline; one
    :meth:`step` = one committed epoch (with the next one left in
    flight).  Requires an arena (builds one over the backend if the
    scheduler has none) — the double buffer IS the overlap mechanism."""

    def __init__(
        self,
        sched: Scheduler,
        deterministic: bool = False,
        max_ingest_per_wait: int = 64,
        wait_poll_s: float = 0.002,
        ingest_fn: Optional[Callable[[], int]] = None,
    ):
        if sched.arena is None:
            from ..cache.arena import SnapshotArena

            sched.arena = SnapshotArena(sched.sim)
        self.sched = sched
        self.arena = sched.arena
        self.journal = DeltaJournal()
        self.arena.journal = self.journal
        self.deterministic = deterministic
        self.max_ingest_per_wait = max_ingest_per_wait
        self.wait_poll_s = wait_poll_s
        # injectable ingest (tests drive deterministic mid-window churn
        # through it); default pumps the backend's watch plane when it
        # has one (LiveCache.sync) and is a no-op for SimCluster, whose
        # mutations arrive synchronously between steps
        self._ingest_fn = ingest_fn
        # the one decide worker; it pins itself as the launching thread
        self._worker: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kat-pipe-decide",
            initializer=self._pin_worker,
        )
        self._inflight: Optional[_Epoch] = None
        self._last_commit_t: Optional[float] = None
        self.steps = 0
        self.backpressure_events = 0
        self.discard_totals: Dict[str, int] = {}
        self.stage_totals: Dict[str, float] = {s: 0.0 for s in PIPELINE_STAGES}
        self.last_stage_ms: Dict[str, float] = {}
        self.last_period_ms = 0.0

    def _pin_worker(self) -> None:
        self._worker = threading.current_thread()
        build.pin_launch_thread(self._worker)

    # ---- stages ----

    def _ingest(self) -> int:
        if self._ingest_fn is not None:
            return int(self._ingest_fn() or 0)
        sync = getattr(self.sched.sim, "sync", None)
        if sync is None:
            return 0
        return int(sync() or 0)

    def _freeze(self) -> tuple:
        """Drain deltas into the next pack, place it, open the window."""
        sched = self.sched
        tr = tracer()
        sched._cycle_seq += 1
        seq = sched._cycle_seq
        corr = tr.corr_for_cycle(seq)  # sampling-aware (--trace-sample-rate)
        ts = time.time()
        with tr.activate(corr), tr.span("pipeline.freeze", seq=seq):
            sched._pre_cycle(census=False)
            session = Session(
                sched.sim.cluster, sched.config, decider=sched.decider,
                arena=self.arena, phase_hook=sched.phase_hook,
            )
            t0 = time.perf_counter()
            snap = session.snapshot_phase()
            t1 = time.perf_counter()
            st, pack_meta = session.upload_phase(snap)
            t2 = time.perf_counter()
            # census from the pack (vectorized), not the live objects
            pending = sched._pending_from_snapshot(snap)
        # the speculation window opens HERE: anything the sinks see from
        # now on arrived too late for this pack and gates its commit
        self.journal.reset()
        ep = _Epoch(
            seq=seq, corr=corr, session=session, snap=snap, pending=pending,
            ts=ts, snapshot_ms=(t1 - t0) * 1000, upload_ms=(t2 - t1) * 1000,
        )
        return ep, st, pack_meta

    def _submit(self, ep: _Epoch, st, pack_meta) -> None:
        ep.future = self._pool.submit(self._decide_worker, ep, st, pack_meta)
        self._inflight = ep

    def _freeze_and_submit(self) -> float:
        """Freeze + (in deterministic mode) the window's single ingest
        pump + submit; returns the freeze wall ms."""
        t0 = time.perf_counter()
        ep, st, pack_meta = self._freeze()
        freeze_ms = (time.perf_counter() - t0) * 1000
        if self.deterministic:
            # the one pump, BEFORE the worker starts: no two threads ever
            # touch the fault injector / apiserver concurrently, so the
            # event stream is a pure function of the plan
            ti = time.perf_counter()
            self._ingest()
            self.stage_totals["ingest"] += (time.perf_counter() - ti) * 1000
        self._submit(ep, st, pack_meta)
        return freeze_ms

    def _decide_worker(self, ep: _Epoch, st, pack_meta):
        # the worker's role: the device work of the epoch (the decider's
        # upload and cycle) and the pure host work on the frozen epoch —
        # nothing here mutates the model, the arena or the journal
        tr = tracer()
        with tr.activate(ep.corr):
            with tr.span("pipeline.decide", seq=ep.seq):
                t0 = time.perf_counter()
                # the port's decide_phase also returns the decider's own
                # upload ms (the upload runs here, on the worker)
                dec, kernel_ms, upload_ms, transport_ms = ep.session.decide_phase(
                    ep.snap, st, pack_meta
                )
                t1 = time.perf_counter()
                binds, evicts = ep.session.decode_phase(ep.snap, dec)
                t2 = time.perf_counter()
                # per-pod "why unschedulable" conditions are a pure
                # function of the frozen (snapshot, decisions) — derive
                # them here so the ingest thread's write-back doesn't
                # stall on the [G,N] histogram passes (spiky 100s of ms
                # on oversubscribed worlds)
                conditions = reasons = None
                if hasattr(self.sched.sim, "update_pod_condition"):
                    from ..ops.diagnostics import (
                        explain_pending_tasks_with_reasons,
                    )

                    conditions, reasons = explain_pending_tasks_with_reasons(
                        ep.snap, dec
                    )
                t3 = time.perf_counter()
                # the close-side status census (session._close) is a pure
                # function of the frozen pack + decisions — run it HERE
                # so the ingest thread's post-commit work shrinks to the
                # write-back alone
                job_status = ep.session.close_phase(ep.snap, dec)
                t4 = time.perf_counter()
        # per-action timings and the upload's mode captured HERE (same
        # thread as the decide that produced them): by the time the
        # ingest thread reads them, the next epoch's decide may be running
        decider = ep.session._decider()
        action_ms = dict(getattr(decider, "last_action_ms", None) or {})
        action_rounds = dict(getattr(decider, "last_action_rounds", None) or {})
        return dec, binds, evicts, (conditions, reasons, job_status), (action_ms, action_rounds), {
            "kernel_ms": kernel_ms,
            "upload_ms": upload_ms,
            "upload_mode": getattr(decider, "last_mode", ""),
            "upload_bytes": getattr(decider, "last_upload_bytes", 0),
            "transport_ms": transport_ms,
            "decode_ms": (t2 - t1) * 1000,
            "close_ms": (t4 - t3) * 1000,
            "decide_wall_ms": (t4 - t0) * 1000,
        }

    def _wait(self, ep: _Epoch) -> float:
        """Ingest while the decide is in flight; returns ingest wall ms.
        Backpressure: past ``max_ingest_per_wait`` pumps the executor
        stops ingesting and blocks — the watch backlog waits rather than
        the speculation window growing without bound."""
        ingest_ms = 0.0
        if self.deterministic:
            ep.future.result()
            return 0.0
        pumps = 0
        while not ep.future.done():
            if pumps >= self.max_ingest_per_wait:
                self.backpressure_events += 1
                metrics().counter_add("pipeline_backpressure_total")
                break
            ti = time.perf_counter()
            n = self._ingest()
            ingest_ms += (time.perf_counter() - ti) * 1000
            pumps += 1
            if n == 0 and not ep.future.done():
                time.sleep(self.wait_poll_s)
        ep.future.result()  # block for (or surface) the decide outcome
        return ingest_ms

    # ---- the step ----

    def step(self) -> StepOutcome:
        """Commit one epoch: wait out its decide (ingesting meanwhile),
        gate it against the journal, fence, actuate, put the next epoch
        in flight, then do the committed epoch's close-side work under
        the new decide.  Raises exactly what a sequential run_once would
        (LeaderLost, ArenaDivergence, decide errors), with the failing
        epoch discarded and the executor ready for the next step."""
        sched = self.sched
        tr = tracer()
        t_step0 = time.perf_counter()
        if self._inflight is None:
            try:
                freeze_ms = self._freeze_and_submit()
            except BaseException as err:
                # a failed freeze (e.g. ArenaDivergence from the epoch
                # check) gets the same flight-recorder evidence trail a
                # sequential snapshot failure gets
                sched._flight_failure("", time.time(), err)
                raise
        else:
            freeze_ms = 0.0
        ep = self._inflight
        try:
            ingest_ms = self._wait(ep)
            dec, binds0, evicts0, (conditions, reasons, job_status), (action_ms, action_rounds), t = (
                ep.future.result()
            )
        except BaseException as err:
            self._inflight = None
            sched._flight_failure(ep.corr or "", ep.ts, err)
            raise
        step_discards: List[Discard] = []
        try:
            with tr.activate(ep.corr):
                t0 = time.perf_counter()
                with tr.span(
                    "pipeline.revalidate", seq=ep.seq,
                    binds=len(binds0), evicts=len(evicts0),
                ):
                    # columnar decode output takes the columnar gate
                    # (same verdicts, no intent objects); object lists
                    # (replay, custom deciders) keep the object gate
                    if hasattr(binds0, "select"):
                        binds, evicts, step_discards = revalidate_batch(
                            sched.sim.cluster, binds0, evicts0, self.journal
                        )
                    else:
                        binds, evicts, step_discards = revalidate_decisions(
                            sched.sim.cluster, binds0, evicts0, self.journal
                        )
                t_reval = time.perf_counter()
                sched._commit_fence(len(binds), len(evicts))
                failed_actuations = sched._actuate(binds, evicts)
                t_act = time.perf_counter()
        except BaseException as err:
            self._inflight = None
            sched._flight_failure(ep.corr or "", ep.ts, err)
            raise
        self._inflight = None
        # discard accounting only for epochs that actually committed —
        # past the fence, so the counter and discard_totals can never
        # diverge on a fenced cycle
        step_discard_counts: Dict[str, int] = {}
        for d in step_discards:
            self.discard_totals[d.reason] = self.discard_totals.get(d.reason, 0) + 1
            step_discard_counts[d.reason] = step_discard_counts.get(d.reason, 0) + 1
            metrics().counter_add(
                "pipeline_discards_total", labels={"reason": d.reason}
            )
        freeze_err = None
        if not self.deterministic:
            # next epoch into flight BEFORE the close-side work:
            # decide(E+1) overlaps status recomputation and write-back of
            # E.  Deterministic mode does NOT pre-submit: an in-flight
            # decide spanning the close write-back (and a caller's
            # between-cycle checks) would interleave worker access with
            # main-thread apiserver writes, making event order a race —
            # each det step instead
            # freezes, pumps the window once, decides with the main
            # thread blocked, commits, closes.  Same speculation window
            # and gate; no wall-clock overlap (replay mode, not perf).
            try:
                freeze_ms += self._freeze_and_submit()
            except BaseException as err:
                # epoch E is already COMMITTED: finish its close-side
                # write-back and bookkeeping below, then surface the
                # freeze failure as the NEXT cycle's error
                freeze_err = err
        with tr.activate(ep.corr):
            t_close0 = time.perf_counter()
            # the status census already ran on the decide worker; only
            # the write-back — the part that
            # MUST mutate the model from the single-writer ingest thread
            # — remains on the commit path
            with tr.span("pipeline.close", seq=ep.seq):
                result = CycleResult(
                    session_uid=ep.session.uid,
                    snapshot=ep.snap,
                    decisions=dec,
                    binds=binds,
                    evicts=evicts,
                    job_status=job_status,
                    snapshot_ms=ep.snapshot_ms,
                    kernel_ms=t["kernel_ms"],
                    decode_ms=t["decode_ms"],
                    transport_ms=t["transport_ms"],
                    upload_ms=ep.upload_ms + t["upload_ms"],
                    action_ms=action_ms,
                    action_rounds=action_rounds,
                    failed_actuations=failed_actuations,
                )
                sched._write_back(
                    result, task_conditions=conditions, pending_reasons=reasons
                )
            t_end = time.perf_counter()
        # close_ms keeps its CycleStats meaning (the census cost, now
        # paid off-path on the worker) + the residual write-back wall
        result.close_ms = t["close_ms"] + (t_end - t_close0) * 1000
        # effective cadence: commit-to-commit, the number pipelining
        # moves (the first step reports its fill time instead)
        period_ms = (
            (t_act - self._last_commit_t) * 1000
            if self._last_commit_t is not None
            else (t_act - t_step0) * 1000
        )
        self._last_commit_t = t_act
        self.steps += 1
        stats = CycleStats(
            cycle_ms=period_ms,
            snapshot_ms=ep.snapshot_ms,
            binds=len(binds),
            evicts=len(evicts),
            pending_before=ep.pending,
            kernel_ms=t["kernel_ms"],
            decode_ms=t["decode_ms"],
            close_ms=result.close_ms,
            actuate_ms=(t_act - t_reval) * 1000,
            transport_ms=t["transport_ms"],
            upload_ms=result.upload_ms,
            upload_mode=t["upload_mode"],
            upload_bytes=t["upload_bytes"],
        )
        sched.history.append(stats)
        sched._record_metrics(stats, action_ms, action_rounds)
        sched.last_cycle_ts = time.time()
        sched._flight_success(
            ep.seq, ep.corr, ep.ts, stats, result,
            discards=step_discard_counts,
        )
        self._record_occupancy(
            period_ms,
            {
                "ingest": ingest_ms,
                "freeze": freeze_ms,
                "decide": t["decide_wall_ms"],
                "revalidate": (t_reval - t0) * 1000,
                "actuate": (t_act - t_reval) * 1000,
                # the ingest thread's share only (the census rides the
                # decide worker now and is inside the decide stage)
                "close": (t_end - t_close0) * 1000,
            },
        )
        self.last_period_ms = period_ms
        if freeze_err is not None:
            # raised only after the committed epoch's evidence trail is
            # complete (history/metrics/flight); the failed freeze's seq
            # already advanced, so the dump names the right cycle
            sched._flight_failure("", time.time(), freeze_err)
            raise freeze_err
        return StepOutcome(
            seq=ep.seq, binds=binds, evicts=evicts, discards=step_discards,
            period_ms=period_ms, stats=stats,
        )

    def _record_occupancy(self, period_ms: float, stage_ms: Dict[str, float]) -> None:
        m = metrics()
        m.observe("pipeline_cycle_period_seconds", period_ms / 1000)
        self.last_stage_ms = dict(stage_ms)
        for stage, ms in stage_ms.items():
            self.stage_totals[stage] = self.stage_totals.get(stage, 0.0) + ms
            m.observe(
                "pipeline_stage_busy_seconds", ms / 1000, labels={"stage": stage}
            )
            if period_ms > 0:
                m.gauge_set(
                    "pipeline_stage_occupancy", ms / period_ms,
                    labels={"stage": stage},
                )

    def occupancy(self) -> Dict[str, float]:
        """Cumulative stage busy-time fractions of total committed
        period."""
        total = sum(s.cycle_ms for s in self.sched.history[-self.steps:]) if self.steps else 0.0
        if total <= 0:
            return {s: 0.0 for s in self.stage_totals}
        return {s: ms / total for s, ms in self.stage_totals.items()}

    def close(self) -> None:
        """Discard the speculative in-flight epoch (never committed) and
        release the worker.  The arena survives — a later sequential run
        continues from its current pack."""
        ep, self._inflight = self._inflight, None
        if ep is not None and ep.future is not None:
            try:
                ep.future.result()
            except BaseException:
                pass  # a failed speculative decide dies with its epoch
        self._pool.shutdown(wait=True)
        if self._worker is not None and build.launch_thread() is self._worker:
            build.pin_launch_thread(None)
        if getattr(self.arena, "journal", None) is self.journal:
            self.arena.journal = None
