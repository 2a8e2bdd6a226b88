"""Kernel cost attribution: measured stage times, the kernels' build
telemetry and per-shape device-time estimates (the port of
kube_arbitrator_tpu/utils/profiling.py).

The question the ``/debug/kernels`` table answers is the reference's: is
this stage launch-bound or device-bound at this shape?  Three parts:

* **Measured stage times.**  The staged cycle runner
  (ops/cycle.schedule_cycle_staged) records every stage's wall time,
  rounds and gated rounds per (pack shape, stage), as the reference's
  does.

* **Build telemetry instead of retrace accounting.**  The reference
  counts XLA recompiles through a ``jax.monitoring`` listener
  (``xla_retraces_total{fn}``, ``xla_compile_seconds``).  The port
  compiles no program at run time, so nothing retraces; what it does
  compile is each CUDA source, once, at its first use
  (ops/kernels/build.py).  With the profiler on, every such build is
  counted as ``kernel_builds_total{fn=<stage active then>}`` with its
  seconds in ``kernel_build_seconds``.  The reference's bench-side
  ``RetraceCounter`` has no counterpart.

* **Device-time estimates instead of HLO cost analysis.**  The reference
  lowers each action once per shape and serves XLA's estimated flops and
  bytes (``jax.stages.Lowered.cost_analysis()``).  There is no such
  model for hand-written kernels; the port's estimate for a (shape,
  stage) is taken once, from a ``torch.profiler`` pass over that stage's
  first staged run at the shape: the device time of the kernels (and
  copies) it ran, ``device_ms``, and their count, ``launches``.  The
  table serves them with ``device_share`` = device ms over the measured
  mean: a stage whose share is small spends its time on the host
  (launches, reads), not on the card.  On the CPU no device kernel runs:
  the estimate is ``device_ms`` 0 and ``launches`` 0 with no pass.
  torch.profiler loses records at the ends of a session: the first ones,
  a count that grows over a process's sessions (on the H100, from none to
  every record of a 53-record pass; a pause before the launches does not
  help), and now and then the last ones of a long pass.  So a pass
  starts with ``lead_spins`` spin kernels (``SPIN``) and ends with
  ``trail_spins``, and is kept only when spins are left before its first
  and after its last other device record and those records are at least
  the port kernels the stage launched (their own counters): then only
  spins were lost.  Each count grows with the loss seen at its end.  A
  pass that fails this is counted in
  ``kernel_profile_passes_lost_total{stage}`` and taken again at the
  stage's next run at that shape.

torch.profiler keeps one session per process, and its "is a session on"
flag is per thread, so the port's sessions take :data:`SESSION` first:
a pass is skipped while another session holds it (the scheduler's
``--profile-dir`` trace, :func:`trace_session`) and taken at a later
staged run, and a trace waits for a running pass.

Stage scoping doubles as ``torch.profiler.record_function("kat.<stage>")``,
so a ``--profile-dir`` trace carries the same stage names.

Cheap when off: every hook is one ``enabled`` attribute read.  The clock
is injectable (:meth:`KernelProfiler.set_now_fn`).  The active stage is
thread-local (the pipelined executor's decide worker runs staged
cycles); the tables are guarded by one lock and only dict operations run
under it — the profiler pass and the phase-A probe run outside it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional

import torch

from . import locking

_tls = threading.local()

# torch.cuda._sleep's kernel: launched first in a profiled pass, because
# torch.profiler loses the records of a session's first launches, and
# last, so that a pass whose records were cut short is seen
SPIN = "spin_kernel"
SPIN_CYCLES = 2000
# the spins a pass starts and ends with, at first and at most
SPINS = 256
SPINS_MAX = 8192


def current_stage() -> Optional[str]:
    """The kernel stage active on this thread (build attribution)."""
    return getattr(_tls, "stage", None)


_listener_installed = False


def _ensure_listener() -> None:
    """Register the build listener with ops/kernels/build.py once."""
    global _listener_installed
    if _listener_installed:
        return
    from ..ops.kernels import build

    def _on_build(name: str, seconds: float) -> None:
        prof = _profiler
        if prof is not None and prof.enabled:
            from .metrics import metrics

            metrics().counter_add("kernel_builds_total", labels={"fn": current_stage() or "other"})
            metrics().observe("kernel_build_seconds", float(seconds))

    build.ON_BUILD.append(_on_build)
    _listener_installed = True


def shape_key(st) -> str:
    """The shape signature costs are keyed by: the padded task / node /
    queue / job / group dims of a pack (the reference's key)."""
    return (
        f"T{int(st.task_valid.shape[0])}"
        f"xN{int(st.node_valid.shape[0])}"
        f"xQ{int(st.queue_valid.shape[0])}"
        f"xJ{int(st.job_valid.shape[0])}"
        f"xG{int(st.num_groups)}"
    )


# held for the life of every torch.profiler session the port starts
SESSION = threading.Lock()


@contextlib.contextmanager
def trace_session(path: str, device: torch.device):
    """A torch.profiler session (CPU activity, and CUDA on the card)
    around the body, its Chrome trace written to ``path`` (the
    scheduler's ``--profile-dir``).  Waits for a running pass.  On the
    card it starts with a spin kernel (``SPIN``), whose record takes the
    loss a fresh session can have."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with SESSION:
        with profile(activities=acts) as prof:
            if cuda:  # the launch whose record a fresh session can lose
                torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize(device)
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)


class KernelProfiler:
    """Per-(stage, shape) measured cost + profiled device-time estimates."""

    def __init__(self, now_fn: Optional[Callable[[], float]] = None):
        self.enabled = False
        self.now: Callable[[], float] = now_fn or time.time
        self._lock = locking.Lock("profiling.lock")
        # (shape_key, stage) -> measured aggregate
        self._measured: Dict[tuple, Dict[str, float]] = {}
        # (shape_key, stage) -> {"device_ms", "launches", ...} | {"error": ..}
        self._estimates: Dict[tuple, Dict[str, object]] = {}
        # (shape_key, stage) -> profiled passes that lost records
        self._lost: Dict[tuple, int] = {}
        # the spins a profiled pass starts and ends with (each grows with
        # the records lost at its end)
        self.lead_spins = self.trail_spins = SPINS

    def enable(self, on: bool = True) -> None:
        if on:
            _ensure_listener()
        self.enabled = on

    def set_now_fn(self, now_fn: Callable[[], float]) -> None:
        self.now = now_fn

    def reset(self) -> None:
        with self._lock:
            self._measured.clear()
            self._estimates.clear()
            self._lost.clear()

    # ---- stage scoping (build attribution + record_function) ----

    @contextlib.contextmanager
    def _stage_scope_live(self, stage: str):
        prev = getattr(_tls, "stage", None)
        _tls.stage = stage
        try:
            with torch.profiler.record_function(f"kat.{stage}"):
                yield
        finally:
            _tls.stage = prev

    def stage_scope(self, stage: str):
        """Bracket one kernel stage: builds inside are attributed to
        ``stage`` and the region is a named torch.profiler range.
        Disabled profiler -> a free null context."""
        if not self.enabled:
            return contextlib.nullcontext()
        return self._stage_scope_live(stage)

    # ---- the profiled pass (one per shape and stage) ----

    def estimate_scope(self, key: str, stage: str, device: torch.device):
        """Around one stage's run: the first time (``key``, ``stage``) is
        seen, and no other profiler session runs, the stage runs under
        torch.profiler and its device events become the estimate.  Any
        other time, a free null context."""
        if not self.enabled:
            return contextlib.nullcontext()
        with self._lock:
            if (key, stage) in self._estimates:
                return contextlib.nullcontext()
            if device.type != "cuda":
                self._estimates[(key, stage)] = {"device": device.type, "device_ms": 0.0,
                                                 "launches": 0, "estimated_at": self.now()}
                return contextlib.nullcontext()
            if not SESSION.acquire(blocking=False):
                return contextlib.nullcontext()
            self._estimates[(key, stage)] = {"pending": True}
        return self._estimate_live(key, stage)

    @contextlib.contextmanager
    def _estimate_live(self, key: str, stage: str):
        from torch.profiler import ProfilerActivity, profile

        from ..ops import kernels

        est: Optional[Dict[str, object]] = {"device": "cuda"}
        lead, trail = self.lead_spins, self.trail_spins
        try:
            port0 = sum(kernels.counts().values())
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(lead):
                    torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                est["profiled_ms"] = (time.perf_counter() - t0) * 1e3
                for _ in range(trail):
                    torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
            port = sum(kernels.counts().values()) - port0
            events = [e for e in prof.events()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
            dev = [e for e in events if SPIN not in e.name]
            spins = [e.time_range.start for e in events if SPIN in e.name]
            if dev:
                first = min(e.time_range.start for e in dev)
                last = max(e.time_range.start for e in dev)
                lead_seen = sum(t < first for t in spins)
                trail_seen = sum(t > last for t in spins)
            else:  # nothing between the spins to tell them apart
                lead_seen = trail_seen = len(spins) // 2
            # records are lost at either end: kept when spins are left at both
            if lead_seen and trail_seen and len(dev) >= port:
                est["device_ms"] = sum(e.time_range.elapsed_us() for e in dev) / 1e3
                est["launches"] = len(dev)
                est["records_lost"] = lead - lead_seen + trail - trail_seen
                self.lead_spins = min(SPINS_MAX, max(lead, 2 * (lead - lead_seen) + SPINS))
                self.trail_spins = min(SPINS_MAX, max(trail, 2 * (trail - trail_seen) + SPINS))
            else:
                est = None  # records lost: taken again at the next run
                if not lead_seen:
                    self.lead_spins = min(SPINS_MAX, 4 * lead)
                if not trail_seen:
                    self.trail_spins = min(SPINS_MAX, 4 * trail)
        except BaseException as err:
            est = {"error": f"{type(err).__name__}: {err}"}
            raise
        finally:
            SESSION.release()
            with self._lock:
                if est is None:
                    self._estimates.pop((key, stage), None)
                    self._lost[(key, stage)] = self._lost.get((key, stage), 0) + 1
                else:
                    est["estimated_at"] = self.now()
                    self._estimates[(key, stage)] = est
            if est is None:
                from .metrics import metrics

                metrics().counter_add("kernel_profile_passes_lost_total", labels={"stage": stage})

    # ---- measured costs (the staged runner records every cycle) ----

    def record_measured(
        self, stage: str, key: str, ms: float, rounds: Optional[int] = None,
        rounds_gated: Optional[int] = None,
    ) -> None:
        now = self.now()
        with self._lock:
            agg = self._measured.get((key, stage))
            if agg is None:
                agg = self._measured[(key, stage)] = {
                    "count": 0, "total_ms": 0.0,
                    "min_ms": ms, "max_ms": ms,
                    "last_ms": ms, "last_ts": now, "rounds_total": 0,
                    "rounds_gated_total": 0,
                }
            agg["count"] += 1
            agg["total_ms"] += ms
            agg["min_ms"] = min(agg["min_ms"], ms)
            agg["max_ms"] = max(agg["max_ms"], ms)
            agg["last_ms"] = ms
            agg["last_ts"] = now
            if rounds is not None:
                agg["rounds_total"] += int(rounds)
                agg["last_rounds"] = int(rounds)
            if rounds_gated is not None:
                agg["rounds_gated_total"] += int(rounds_gated)
                agg["last_rounds_gated"] = int(rounds_gated)

    def record_cycle(self, key: str, timings) -> None:
        """One staged cycle's ``(stage, ts, ms, rounds, rounds_gated, ...)``
        rows."""
        for row in timings:
            stage, _ts, ms, rounds = row[:4]
            gated = row[4] if len(row) > 4 else None
            self.record_measured(stage, key, ms, rounds, gated)

    def ensure_phase_split(self, key: str, prober: Callable) -> None:
        """Record the per-round preempt phase-A probe for a shape once
        (``prober`` returns ``{"panel_w", "phase_a_full_ms",
        "phase_a_gated_ms"}``, ops/cycle._measure_phase_split), served as
        the ``preempt:phase_a`` pseudo-stage: tail ~= measured mean -
        rounds_full * full_ms - rounds_gated * gated_ms."""
        stage = "preempt:phase_a"
        with self._lock:
            if (key, stage) in self._estimates:
                return
            self._estimates[(key, stage)] = {"pending": True}
        try:
            split = dict(prober())
        except Exception as err:  # best-effort, like the reference's
            split = {"error": f"{type(err).__name__}: {err}"}
        split["estimated_at"] = self.now()
        with self._lock:
            self._estimates[(key, stage)] = split

    # ---- the /debug/kernels view ----

    def table(self) -> Dict[str, object]:
        """JSON-ready measured-vs-device table, grouped by shape key then
        stage: ``measured`` (count, mean / min / max / last ms, rounds),
        ``estimate`` (the profiled pass: ``device_ms``, ``launches``,
        ``profiled_ms``; or the phase-A split), ``device_share`` = device
        ms over the measured mean, and ``lost_passes``, the profiled
        passes that lost records, where there were any."""
        with self._lock:
            measured = {k: dict(v) for k, v in self._measured.items()}
            estimates = {k: dict(v) for k, v in self._estimates.items()}
            lost = dict(self._lost)
        shapes: Dict[str, Dict[str, object]] = {}
        for (key, stage) in sorted(set(measured) | set(estimates) | set(lost)):
            entry: Dict[str, object] = {}
            m = measured.get((key, stage))
            e = estimates.get((key, stage))
            if (key, stage) in lost:
                entry["lost_passes"] = lost[(key, stage)]
            if m:
                m["mean_ms"] = m["total_ms"] / m["count"] if m["count"] else 0.0
                entry["measured"] = m
            if e and not e.get("pending"):
                entry["estimate"] = e
                if "device_ms" in e:
                    entry["device_ms"] = e["device_ms"]
                    entry["launches"] = e["launches"]
                    if m and m["mean_ms"] > 0:
                        entry["device_share"] = round(float(e["device_ms"]) / m["mean_ms"], 4)
            shapes.setdefault(key, {})[stage] = entry
        return {"generated_at": self.now(), "shapes": shapes}


_profiler: Optional[KernelProfiler] = None


def profiler() -> KernelProfiler:
    """Process-wide kernel profiler (disabled until something enables it
    — the CLI's ``--profile-kernels`` does)."""
    global _profiler
    if _profiler is None:
        _profiler = KernelProfiler()
    return _profiler
