"""Metric time-series ring, multi-window SLO burn-rate monitoring and the
per-cycle sampler (the port's copy of
kube_arbitrator_tpu/utils/timeseries.py).

The ring keeps a fixed number of ``{"ts": t, <key>: value}`` sample
rows; the burn monitor on top of it is the SRE-workbook multi-window
policy: the burn of a window is ``(fraction of samples breaching) /
budget``, and a pair fires only when BOTH its long and short windows
burn at or past the pair's threshold (sustained AND still happening),
once per episode.  The decision pool's per-tenant admission
(rpc/pool.TenantAdmission) reads them, and :class:`CycleSampler` samples
the scheduler's families into a ring once per committed cycle (the
``timeseries=`` seam of framework.Scheduler), served at
``/debug/timeseries`` (obs.py).

Clocks are injectable everywhere (``now_fn``).  Ring appends and reads
take one lock around deque operations only.

Not ported: the sampler's fleet rollup (the reference's
``shard_rollup_values`` columns and its ``skew_monitor``), which waits
for ``utils/fleet.py``; passing a ``skew_monitor`` raises.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, metrics
from . import locking

# (long_s, short_s, burn_threshold) pairs, fastest-burn first.  Scaled
# for a ~1 s cycle cadence: the fast pair catches an acute stall inside
# a minute, the slow pair catches a simmering 2x-budget burn.
DEFAULT_BURN_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 30.0, 10.0),
    (3600.0, 300.0, 2.0),
)
DEFAULT_BUDGET = 0.05  # 5% of cycles may exceed the SLO


class TimeSeriesRing:
    """Fixed-size ring of ``{"ts": t, <key>: value, ...}`` sample rows."""

    def __init__(self, capacity: int = 4096,
                 now_fn: Optional[Callable[[], float]] = None):
        self.capacity = capacity
        self.now: Callable[[], float] = now_fn or time.time
        self._lock = locking.Lock("timeseries.ring.lock")
        self._ring = collections.deque(maxlen=capacity)

    def sample(self, values: Dict[str, float],
               ts: Optional[float] = None) -> None:
        row = {"ts": float(ts if ts is not None else self.now())}
        row.update(values)
        with self._lock:
            self._ring.append(row)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def rows(self, window_s: Optional[float] = None,
             now: Optional[float] = None) -> List[Dict[str, float]]:
        """Samples oldest-first; ``window_s`` keeps only rows newer than
        ``now - window_s``."""
        with self._lock:
            out = list(self._ring)
        if window_s is not None:
            cutoff = (now if now is not None else self.now()) - window_s
            out = [r for r in out if r["ts"] >= cutoff]
        return out

    def series(self, key: str, window_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        return [(r["ts"], r[key]) for r in self.rows(window_s) if key in r]


class BurnPairMonitor:
    """The multi-window burn machinery, policy-free: per pair, the burn
    of a window is ``(fraction of samples breaching) / budget``; a pair
    fires when BOTH its long and short windows burn at or past the
    threshold (sustained AND still happening), once per episode
    (hysteresis: re-armed when the short window recovers below burn
    1.0), gated on ``min_samples`` in the long window so one bad warmup
    sample of a 1-sample window cannot page.  Subclasses fix the ring
    column (``column``), the per-sample breach predicate
    (:meth:`_breaches`), and the firing side effects (:meth:`_on_fire`,
    :meth:`_observe_burn`) — the cycle-SLO monitor below and the
    reference's fleet shard-skew monitor share ONE copy of the policy."""

    column = "cycle_ms"

    def __init__(
        self,
        ring: TimeSeriesRing,
        budget: float,
        windows: Tuple[Tuple[float, float, float], ...],
        min_samples: int,
    ):
        if not 0 < budget < 1:
            raise ValueError(f"budget must be in (0, 1), got {budget}")
        self.ring = ring
        self.budget = float(budget)
        self.windows = tuple(windows)
        self.min_samples = min_samples
        # per-pair firing state (hysteresis): long-window key -> active
        self._active: Dict[str, bool] = {}

    def _breaches(self, v: float) -> bool:
        raise NotImplementedError

    def _observe_burn(self, key: str, burn: Optional[float]) -> None:
        """Per-check hook with the long-window burn (None: no samples)."""

    def _on_fire(self, key: str, pair: Dict[str, float]) -> None:
        """A pair newly fired (once per episode)."""

    def _window_vals(self, window_s: float,
                     now: Optional[float] = None) -> List[float]:
        return [
            r[self.column] for r in self.ring.rows(window_s, now)
            if r.get(self.column) is not None
        ]

    def _burn_of(self, vals: List[float]) -> Optional[float]:
        """Budget-burn multiple of a window's samples (None: no samples):
        ``(breach fraction) / budget`` — the ONE formula every caller
        shares."""
        if not vals:
            return None
        return sum(1 for v in vals if self._breaches(v)) / len(vals) / self.budget

    def burn_rate(self, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        return self._burn_of(self._window_vals(window_s, now))

    def _pair_status(self, now: Optional[float] = None) -> List[Dict[str, object]]:
        return [
            {
                "long_s": long_s,
                "short_s": short_s,
                "threshold": threshold,
                "long_burn": self.burn_rate(long_s, now),
                "short_burn": self.burn_rate(short_s, now),
                "firing": self._active.get(f"{long_s:g}s", False),
            }
            for long_s, short_s, threshold in self.windows
        ]

    def check(self, now: Optional[float] = None) -> List[Dict[str, float]]:
        """Evaluate every window pair; returns the pairs that NEWLY
        fired (an already-firing pair stays silent until its short
        window recovers below burn 1.0)."""
        fired = []
        for long_s, short_s, threshold in self.windows:
            key = f"{long_s:g}s"
            long_vals = self._window_vals(long_s, now)
            long_burn = self._burn_of(long_vals)
            short_burn = self.burn_rate(short_s, now)
            self._observe_burn(key, long_burn)
            if long_burn is None or short_burn is None:
                continue
            if len(long_vals) < self.min_samples:
                continue
            if long_burn >= threshold and short_burn >= threshold:
                if not self._active.get(key):
                    self._active[key] = True
                    pair = {
                        "window_s": long_s, "short_s": short_s,
                        "burn": long_burn, "short_burn": short_burn,
                        "threshold": threshold,
                    }
                    self._on_fire(key, pair)
                    fired.append(pair)
            elif short_burn < 1.0:
                self._active[key] = False
        return fired


class SloBurnMonitor(BurnPairMonitor):
    """Multi-window burn-rate alerts over a ring's ``cycle_ms`` series
    (a sample breaches when it exceeds the cycle-latency SLO)."""

    def __init__(
        self,
        ring: TimeSeriesRing,
        slo_ms: float,
        budget: float = DEFAULT_BUDGET,
        windows: Tuple[Tuple[float, float, float], ...] = DEFAULT_BURN_WINDOWS,
        registry: Optional[MetricsRegistry] = None,
        min_samples: int = 10,
    ):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {slo_ms}")
        super().__init__(ring, budget, windows, min_samples)
        self.slo_ms = float(slo_ms)
        self.registry = registry if registry is not None else metrics()

    def _breaches(self, v: float) -> bool:
        return v > self.slo_ms

    def _observe_burn(self, key: str, burn: Optional[float]) -> None:
        # long-window burn rates land in the gauge every check, firing
        # or not — the dashboard's leading indicator
        if burn is not None:
            self.registry.gauge_set(
                "slo_burn_rate", burn, labels={"window": key}
            )

    def _on_fire(self, key: str, pair: Dict[str, float]) -> None:
        self.registry.counter_add(
            "slo_burn_alerts_total", labels={"window": key}
        )

    def breach_fraction(self, window_s: float,
                        now: Optional[float] = None) -> Optional[float]:
        """Fraction of window cycles over the SLO (None: no samples)."""
        vals = self._window_vals(window_s, now)
        if not vals:
            return None
        return sum(1 for v in vals if v > self.slo_ms) / len(vals)

    def status(self, now: Optional[float] = None) -> Dict[str, object]:
        """The /debug/timeseries burn block: per-pair long/short burn
        rates, thresholds, and firing state."""
        return {"slo_ms": self.slo_ms, "budget": self.budget,
                "pairs": self._pair_status(now)}


class CycleSampler:
    """Samples the key families into the ring once per committed cycle
    and runs the burn monitor — the scheduler calls :meth:`on_cycle`
    from ``_record_metrics`` (sequential and pipelined paths both).

    Sampled per cycle:

    * ``cycle_ms`` — the cycle period (pipelined: commit-to-commit),
      plus binds/evicts/pending and the per-phase ms from CycleStats;
    * ``kernel_<action>_ms`` / ``rounds_<action>`` — staged-runner
      attribution when tracing/profiling is on;
    * counter DELTAS since the previous sample (upload bytes, pipeline
      discards, backpressure, kernel builds, turn-batch fallbacks,
      decode overflows) — the ring stores per-cycle increments, not
      cumulative totals;
    * ``occ_<stage>`` — the pipeline occupancy gauges as-is.
    """

    # the reference's keys, less the families of planes the port has not
    # ported (sharding, capture); ``retraces`` reads the port's build
    # counter (utils/profiling.py)
    COUNTER_DELTAS = {
        "upload_bytes": "device_upload_bytes_total",
        "discards": "pipeline_discards_total",
        "backpressure": "pipeline_backpressure_total",
        "retraces": "kernel_builds_total",
        "turn_batch_fallbacks": "turn_batch_fallback_total",
        "decode_overflows": "decode_overflow_total",
    }
    OCCUPANCY_GAUGE = "pipeline_stage_occupancy"

    def __init__(
        self,
        ring: Optional[TimeSeriesRing] = None,
        registry: Optional[MetricsRegistry] = None,
        slo_ms: Optional[float] = None,
        budget: float = DEFAULT_BUDGET,
        windows: Tuple[Tuple[float, float, float], ...] = DEFAULT_BURN_WINDOWS,
        flight=None,
        now_fn: Optional[Callable[[], float]] = None,
        skew_monitor=None,
    ):
        if skew_monitor is not None:
            raise NotImplementedError(
                "CycleSampler(skew_monitor=...): the fleet rollup waits for utils/fleet.py, "
                "which the port has not ported")
        # `is not None`, not truthiness: an EMPTY ring is len()==0 falsy
        self.ring = ring if ring is not None else TimeSeriesRing(now_fn=now_fn)
        self.registry = registry if registry is not None else metrics()
        self.flight = flight
        self.burn = (
            SloBurnMonitor(self.ring, slo_ms, budget, windows, self.registry)
            if slo_ms else None
        )
        self.skew_monitor = None
        self._prev_counters: Dict[str, float] = {}

    def set_now_fn(self, now_fn: Callable[[], float]) -> None:
        self.ring.now = now_fn

    def on_cycle(
        self,
        stats,
        action_ms: Optional[Dict[str, float]] = None,
        action_rounds: Optional[Dict[str, int]] = None,
        ts: Optional[float] = None,
    ) -> List[Dict[str, float]]:
        """Record one committed cycle; returns the burn pairs that newly
        fired (after raising their ``slo_burn`` flight anomaly)."""
        values: Dict[str, float] = {
            "cycle_ms": stats.cycle_ms,
            "binds": stats.binds,
            "evicts": stats.evicts,
            "pending": stats.pending_before,
            "snapshot_ms": stats.snapshot_ms,
            "upload_ms": stats.upload_ms,
            "kernel_ms": stats.kernel_ms,
            "decode_ms": stats.decode_ms,
            "close_ms": stats.close_ms,
            "actuate_ms": stats.actuate_ms,
            "transport_ms": stats.transport_ms,
            "capture_ms": getattr(stats, "capture_ms", 0.0),
        }
        for stage, ms in (action_ms or {}).items():
            values[f"kernel_{stage}_ms"] = ms
        for action, rounds in (action_rounds or {}).items():
            # ":gated"-suffixed entries become rounds_<action>_gated rows
            values[f"rounds_{action.replace(':', '_')}"] = rounds
        for key, family in self.COUNTER_DELTAS.items():
            total = self.registry.counter_total(family)
            prev = self._prev_counters.get(key)
            self._prev_counters[key] = total
            # once a family has ever incremented, every row carries its
            # delta — including 0 — so a window mean over the series sees
            # the quiet cycles too; never-used families stay out of rows
            if prev is None:
                if total:
                    values[key] = total
            elif total or prev:
                values[key] = total - prev
        for labels, v in self.registry.gauge_values(self.OCCUPANCY_GAUGE).items():
            stage = dict(labels).get("stage", "")
            if stage:
                values[f"occ_{stage}"] = round(v, 4)
        self.ring.sample(values, ts=ts)
        if self.burn is None:
            return []
        fired = self.burn.check(ts)
        for pair in fired:
            if self.flight is not None:
                self.flight.anomaly(
                    "slo_burn",
                    detail=(
                        f"burn {pair['burn']:.1f}x over {pair['window_s']:g}s "
                        f"(short {pair['short_burn']:.1f}x / "
                        f"{pair['short_s']:g}s, threshold "
                        f"{pair['threshold']:g}x, slo "
                        f"{self.burn.slo_ms:g} ms, budget "
                        f"{self.burn.budget:g})"
                    ),
                )
        return fired
