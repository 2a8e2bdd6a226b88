"""Per-cycle timing histograms + Prometheus-text metrics export (the
port's copy of kube_arbitrator_tpu/utils/metrics.py).

The reference has no metrics endpoint at all — only leveled glog traces
(SURVEY §5: "No pprof endpoint, no Prometheus"); this package adds per-cycle
phase timing histograms because proving the <1 s/100k-pod target requires
them.  Names follow the kube-scheduler metric conventions
(``*_duration_seconds`` histograms, ``*_total`` counters) so standard
dashboards apply.

Thread-safety: the registry is written from the scheduler loop and leader
electors and read by ``render`` (the CLI's ``--metrics-file``) — every
method takes the one registry lock, and only dict/float ops run under it.

``METRIC_HELP`` is the single table of ``# HELP`` text for every metric
family the port emits (the reference's table less the families of the
planes the port has not ported: the pool, the sidecar, the pipeline,
chaos, the flight recorder, the audit and capture planes, the sharded
plane); registries seed their help text from it so call sites never
re-describe a family per cycle.  Each entry's text is the reference's.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple
from . import locking

# One table for every family's # HELP text (kube-scheduler naming
# conventions).  New families register here, not at the observation site.
METRIC_HELP: Dict[str, str] = {
    # scheduler cycle
    "e2e_scheduling_duration_seconds": "Full cycle latency: snapshot through actuation.",
    "cycle_phase_duration_seconds": "Per-phase cycle latency (snapshot/upload/kernel/decode/close/actuate/transport).",
    "kernel_action_duration_seconds": "Per-action decision-kernel wall time (staged runner; action label).",
    "kernel_rounds_total": "Rounds executed per action kernel (staged runner; evictive round-loop attribution; variant=gated counts rounds served by the incremental fast paths).",
    "pipeline_discards_total": "Speculative decisions dropped by commit-time revalidation (reason label).",
    "binds_total": "Committed bind intents.",
    "evicts_total": "Committed evict intents.",
    "pending_tasks": "Pending tasks observed at cycle start.",
    "cycles_total": "Scheduling cycles completed.",
    "cycle_errors_total": "Cycles that died with an error (class label: retryable/fatal).",
    "pending_reason_total": "Unschedulable pending pods by dominant FitError reason at cycle close (reason label).",
    # live cache
    "cache_watch_events_total": "Apiserver list/watch events applied to the live cache (phase label).",
    "cache_resync_depth": "errTasks resync queue depth at pump time.",
    "cache_snapshot_staleness_seconds": "Age of the live-cache model at the latest sync (gap between pumps).",
    "cache_relists_total": "Full relists forced by a 410-Gone compacted watch window.",
    # leader election
    "leader_renew_duration_seconds": "Leader lease renew round-trip latency.",
    "leader_fence_revalidations_total": "Actuation-fence storage re-validations of a stale-looking lease (outcome label: renewed/lost).",
    "leader_transitions_total": "Leadership transitions observed by this elector (to label).",
    "leader_is_leader": "1 when this elector currently holds the lease.",
}


def _default_buckets() -> List[float]:
    # 1 ms .. ~65 s exponential (seconds)
    return [0.001 * (2**i) for i in range(17)]


@dataclasses.dataclass
class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) with exact
    count/sum and quantile estimates from bucket interpolation."""

    buckets: List[float] = dataclasses.field(default_factory=_default_buckets)
    counts: List[int] = dataclasses.field(default=None)  # type: ignore[assignment]
    total: float = 0.0
    n: int = 0

    def __post_init__(self) -> None:
        if self.counts is None:
            self.counts = [0] * (len(self.buckets) + 1)  # +inf bucket

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.total += v
        self.n += 1

    def quantile_capped(self, q: float) -> Tuple[float, bool]:
        """(estimate, capped): linear interpolation inside the target
        bucket (Prometheus histogram_quantile).  When the rank lands in
        the +Inf overflow bucket there is no finite upper bound to
        interpolate toward — the estimate is the last finite bucket bound
        and ``capped`` is True (never NaN): the true quantile is >= the
        returned value.  Callers that surface the number should mark it
        (e.g. ">= 65.5s") instead of reporting a silently capped p99."""
        if self.n == 0:
            return math.nan, False
        rank = q * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= rank and c > 0:
                if i >= len(self.buckets):
                    return self.buckets[-1], True  # +Inf bucket: lower bound
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0), False
            cum += c
        return self.buckets[-1], True

    def quantile(self, q: float) -> float:
        """Quantile estimate; see :meth:`quantile_capped` for the +Inf
        overflow-bucket semantics (returns the last finite bound then)."""
        return self.quantile_capped(q)[0]

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else math.nan


class MetricsRegistry:
    """Counters, gauges, histograms with label support; renders the
    Prometheus text exposition format.  All methods are thread-safe."""

    # the reference's namespace, so a scrape of either package reads the
    # same series names
    def __init__(self, namespace: str = "kube_arbitrator_tpu"):
        self.namespace = namespace
        self._lock = locking.Lock("metrics.lock")
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}
        # seeded from the shared family table; describe() overrides
        self._help: Dict[str, str] = dict(METRIC_HELP)

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def describe(self, name: str, help_text: str) -> None:
        with self._lock:
            self._help[name] = help_text

    def counter_add(self, name: str, v: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + v

    def gauge_set(self, name: str, v: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = v

    def observe(self, name: str, v: float, labels: Optional[Dict[str, str]] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(v)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None) -> Optional[Histogram]:
        """The live histogram for one series (None when never observed).
        The returned object keeps being mutated by concurrent observes;
        snapshot its fields promptly if consistency matters."""
        with self._lock:
            return self._hists.get(self._key(name, labels))

    # ---- read accessors (the timeseries sampler's counter-delta source) ----

    def counter_total(self, name: str) -> float:
        """Sum of one counter family across all its label sets (0.0 when
        never incremented)."""
        with self._lock:
            return sum(v for (n, _l), v in self._counters.items() if n == name)

    def counter_value(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def gauge_value(
        self, name: str, labels: Optional[Dict[str, str]] = None,
        default: Optional[float] = None,
    ) -> Optional[float]:
        with self._lock:
            return self._gauges.get(self._key(name, labels), default)

    def gauge_values(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every label set of one gauge family -> its current value."""
        with self._lock:
            return {l: v for (n, l), v in self._gauges.items() if n == name}

    # ---- rendering ----

    @staticmethod
    def _fmt_labels(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt_value(v: float) -> str:
        """Full-precision sample rendering.  %g's 6 significant digits
        lose counter increments once values pass ~1e6 (the byte counters
        get there in a handful of cycles), which quantizes rate() on the
        scrape side; integral values render as exact integers, the rest
        as Python's shortest round-tripping float repr."""
        f = float(v)
        if f.is_integer() and abs(f) < 2**53:
            return str(int(f))
        return repr(f)

    def render(self) -> str:
        """Prometheus text exposition.  # HELP / # TYPE are emitted once
        per family (the format forbids repeating them per labeled series);
        series of one family are contiguous and label-sorted."""
        ns = self.namespace
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            # histograms deep-copied under the lock: rendering walks bucket
            # lists that concurrent observes mutate
            hists = [
                (k, Histogram(list(h.buckets), list(h.counts), h.total, h.n))
                for k, h in sorted(self._hists.items())
            ]
            help_text = dict(self._help)
        out: List[str] = []

        def _head(name: str, kind: str) -> None:
            full = f"{ns}_{name}"
            if name in help_text:
                out.append(f"# HELP {full} {help_text[name]}")
            out.append(f"# TYPE {full} {kind}")

        seen = None
        for (name, labels), v in counters:
            if name != seen:
                _head(name, "counter")
                seen = name
            out.append(f"{ns}_{name}{self._fmt_labels(labels)} {self._fmt_value(v)}")
        seen = None
        for (name, labels), v in gauges:
            if name != seen:
                _head(name, "gauge")
                seen = name
            out.append(f"{ns}_{name}{self._fmt_labels(labels)} {self._fmt_value(v)}")
        seen = None
        for (name, labels), h in hists:
            full = f"{ns}_{name}"
            if name != seen:
                _head(name, "histogram")
                seen = name
            cum = 0
            for i, b in enumerate(h.buckets):
                cum += h.counts[i]
                # the le label is built outside the f-string braces: a
                # backslash escape inside an f-string expression is a
                # SyntaxError before Python 3.12
                le = 'le="{:g}"'.format(b)
                out.append(f"{full}_bucket{self._fmt_labels(labels, le)} {cum}")
            le_inf = 'le="+Inf"'
            out.append(f"{full}_bucket{self._fmt_labels(labels, le_inf)} {h.n}")
            out.append(f"{full}_sum{self._fmt_labels(labels)} {self._fmt_value(h.total)}")
            out.append(f"{full}_count{self._fmt_labels(labels)} {h.n}")
        return "\n".join(out) + ("\n" if out else "")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_registry: Optional[MetricsRegistry] = None


def metrics() -> MetricsRegistry:
    """Process-wide registry (the default the scheduler records into)."""
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry


def record_kernel_rounds(registry: MetricsRegistry, action_rounds) -> None:
    """Emit ``kernel_rounds_total`` for one staged cycle's action-rounds
    dict, mapping ``"<action>:gated"`` entries (the staged runner's
    encoding for rounds the incremental fast paths served) to the
    ``variant="gated"`` series — the reference's label encoding, so
    dashboards read either package alike."""
    for action, rounds in (action_rounds or {}).items():
        if action.endswith(":gated"):
            registry.counter_add(
                "kernel_rounds_total", rounds,
                labels={"action": action[: -len(":gated")],
                        "variant": "gated"},
            )
        elif action.endswith(":conflicts"):
            # optimistic-reclaim speculative claims discarded at the
            # in-round commit gate: the same revalidate-or-discard
            # vocabulary as the reference's pipeline plane (its
            # revalidate.DISCARD_REASONS carries "claim_conflict")
            registry.counter_add(
                "pipeline_discards_total", rounds,
                labels={"reason": "claim_conflict"},
            )
        else:
            registry.counter_add(
                "kernel_rounds_total", rounds, labels={"action": action}
            )
