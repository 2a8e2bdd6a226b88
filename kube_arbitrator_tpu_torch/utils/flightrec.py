"""Flight recorder: the last N cycles survive the crash that needs them
(the port's copy of kube_arbitrator_tpu/utils/flightrec.py).

When a cycle goes wrong — a stale lease discarding a decision, a wedged
device stretching a cycle past its SLO, a dtype contract violation — the
per-cycle evidence is gone by the next cycle.  This module keeps a
bounded ring of the most recent cycles' digests (stats, bind/evict
counts, pending histogram, per-action kernel ms, completed spans) and
**dumps the whole ring to a JSON file the moment an anomaly fires**, so
the state that *preceded* a failure is always on disk.

Anomaly sources (wired in ``framework/scheduler.py``):

* cycle latency over the configured SLO (``--cycle-slo-ms``),
* ``LeaderLost`` — renew failure or the post-decision actuation fence,
* decision-dtype contract violations (``session._assert_decision_dtypes``),
* an arena divergence, and any other cycle-fatal exception,
* a multi-window SLO burn (``utils/timeseries.CycleSampler``).

The ring and the dump counter are guarded by one lock; file I/O happens
outside it (a slow disk must not stall readers like the obs server's
``/debug/cycles`` handler).  The dump format is the reference's
(``DUMP_FORMAT_VERSION`` 1).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Deque, Dict, List, Optional

from .metrics import metrics
from . import locking

DUMP_FORMAT_VERSION = 1


@dataclasses.dataclass
class CycleRecord:
    """One cycle's digest, small enough to keep hundreds of."""

    seq: int                         # scheduler cycle ordinal (1-based)
    corr_id: str                     # trace correlation id ("" untraced)
    ts: float                        # wall-clock cycle start
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    digests: Dict[str, object] = dataclasses.field(default_factory=dict)
    spans: List[Dict[str, object]] = dataclasses.field(default_factory=list)
    error: Optional[str] = None      # set when the cycle died

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class FlightRecorder:
    """Bounded ring of :class:`CycleRecord` + anomaly-triggered dumps.

    ``dump_dir=None`` keeps the ring purely in memory (the obs server can
    still read it); with a directory set, every :meth:`anomaly` writes
    ``flight-<n>-<kind>.json`` there and returns the path.
    """

    def __init__(self, capacity: int = 64, dump_dir: Optional[str] = None):
        self.capacity = capacity
        self.dump_dir = dump_dir
        self._lock = locking.Lock("flightrec.lock")
        self._ring: Deque[CycleRecord] = collections.deque(maxlen=capacity)
        self._dump_seq = 0
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)

    def record(self, rec: CycleRecord) -> None:
        with self._lock:
            self._ring.append(rec)

    def entries(self) -> List[Dict[str, object]]:
        """Ring contents oldest-first, as plain dicts (JSON-ready)."""
        with self._lock:
            snapshot = list(self._ring)
        return [r.to_dict() for r in snapshot]

    def last(self) -> Optional[CycleRecord]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def anomaly(self, kind: str, detail: str = "") -> Optional[str]:
        """An anomaly happened: snapshot the ring and (when a dump dir is
        configured) persist it.  Returns the dump path, or None when
        memory-only.  Counted in ``flight_anomalies_total{kind=...}``."""
        metrics().counter_add("flight_anomalies_total", labels={"kind": kind})
        with self._lock:
            snapshot = [r.to_dict() for r in self._ring]
            self._dump_seq += 1
            seq = self._dump_seq
        if not self.dump_dir:
            return None
        payload = {
            "format_version": DUMP_FORMAT_VERSION,
            "kind": kind,
            "detail": detail,
            "dumped_at": time.time(),
            "cycles": snapshot,   # oldest first; last entry = failing cycle
        }
        path = os.path.join(self.dump_dir, f"flight-{seq:04d}-{kind}.json")
        # write-then-rename: a dump triggered by a crash must never leave a
        # half-written JSON as the only evidence
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        metrics().counter_add("flight_dumps_total")
        return path
