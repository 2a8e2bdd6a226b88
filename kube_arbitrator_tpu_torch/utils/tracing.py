"""Structured span tracing for the scheduling cycle (the port's copy of
kube_arbitrator_tpu/utils/tracing.py).

SURVEY §5: the reference ships leveled glog lines and nothing else — when
a cycle misbehaves the only evidence is whatever happened to be printed.
This module gives every scheduling cycle a **correlation id** and a tree
of timed spans (cycle → snapshot / arena.* → upload → decide →
kernel.<stage> per staged action → decode → close → actuate; the
pipelined executor's pipeline.* stages), so one cycle's time reads as
one trace.

Design constraints, in order:

* **Cheap when off.**  The tracer defaults to disabled; ``span()`` is a
  no-op null context then (one attribute read per call site).
* **Thread-correct.**  The active correlation id is thread-local (the
  pipelined executor's decide worker records spans of the cycle it
  decides while the ingest thread records the next one's); the
  completed-span store is a dict guarded by one lock, and only dict/list
  ops ever run under it.
* **Bounded.**  Completed traces live in an insertion-ordered dict capped
  at ``max_traces`` — the flight recorder persists anything worth keeping
  longer.
* **Standard export.**  :meth:`Tracer.export_chrome` renders one trace as
  Chrome-trace/Perfetto JSON (``chrome://tracing`` / ui.perfetto.dev),
  beside the whole-process ``torch.profiler`` trace the scheduler writes
  with ``--profile-dir``.

The reference stitches a cycle across its RPC sidecar by shipping the id
as gRPC metadata; the port has no sidecar, so the ids stay in-process.
The span names, the sampling rule, the store and the export are the
reference's, so an export of either package reads alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import uuid
from typing import Dict, List, Optional
from . import locking


@dataclasses.dataclass
class Span:
    """One completed, timed region of a cycle."""

    name: str
    corr_id: str
    component: str          # which plane produced it: scheduler | sidecar
    ts: float               # wall-clock start (time.time seconds)
    dur_s: float            # duration (perf_counter delta)
    args: Dict[str, object] = dataclasses.field(default_factory=dict)
    depth: int = 0          # nesting depth within its component/thread

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class _NullSpan:
    """The disabled-tracer span: absorbs the context protocol for free."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Correlation-id span tracer with a bounded completed-trace store."""

    def __init__(self, max_traces: int = 256, enabled: bool = False,
                 sample_rate: float = 1.0):
        self.max_traces = max_traces
        self.enabled = enabled
        # fraction of cycles traced (deterministic stride sampling);
        # sampled-out cycles get corr_id None, so every span() inside
        # them is the free null context — NO spans are allocated.  Lets
        # tracing stay on at 50k-task scale where per-cycle span trees
        # would otherwise dominate the obs overhead.
        self.sample_rate = sample_rate
        self._lock = locking.Lock("tracing.lock")
        # corr id -> completed spans, insertion-ordered for eviction
        self._traces: Dict[str, List[Span]] = {}
        # corr id -> linked corr ids (e.g. a tenant cycle -> the shared
        # pool-batch launch trace); bounded with the trace store
        self._links: Dict[str, List[str]] = {}
        self._tls = threading.local()

    # ---- enablement / identity ----

    def enable(self, on: bool = True) -> None:
        self.enabled = on

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._links.clear()

    @staticmethod
    def new_corr_id(seq: Optional[int] = None) -> str:
        """A fresh correlation id; ``seq`` embeds the cycle ordinal so ids
        sort and read chronologically in dumps."""
        tail = uuid.uuid4().hex[:8]
        return f"c{seq:06d}-{tail}" if seq is not None else f"c-{tail}"

    def corr_for_cycle(self, seq: int) -> Optional[str]:
        """Sampling-aware correlation id for cycle ordinal ``seq``: None
        when the tracer is disabled OR the cycle is sampled out.  The
        stride rule (a cycle is sampled iff ``floor(seq*rate)`` advances
        over ``floor((seq-1)*rate)``) is deterministic and spreads the
        sampled cycles uniformly — rate 0.25 traces every 4th cycle, the
        same cycles every run."""
        if not self.enabled:
            return None
        rate = self.sample_rate
        if rate >= 1.0:
            return self.new_corr_id(seq)
        if rate <= 0.0:
            return None
        import math

        if math.floor(seq * rate) == math.floor((seq - 1) * rate):
            return None
        return self.new_corr_id(seq)

    def current_corr_id(self) -> Optional[str]:
        return getattr(self._tls, "corr", None)

    def current_component(self) -> str:
        return getattr(self._tls, "component", "scheduler")

    # ---- activation (per-thread) ----

    @contextlib.contextmanager
    def activate(self, corr_id: Optional[str], component: Optional[str] = None):
        """Bind ``corr_id`` (and optionally a component name) to this
        thread for the duration — every ``span()`` inside attaches to it.
        ``corr_id=None`` is a no-op passthrough so call sites need no
        enabled-check of their own."""
        if corr_id is None:
            yield None
            return
        prev_corr = getattr(self._tls, "corr", None)
        prev_comp = getattr(self._tls, "component", None)
        self._tls.corr = corr_id
        if component is not None:
            self._tls.component = component
        try:
            yield corr_id
        finally:
            self._tls.corr = prev_corr
            if component is not None:
                self._tls.component = prev_comp

    # ---- recording ----

    def span(self, name: str, **args):
        """Context manager timing one region under the thread's active
        correlation id.  No active id or disabled tracer -> no-op."""
        if not self.enabled or getattr(self._tls, "corr", None) is None:
            return _NULL_SPAN
        return _LiveSpan(self, name, args)

    def record_span(
        self,
        name: str,
        ts: float,
        dur_s: float,
        corr_id: Optional[str] = None,
        component: Optional[str] = None,
        depth: Optional[int] = None,
        **args,
    ) -> None:
        """Record an externally-timed span (e.g. per-action kernel stage
        timings measured by the staged cycle runner)."""
        if not self.enabled:
            return
        corr = corr_id if corr_id is not None else getattr(self._tls, "corr", None)
        if corr is None:
            return
        span = Span(
            name=name,
            corr_id=corr,
            component=component or self.current_component(),
            ts=ts,
            dur_s=dur_s,
            args=dict(args),
            depth=depth if depth is not None else len(getattr(self._tls, "stack", ())),
        )
        self._store(span)

    def _store(self, span: Span) -> None:
        with self._lock:
            bucket = self._traces.get(span.corr_id)
            if bucket is None:
                bucket = self._traces[span.corr_id] = []
                while len(self._traces) > self.max_traces:
                    # evict oldest corr id (insertion order)
                    evicted = next(iter(self._traces))
                    self._traces.pop(evicted)
                    self._links.pop(evicted, None)
            bucket.append(span)

    # ---- trace links (cross-trace joins, e.g. pool batch stitching) ----

    def link(self, corr_id: str, other: str) -> None:
        """Join ``corr_id`` to ``other``: exports of ``corr_id`` include
        the linked trace's spans (the pool links every batched tenant
        cycle to the shared ``pool_batch`` launch trace this way).  A
        no-op when disabled; bounded by the trace store's own cap."""
        if not self.enabled or corr_id is None or other is None:
            return
        with self._lock:
            linked = self._links.setdefault(corr_id, [])
            if other not in linked:
                linked.append(other)

    def links(self, corr_id: str) -> List[str]:
        with self._lock:
            return list(self._links.get(corr_id, ()))

    # ---- retrieval / export ----

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def spans(self, corr_id: str) -> List[Span]:
        with self._lock:
            return list(self._traces.get(corr_id, ()))

    def export_chrome(self, corr_id: str, follow_links: bool = True) -> Dict[str, object]:
        """One trace as Chrome-trace JSON (the Perfetto legacy format):
        complete ('X') events with microsecond timestamps, one virtual
        thread per component, correlation id in every event's args.
        ``follow_links`` (default) also renders the spans of linked
        traces (:meth:`link`) — a batched tenant cycle's export shows
        the shared ``pool_batch`` launch on its own component thread."""
        spans = self.spans(corr_id)
        if follow_links:
            for other in self.links(corr_id):
                spans = spans + self.spans(other)
        tids: Dict[str, int] = {}
        events: List[Dict[str, object]] = []
        for s in spans:
            tid = tids.setdefault(s.component, len(tids) + 1)
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "cat": "cycle",
                    "ts": s.ts * 1e6,
                    "dur": s.dur_s * 1e6,
                    "pid": 1,
                    "tid": tid,
                    "args": {"corr_id": s.corr_id, **s.args},
                }
            )
        for component, tid in tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": component},
                }
            )
        return {"displayTimeUnit": "ms", "traceEvents": events}


class _LiveSpan:
    """An open span: measures wall + perf_counter, stores on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_ts", "_t0", "_depth")

    def __init__(self, tracer: Tracer, name: str, args: Dict[str, object]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_LiveSpan":
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self._depth = len(stack)
        stack.append(self._name)
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def note(self, **args) -> None:
        """Attach key/values discovered mid-span (e.g. bind counts)."""
        self._args.update(args)

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack:
            stack.pop()
        if exc_type is not None:
            self._args.setdefault("error", f"{exc_type.__name__}: {exc}")
        corr = getattr(tls, "corr", None)
        if corr is not None:
            self._tracer._store(
                Span(
                    name=self._name,
                    corr_id=corr,
                    component=self._tracer.current_component(),
                    ts=self._ts,
                    dur_s=dur,
                    args=self._args,
                    depth=self._depth,
                )
            )
        return False


_tracer: Optional[Tracer] = None


def tracer() -> Tracer:
    """Process-wide tracer (disabled until something enables it — the CLI
    does when any observability flag is set)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer
