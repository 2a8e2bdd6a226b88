"""The served observability plane: /metrics, health, and debug endpoints
(the port of kube_arbitrator_tpu/obs.py).

The reference has no metrics endpoint (SURVEY §5: "no pprof endpoint, no
Prometheus"); :mod:`utils.metrics` renders Prometheus text and this module
serves it with the same stdlib ``ThreadingHTTPServer`` pattern the
apiserver shim uses (:mod:`cache.httpapi`) — no client libraries, one
daemon thread.

Endpoints (the reference's, same paths, status codes and JSON keys):

=========================  ==================================================
path                       serves
=========================  ==================================================
``/metrics``               Prometheus text exposition (``MetricsRegistry.render``)
``/healthz``               liveness: 200 + process/device info JSON
``/readyz``                readiness: 200 when scheduling (leader + fresh
                           cycle), 503 otherwise — the k8s probe split
``/debug/cycles``          recent flight-recorder entries as JSON
``/debug/trace/<corr>``    one cycle's span tree as Chrome-trace/Perfetto JSON
``/debug/kernels``         measured stage times and profiled device time per
                           stage per shape (utils/profiling.KernelProfiler.table)
``/debug/timeseries``      per-cycle metric samples + SLO burn status
                           (``?window=<seconds>`` bounds the range)
``/debug/pool``            decision-pool status (rpc/pool.DecisionPool.status)
=========================  ==================================================

``/debug/audit``, ``/debug/audit/<corr>``, ``/debug/fleet``,
``/debug/fleet/tenants``, ``/debug/capture`` and ``/debug/whatif`` answer
as the reference's do when their plane is not wired: the port has not
ported those planes.  ``device_info`` reports the card from ``torch.cuda``.

Multi-process posture: ``port=0`` binds an ephemeral port (the returned
base_url carries the real one — callers must log it), and
``replica_id`` stamps ``/healthz`` + ``/readyz``.

Handlers only READ: the registry snapshots under its own lock, the flight
recorder copies its ring under its lock, and the status callable reads
scheduler attributes that are single-writer (the loop thread) — the
observability plane must never be able to stall a cycle.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from .utils import locking
from .utils.flightrec import FlightRecorder
from .utils.metrics import MetricsRegistry, metrics
from .utils.profiling import KernelProfiler, profiler
from .utils.tracing import Tracer, tracer


def device_info() -> Dict[str, object]:
    """Device liveness for /healthz: the reference's keys (platform +
    count) from ``torch.cuda``, the card's name beside them, or the error
    that made CUDA unreachable.  Without a card the platform is ``cpu``."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"platform": "cpu", "device_count": 0}
        return {
            "platform": "gpu",
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0),
        }
    except Exception as err:  # a failing runtime IS the signal
        return {"platform": "unavailable", "device_count": 0, "error": str(err)}


def scheduler_status_fn(
    sched, max_cycle_age_s: Optional[float] = None
) -> Callable[[], Dict[str, object]]:
    """Status callable over a :class:`framework.Scheduler`: leadership,
    last-cycle age, cycle count, and the readiness verdict.  Reads are
    cross-thread but single-writer (the scheduler loop), so the worst
    case is a one-cycle-stale answer — fine for a probe."""
    import time

    def status() -> Dict[str, object]:
        elector = sched.elector
        leader = None if elector is None else bool(elector.is_leader)
        last_ts = sched.last_cycle_ts
        age = None if last_ts is None else time.time() - last_ts
        ready = last_ts is not None and leader in (None, True)
        if ready and max_cycle_age_s is not None and age > max_cycle_age_s:
            ready = False
        return {
            "ready": ready,
            "leader": leader,
            "cycles": len(sched.history),
            "last_cycle_age_s": age,
        }

    return status


class _ObsHandler(BaseHTTPRequestHandler):
    server_version = "kat-obs/1.0"
    protocol_version = "HTTP/1.1"
    # a stalled scraper must not pin a handler thread forever
    timeout = 30.0

    def log_message(self, fmt, *args):  # quiet like the apiserver shim
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, indent=1).encode(), "application/json")

    def do_GET(self) -> None:
        registry: MetricsRegistry = self.server.obs_registry  # type: ignore[attr-defined]
        flight: Optional[FlightRecorder] = self.server.obs_flight  # type: ignore[attr-defined]
        tr: Tracer = self.server.obs_tracer  # type: ignore[attr-defined]
        status_fn = self.server.obs_status_fn  # type: ignore[attr-defined]
        prof: KernelProfiler = self.server.obs_profiler  # type: ignore[attr-defined]
        timeseries = self.server.obs_timeseries  # type: ignore[attr-defined]
        pool = self.server.obs_pool  # type: ignore[attr-defined]
        replica_id = self.server.obs_replica_id  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        # fixed route vocabulary for the counter label: a scanner probing
        # random paths must not mint unbounded label series in the
        # process-wide registry (each series lives forever)
        if path.startswith("/debug/trace/"):
            route = "/debug/trace"
        elif path.startswith("/debug/audit/"):
            route = "/debug/audit"
        else:
            route = path
        if route not in ("/", "/metrics", "/healthz", "/readyz",
                         "/debug/cycles", "/debug/trace", "/debug/audit",
                         "/debug/kernels", "/debug/timeseries", "/debug/pool",
                         "/debug/fleet", "/debug/fleet/tenants",
                         "/debug/capture", "/debug/whatif"):
            route = "other"
        registry.counter_add("obs_requests_total", labels={"path": route})

        if path == "/metrics":
            self._send(
                200, registry.render().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            return
        if path == "/healthz":
            body = {"ok": True, **device_info(), **status_fn()}
            if replica_id:
                body["replica"] = replica_id
            self._send_json(200, body)
            return
        if path == "/readyz":
            # the replica id rides the probe body so N pool replicas on
            # one host are tellable apart by their readiness endpoints
            st = dict(status_fn())
            if replica_id:
                st["replica"] = replica_id
            self._send_json(200 if st.get("ready") else 503, st)
            return
        if path == "/debug/pool":
            if pool is None:
                self._send_json(200, {
                    "replicas": [],
                    "error": "no decision pool wired (pass pool= to serve_obs)",
                })
                return
            self._send_json(200, pool.status())
            return
        # the planes the port has not ported: the reference's answers
        # when they are not wired
        if path in ("/debug/fleet", "/debug/fleet/tenants"):
            self._send_json(200, {
                "window": None, "tenants": [],
                "error": "no fleet plane wired (pass fleet= to serve_obs)",
            })
            return
        if path == "/debug/whatif":
            self._send_json(200, {
                "requests": [],
                "error": "no shadow engine wired (pass whatif= to "
                         "serve_obs)",
            })
            return
        if path == "/debug/capture":
            self._send_json(200, {
                "cycles": 0, "chunks": 0,
                "error": "no session capture wired (run with "
                         "--capture-dir / pass capture= to serve_obs)",
            })
            return
        if path == "/debug/cycles":
            entries = flight.entries() if flight is not None else []
            self._send_json(200, {"capacity": getattr(flight, "capacity", 0),
                                  "cycles": entries})
            return
        if path == "/debug/kernels":
            self._send_json(200, prof.table())
            return
        if path == "/debug/timeseries":
            window = None
            try:
                qs = urllib.parse.parse_qs(query)
                if qs.get("window"):
                    window = float(qs["window"][0])
            except ValueError:
                self._send_json(400, {"error": f"bad window {query!r}"})
                return
            # accept a CycleSampler (ring + burn monitor) or a bare ring
            ring = getattr(timeseries, "ring", timeseries)
            body: Dict[str, object] = {"window_s": window}
            if ring is None:
                body["rows"] = []
                body["error"] = "no timeseries wired (pass timeseries= to serve_obs)"
            else:
                body["capacity"] = getattr(ring, "capacity", 0)
                body["rows"] = ring.rows(window)
            burn = getattr(timeseries, "burn", None)
            if burn is not None:
                body["slo_burn"] = burn.status()
            self._send_json(200, body)
            return
        if path == "/debug/audit":
            try:
                qs = urllib.parse.parse_qs(query)
                if qs.get("n"):
                    int(qs["n"][0])
            except ValueError:
                self._send_json(400, {"error": f"bad n {query!r}"})
                return
            self._send_json(200, {
                "records": [],
                "error": "no audit log wired (pass audit= to serve_obs)",
            })
            return
        if path.startswith("/debug/audit/"):
            corr = path[len("/debug/audit/"):]
            self._send_json(404, {"error": f"no audit record for corr {corr!r}"})
            return
        if path.startswith("/debug/trace/"):
            corr = path[len("/debug/trace/"):]
            trace = tr.export_chrome(corr)
            if not trace["traceEvents"]:
                self._send_json(404, {"error": f"unknown trace {corr!r}",
                                      "known": tr.trace_ids()[-20:]})
                return
            self._send_json(200, trace)
            return
        if path == "/":
            self._send_json(200, {"endpoints": [
                "/metrics", "/healthz", "/readyz",
                "/debug/cycles", "/debug/trace/<corr_id>",
                "/debug/kernels", "/debug/timeseries?window=<s>",
                "/debug/audit?n=<count>", "/debug/audit/<corr_id>",
                "/debug/pool", "/debug/fleet", "/debug/fleet/tenants",
                "/debug/capture",
            ]})
            return
        self._send_json(404, {"error": f"no route {path}"})


def serve_obs(
    host: str = "127.0.0.1",
    port: int = 0,
    registry: Optional[MetricsRegistry] = None,
    flight: Optional[FlightRecorder] = None,
    trace: Optional[Tracer] = None,
    status_fn: Optional[Callable[[], Dict[str, object]]] = None,
    kernel_profiler: Optional[KernelProfiler] = None,
    timeseries=None,
    pool=None,
    replica_id: str = "",
) -> Tuple[ThreadingHTTPServer, threading.Thread, str]:
    """Serve the observability plane; returns (server, thread, base_url).
    ``port=0`` picks a free port (the returned base_url carries the real
    one — callers should log it); ``server.shutdown()`` stops it.  The
    defaults bind the process-wide registry/tracer/profiler, so a bare
    ``serve_obs()`` next to any scheduler run already serves real data.
    ``timeseries`` takes a :class:`utils.timeseries.CycleSampler` (ring +
    burn monitor, the Scheduler's ``timeseries=``) or a bare ring;
    ``pool`` a :class:`rpc.pool.DecisionPool` for ``/debug/pool``;
    ``replica_id`` stamps /healthz + /readyz in multi-replica
    deployments."""
    server = ThreadingHTTPServer((host, port), _ObsHandler)
    server.obs_registry = registry if registry is not None else metrics()  # type: ignore[attr-defined]
    server.obs_flight = flight  # type: ignore[attr-defined]
    server.obs_tracer = trace if trace is not None else tracer()  # type: ignore[attr-defined]
    server.obs_status_fn = status_fn if status_fn is not None else (lambda: {"ready": True})  # type: ignore[attr-defined]
    server.obs_profiler = kernel_profiler if kernel_profiler is not None else profiler()  # type: ignore[attr-defined]
    server.obs_timeseries = timeseries  # type: ignore[attr-defined]
    server.obs_pool = pool  # type: ignore[attr-defined]
    server.obs_replica_id = replica_id  # type: ignore[attr-defined]
    if locking.sanitize_enabled():
        # the obs_* wiring is written once, here, before the serve thread
        # starts; handler threads only read it.  Single-writer mode turns
        # any later rebind from a handler into a sanitizer finding.
        locking.register_guarded(
            None, server,
            (
                "obs_registry", "obs_flight", "obs_tracer",
                "obs_status_fn", "obs_profiler", "obs_timeseries",
                "obs_pool", "obs_replica_id",
            ),
            name="ObsServer",
        )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://{host}:{server.server_address[1]}"
