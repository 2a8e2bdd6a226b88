"""The port's observability planes held against the JAX package's, on the
CPU: the tracer (utils/tracing.py), the flight recorder
(utils/flightrec.py), the per-cycle sampler (utils/timeseries.CycleSampler),
the served plane (obs.py), the metric families the planes emit, and the
command line's new flags.

* The same spans under an injected clock give equal ``export_chrome``
  output, trace ids, links and eviction; the same cycle records give
  equal flight rings and dump files.
* The same CycleStats sequence and counter increments give equal ring
  rows, burn status, fired pairs and ``slo_burn`` anomalies (the port's
  ``retraces`` column reads its kernel-build counter where the
  reference's reads XLA's retraces).
* Every route of the port's obs server answers with the reference's
  status code and JSON keys, the routes of the planes the port has not
  ported included.
* The command line's ``--pipeline`` / ``--arena`` / observability flags
  in a subprocess that cannot import JAX or the reference give the
  reference CLI's ``--json`` totals, and leave their flight dumps,
  profiles and metric families.
"""
import contextlib
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

import kube_arbitrator_tpu.obs as ref_obs
import kube_arbitrator_tpu.utils.flightrec as ref_flight
import kube_arbitrator_tpu.utils.timeseries as ref_ts
import kube_arbitrator_tpu.utils.tracing as ref_tracing
import kube_arbitrator_tpu_torch.obs as port_obs
import kube_arbitrator_tpu_torch.utils.flightrec as port_flight
import kube_arbitrator_tpu_torch.utils.timeseries as port_ts
import kube_arbitrator_tpu_torch.utils.tracing as port_tracing
from kube_arbitrator_tpu.utils.metrics import METRIC_HELP as REF_HELP
from kube_arbitrator_tpu.utils.metrics import MetricsRegistry as RefRegistry
from kube_arbitrator_tpu.utils.metrics import metrics as ref_metrics
from kube_arbitrator_tpu.utils.profiling import KernelProfiler as RefProfiler
from kube_arbitrator_tpu_torch.utils.metrics import METRIC_HELP as PORT_HELP
from kube_arbitrator_tpu_torch.utils.metrics import MetricsRegistry as PortRegistry
from kube_arbitrator_tpu_torch.utils.metrics import metrics as port_metrics
from kube_arbitrator_tpu_torch.utils.profiling import KernelProfiler as PortProfiler

REPO = Path(__file__).resolve().parent.parent


class Clock:
    """time.time / time.perf_counter stand-in: each read moves 0.25 s."""

    def __init__(self):
        self.t = 1000.0

    def _tick(self):
        self.t += 0.25
        return self.t

    time = perf_counter = _tick


def _spans(mod):
    tr = mod.Tracer(max_traces=3, enabled=True, sample_rate=0.5)
    sampled = [tr.corr_for_cycle(s) is not None for s in range(1, 9)]
    with tr.activate("c1", component="scheduler"):
        with tr.span("cycle", seq=1) as sp:
            with tr.span("snapshot"):
                pass
            sp.note(binds=3)
            tr.record_span("kernel.allocate", 100.0, 0.25)
        try:
            with tr.span("decide", tasks=7):
                raise ValueError("boom")
        except ValueError:
            pass
    with tr.activate("c2", component="pool"):
        with tr.span("pool_batch"):
            pass
    tr.link("c1", "c2")
    with tr.span("outside"):  # no active corr: nothing recorded
        pass
    first = tr.export_chrome("c1")
    for i in range(3, 6):  # evicts c1 and its link
        with tr.activate(f"c{i}"):
            with tr.span("x"):
                pass
    return dict(sampled=sampled, first=first, ids=tr.trace_ids(),
                c2=tr.export_chrome("c2", follow_links=False), c1=tr.export_chrome("c1"),
                links=tr.links("c1"), spans=[s.to_dict() for s in tr.spans("c5")])


def test_tracer_export_equals_reference(monkeypatch):
    out = {}
    for name, mod in (("ref", ref_tracing), ("port", port_tracing)):
        monkeypatch.setattr(mod, "time", Clock())
        out[name] = _spans(mod)
    assert out["port"] == out["ref"]
    assert out["port"]["sampled"] == [False, True] * 4
    names = [e["name"] for e in out["port"]["first"]["traceEvents"]]
    assert names[:5] == ["snapshot", "kernel.allocate", "cycle", "decide", "pool_batch"]
    assert port_tracing.tracer() is port_tracing.tracer()


def test_flight_recorder_equals_reference(monkeypatch, tmp_path):
    out = {}
    for name, mod, reg in (("ref", ref_flight, ref_metrics), ("port", port_flight, port_metrics)):
        monkeypatch.setattr(mod, "time", Clock())
        reg().reset()
        fr = mod.FlightRecorder(capacity=2, dump_dir=str(tmp_path / name))
        for seq in (1, 2, 3):
            fr.record(mod.CycleRecord(seq=seq, corr_id=f"c{seq}", ts=10.0 * seq,
                                      stats={"cycle_ms": 5.0 * seq},
                                      digests={"binds": seq}, spans=[]))
        path = fr.anomaly("slo_breach", detail="cycle 3 took 15.0 ms")
        none = mod.FlightRecorder(capacity=2).anomaly("leader_lost")
        out[name] = dict(entries=fr.entries(), last=fr.last().to_dict(), none=none,
                         file=os.path.basename(path), dump=json.loads(Path(path).read_text()),
                         counters={k: v for k, v in reg()._counters.items()})
        reg().reset()
    assert out["port"] == out["ref"]
    assert out["port"]["dump"]["cycles"][-1]["seq"] == 3


def _sampler(mod, reg_cls, flight_mod, clock, tmp):
    reg = reg_cls()
    flight = flight_mod.FlightRecorder(capacity=4, dump_dir=str(tmp))
    ring = mod.TimeSeriesRing(capacity=64, now_fn=lambda: clock[0])
    windows = ((20.0, 5.0, 2.0), (60.0, 20.0, 1.5))
    return reg, mod.CycleSampler(ring=ring, registry=reg, slo_ms=100.0, budget=0.25,
                                 windows=windows, flight=flight)


def test_cycle_sampler_equals_reference(monkeypatch, tmp_path):
    clock = [1000.0]
    monkeypatch.setattr(ref_flight, "time", Clock())
    monkeypatch.setattr(port_flight, "time", Clock())
    ref = _sampler(ref_ts, RefRegistry, ref_flight, clock, tmp_path / "ref")
    port = _sampler(port_ts, PortRegistry, port_flight, clock, tmp_path / "port")
    fired_any = False
    for i in range(24):
        clock[0] += 1.0
        stats = NS(cycle_ms=40.0 + (200.0 if 8 <= i < 18 else 0.0), binds=i, evicts=i % 3,
                   pending_before=100 - i, snapshot_ms=1.0, upload_ms=2.0, kernel_ms=30.0,
                   decode_ms=0.5, close_ms=0.25, actuate_ms=0.75, transport_ms=0.0,
                   capture_ms=0.0)
        fired = []
        for (reg, sampler), retraces in ((ref, "xla_retraces_total"),
                                         (port, "kernel_builds_total")):
            if i % 4 == 0:
                reg.counter_add("device_upload_bytes_total", 100 * i, labels={"mode": "delta"})
                reg.counter_add("pipeline_discards_total", labels={"reason": "task_gone"})
            if i == 5:
                reg.counter_add(retraces, labels={"fn": "allocate"})
                reg.counter_add("turn_batch_fallback_total",
                                labels={"action": "preempt", "reason": "pod_affinity"})
            reg.gauge_set("pipeline_stage_occupancy", 0.125 * (i % 5), labels={"stage": "decide"})
            fired.append(sampler.on_cycle(stats, {"allocate": 20.0}, {"allocate": 3,
                                                                      "preempt:gated": 1}))
        assert fired[0] == fired[1]
        fired_any = fired_any or bool(fired[1])
        assert ref[1].ring.rows() == port[1].ring.rows()
        assert ref[1].burn.status() == port[1].burn.status()
    assert fired_any
    assert sorted(os.listdir(tmp_path / "ref")) == sorted(os.listdir(tmp_path / "port"))
    for family in ("slo_burn_rate", "slo_burn_alerts_total"):
        assert ref[0].gauge_values(family) == port[0].gauge_values(family)
        assert ref[0].counter_total(family) == port[0].counter_total(family)
    with pytest.raises(NotImplementedError):
        port_ts.CycleSampler(skew_monitor=object())


class _FakeProfile:
    """torch.profiler.profile's stand-in: its events are the scripted
    device events of the pass, spins included."""

    def __init__(self, names, **_kw):
        self._names = names

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        import torch

        # listed out of time order, as nothing promises that order
        return [NS(name=n, device_type=torch.autograd.DeviceType.CUDA,
                   time_range=NS(start=10 * i, end=10 * i + 1, elapsed_us=lambda: 1000.0))
                for i, n in reversed(list(enumerate(self._names)))]


S = "spin_kernel"


@pytest.mark.parametrize("lead, names, whole, lead_after, trail_after", [
    (1, [S, "admit", "compact", S], True, 256, 256),
    (3, [S, "admit", "compact", S], True, 260, 256),  # 2 leading spins lost
    (1, ["admit", "compact", S], False, 4, 1),       # the first records lost
    (1, [S, "admit", "compact"], False, 1, 4),       # the last records lost
    (1, [S], False, 4, 4),                           # all but one spin lost
    (1, [], False, 4, 4),                            # all lost
    (1, [S, "admit", S], False, 1, 1),               # fewer than the port launched
])
def test_profiled_pass_with_lost_records_is_taken_again(monkeypatch, lead, names, whole,
                                                        lead_after, trail_after):
    """A card pass is kept only when spins are left before and after its
    other device records and those cover the port kernels the stage
    launched; each end's spin count grows with the records lost there; a
    lost pass is counted, shown as ``lost_passes`` and taken at the next
    run."""
    import torch
    import torch.profiler

    from kube_arbitrator_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "_sleep", lambda _cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_a: None)
    script = list(names)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _FakeProfile(script, **kw))
    prof = PortProfiler(now_fn=lambda: 5.0)
    prof.enable()
    prof.lead_spins = lead
    prof.trail_spins = 1
    card = torch.device("cuda")
    lost0 = port_metrics().counter_value("kernel_profile_passes_lost_total",
                                         labels={"stage": "commit"})
    kernels.reset_counts()
    try:
        with prof.estimate_scope("K", "commit", card):
            kernels.KERNELS["admit_chunk"].launches += 1
            kernels.KERNELS["stable_compact"].launches += 1
    finally:
        kernels.reset_counts()
    entry = prof.table()["shapes"]["K"]["commit"]
    lost = port_metrics().counter_value("kernel_profile_passes_lost_total",
                                        labels={"stage": "commit"}) - lost0
    assert (prof.lead_spins, prof.trail_spins) == (lead_after, trail_after)
    if whole:
        assert entry == {"estimate": {"device": "cuda", "profiled_ms": entry["estimate"]["profiled_ms"],
                                      "device_ms": 2.0, "launches": 2, "records_lost": lead - 1,
                                      "estimated_at": 5.0},
                         "device_ms": 2.0, "launches": 2}
        assert lost == 0
    else:
        assert entry == {"lost_passes": 1} and lost == 1
        # the next run at the shape profiles the stage again
        script[:] = [S, "admit", S]
        with prof.estimate_scope("K", "commit", card):
            kernels.KERNELS["admit_chunk"].launches += 1
        kernels.reset_counts()
        entry = prof.table()["shapes"]["K"]["commit"]
        assert entry["lost_passes"] == 1 and entry["launches"] == 1
    # taken once a shape: a later run is not profiled
    assert isinstance(prof.estimate_scope("K", "commit", card), contextlib.nullcontext)
    prof.enable(False)


def test_metric_families_match_reference():
    """Every family the port's new planes emit carries the reference's
    help text, except the port's kernel-build families."""
    own = {"kernel_builds_total", "kernel_build_seconds", "kernel_profile_passes_lost_total"}
    new = {"turn_batch_fallback_total", "decode_overflow_total", "decode_path_total",
           "snapshot_delta_rows", "snapshot_full_rebuilds_total", "device_upload_bytes_total",
           "pipeline_cycle_period_seconds", "pipeline_stage_busy_seconds",
           "pipeline_stage_occupancy", "pipeline_discards_total", "pipeline_backpressure_total",
           "flight_anomalies_total", "flight_dumps_total", "obs_requests_total"}
    for family in new:
        assert PORT_HELP[family] == REF_HELP[family], family
    assert own <= set(PORT_HELP) and not own & set(REF_HELP)


ROUTES = ("/", "/metrics", "/healthz", "/readyz", "/debug/cycles", "/debug/trace/c1",
          "/debug/trace/nope", "/debug/kernels", "/debug/timeseries",
          "/debug/timeseries?window=30", "/debug/timeseries?window=x", "/debug/audit",
          "/debug/audit?n=x", "/debug/audit/c1", "/debug/pool", "/debug/fleet",
          "/debug/fleet/tenants", "/debug/capture", "/debug/whatif", "/nope")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _serve(obs, tracing, flight_mod, ts, reg_cls, prof_cls):
    reg = reg_cls()
    reg.counter_add("cycles_total")
    tr = tracing.Tracer(enabled=True)
    with tr.activate("c1"):
        with tr.span("cycle"):
            pass
    flight = flight_mod.FlightRecorder(capacity=4)
    flight.record(flight_mod.CycleRecord(seq=1, corr_id="c1", ts=1.0))
    sampler = ts.CycleSampler(registry=reg, slo_ms=50.0)
    return obs.serve_obs(port=0, registry=reg, flight=flight, trace=tr,
                         status_fn=lambda: {"ready": False, "leader": None, "cycles": 0,
                                            "last_cycle_age_s": None},
                         kernel_profiler=prof_cls(), timeseries=sampler, replica_id="r0")


def test_obs_routes_answer_as_the_reference():
    servers = {name: _serve(*args) for name, args in (
        ("ref", (ref_obs, ref_tracing, ref_flight, ref_ts, RefRegistry, RefProfiler)),
        ("port", (port_obs, port_tracing, port_flight, port_ts, PortRegistry, PortProfiler)),
    )}
    try:
        for route in ROUTES:
            got = {}
            for name, (_server, _thread, url) in servers.items():
                code, ctype, body = _get(url + route)
                keys = sorted(json.loads(body)) if ctype == "application/json" else None
                got[name] = (code, ctype, keys)
            assert got["port"] == got["ref"], route
        metrics_text = _get(servers["port"][2] + "/metrics")[2].decode()
        assert "kube_arbitrator_tpu_obs_requests_total" in metrics_text
    finally:
        for server, _thread, _url in servers.values():
            server.shutdown()
            server.server_close()


def test_obs_pool_route_serves_the_port_pool():
    from kube_arbitrator_tpu_torch.rpc import DecisionPool

    pool = DecisionPool(replicas=1, device="cpu")
    server, _thread, url = port_obs.serve_obs(port=0, registry=PortRegistry(), pool=pool)
    try:
        code, _, body = _get(url + "/debug/pool")
        assert code == 200 and json.loads(body) == json.loads(json.dumps(pool.status()))
        code, _, body = _get(url + "/healthz")
        assert code == 200 and json.loads(body)["platform"] in ("cpu", "gpu")
    finally:
        server.shutdown()
        server.server_close()
        pool.close()


SIM = ["--sim-nodes", "12", "--sim-jobs", "8", "--sim-tasks-per-job", "5", "--sim-queues", "3",
       "--cycles", "4", "--json"]
PLANES = ["--pipeline", "--pipeline-ingest-cap", "8", "--arena-verify-every", "1",
          "--obs-port", "0", "--trace-sample-rate", "0.5", "--flight-ring", "8",
          "--cycle-slo-ms", "0.001", "--profile-kernels", "--scheduler-name", "kb2",
          "--default-queue", "default", "--starvation-slo-s", "60"]


def test_cli_planes_jax_free_equal_reference_totals(tmp_path, capsys):
    from kube_arbitrator_tpu.cli import main as ref_main
    from kube_arbitrator_tpu.utils.profiling import profiler as ref_profiler
    from kube_arbitrator_tpu.utils.tracing import tracer as ref_tracer

    try:
        assert ref_main(SIM + PLANES + ["--flight-dump-dir", str(tmp_path / "ref")]) == 0
    finally:
        ref_tracer().enable(False)
        ref_profiler().enable(False)
        ref_metrics().reset()
    ref_last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kube_arbitrator_tpu'] = None\n"
        "from kube_arbitrator_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None and "
        "(k == 'jax' or k.startswith(('jax.', 'kube_arbitrator_tpu.'))))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, *SIM, *PLANES, "--sanitize", "--device", "cpu",
         "--flight-dump-dir", str(tmp_path / "port"), "--profile-dir", str(tmp_path / "prof"),
         "--metrics-file", str(tmp_path / "m.prom")],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    last = rows[-1]
    assert {k: last[k] for k in ("cycles", "binds", "evicts")} == ref_last
    assert last["binds"] > 0
    assert "observability plane on http://127.0.0.1:" in out.stderr
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "prof"))[0] == "step-000001.pt.trace.json"
    text = (tmp_path / "m.prom").read_text()
    for family in ("pipeline_cycle_period_seconds", "pipeline_stage_occupancy",
                   "kernel_action_duration_seconds", "flight_anomalies_total",
                   "snapshot_full_rebuilds_total"):
        assert f"kube_arbitrator_tpu_{family}" in text, family
    ver = subprocess.run([sys.executable, "-m", "kube_arbitrator_tpu_torch", "--print-version"],
                         capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env)
    assert ref_main(["--print-version"]) == 0
    assert ver.stdout == capsys.readouterr().out
    bad = subprocess.run([sys.executable, "-m", "kube_arbitrator_tpu_torch", "--pipeline",
                          "--tasks", "64", "--nodes", "16", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env)
    assert bad.returncode != 0 and "need --sim-nodes or --watch-stream" in bad.stderr
