"""Command line: run the port's scheduler over a simulated cluster, or
decide synthetic worlds with the port.

    python -m kube_arbitrator_tpu_torch --sim-nodes 100 --sim-jobs 20 \
        --sim-tasks-per-job 50 --sim-queues 4 --sim-seed 0 \
        [--scheduler-conf conf.yaml] [--cycles 5] [--device cpu] [--json]
    python -m kube_arbitrator_tpu_torch --watch-stream stream.jsonl \
        [--enable-leader-election --lock-object-namespace DIR] \
        [--enable-namespace-as-queue] [--schedule-period 1] \
        [--metrics-file metrics.prom] [--cycles 2] [--device cpu] [--json]
    python -m kube_arbitrator_tpu_torch --sim-nodes 100 --arena \
        [--pipeline [--pipeline-ingest-cap 64]] [--arena-verify-every 64] \
        [--obs-port 0 [--obs-host 127.0.0.1]] [--trace-sample-rate 1.0] \
        [--flight-dump-dir DIR --flight-ring 64 --cycle-slo-ms MS] \
        [--profile-kernels] [--profile-dir DIR] [--device cpu]
    python -m kube_arbitrator_tpu_torch --print-version

    python -m kube_arbitrator_tpu_torch --tasks 100000 --nodes 10000 \\
        --queues 8 --tasks-per-job 100 --cycles 3 --seed 42 [--device cpu] [--json]
    python -m kube_arbitrator_tpu_torch --tasks 50000 --nodes 5000 \\
        --running-fraction 0.5 --actions reclaim,allocate,backfill,preempt \\
        [--pod-affinity | --priority-mix] [--node-order {first_fit,binpack,spread}]
        [--fit-fraction 1.2]
    python -m kube_arbitrator_tpu_torch --tasks 50000 --nodes 5000 --queues 512 \\
        --running-fraction 0.5 --actions reclaim_optimistic,allocate,backfill,preempt
    python -m kube_arbitrator_tpu_torch --tasks 50000 --nodes 5000 \\
        --running-fraction 0.5 --actions reclaim,allocate,backfill,preempt --epochs 5

With ``--sim-nodes`` (the reference's simulation mode, its cli.py:276),
``cache/sim.generate_cluster`` builds the cluster and the port's own
``framework.Scheduler`` runs cycles over it: snapshot (with ``--arena``
a ``SnapshotArena``, re-verified every ``--arena-verify-every`` packs;
without it a full rebuild each cycle, as the reference's default is),
``TorchDecider`` (the card unless ``--device cpu``), decode, actuation
and status write-back, up to ``--cycles`` cycles (0 or absent: until a
cycle binds and evicts nothing).  ``--pipeline`` runs the cycles through
the pipelined executor (``Scheduler.run_pipelined``; it implies
``--arena``; ``--pipeline-ingest-cap`` bounds the watch pumps per
in-flight decide).  ``--scheduler-conf`` names a YAML conf (PyYAML is imported
only then).  Each cycle prints its phase times, binds, evicts and upload
mode; the last line sums the cycles, binds and evicts.

With ``--watch-stream`` (the reference's cli.py:203, :414-426) the
recorded apiserver stream (JSONL from ``FakeApiServer.dump_stream`` of
either package) is loaded into a ``cache/fakeapi.FakeApiServer`` and the
same Scheduler runs over a ``cache/live.LiveCache`` on it: list and
watch, binds POSTed and evicts DELETEd into the replayed server,
PodGroup statuses PUT.  ``--enable-leader-election`` gates the cycles on
a ``framework/leader.LeaderElector`` lease at
``{--lock-object-namespace}/{scheduler name}.lock`` (:34-41, :464-470);
``--enable-namespace-as-queue`` makes namespaces the queues;
``--metrics-file`` writes the metrics registry in the Prometheus text
format after the run (:572-576).  These also apply to ``--sim-nodes``.
``--schedule-period`` sets ``ServerOptions.schedule_period_s`` only: the
loop runs its cycles back to back, as the reference's does.
``--scheduler-name`` names the lock and the scheduler, ``--default-queue``
is the queue of jobs that name none, ``--sanitize`` runs under the
concurrency sanitizer (utils/locking.py), ``--print-version`` prints the
version and exits.

The observability planes (the reference's cli.py:59-190): any of
``--obs-port``, ``--flight-dump-dir``, ``--cycle-slo-ms``,
``--profile-kernels`` and ``--starvation-slo-s`` turns on span tracing
(``--trace-sample-rate`` of the cycles), a flight recorder of
``--flight-ring`` cycles dumping into ``--flight-dump-dir`` on an
anomaly (a cycle over ``--cycle-slo-ms`` among them) and the per-cycle
time series with its SLO burn monitor; traced cycles decide through the
staged runner.  ``--profile-kernels`` turns on the kernel profiler
(``/debug/kernels``), ``--profile-dir`` writes a torch.profiler trace of
each cycle, and ``--obs-port`` serves the planes (obs.py) on
``--obs-host``.  ``--starvation-slo-s`` is accepted for the reference's
flag set, but its check belongs to the decision audit plane, which the
port has not ported: it only turns the planes on.

Otherwise each cycle decides a fresh world (seed, seed+1, ...) with the default
tiers (``--node-order`` sets their nodeorder plugin's policy) and the
``--actions`` list (default allocate, backfill), decodes its binds into
(task uid, node name) pairs, and prints the bind and evict counts, the
rounds per action (with the gated rounds of preempt and the reclaim
actions, and the reclaim actions' claim conflicts) and the wall time.
``reclaim_optimistic`` is reclaim through the optimistic engine.
``--json`` adds the evictions by phase (none, preempt phase 1, phase 2,
reclaim).  ``--pod-affinity`` labels the
world's nodes with hostname, rack and zone domains and gives its jobs
the pod-(anti-)affinity mix of cache/synth.py.  ``--priority-mix`` draws
job, group and task priorities 1-3 and leaves a pending tail on half the
running jobs (cache/synth.priority_tables), so preempt evicts in its
phase 2 too.  Building the world and copying it to the device is set-up
and is timed apart from the cycle.

``--epochs E`` (E > 1) serves each world for E epochs through the
scheduler-facing decider (framework.TorchDecider): epoch 1 uploads the
pack in full, and before each later epoch e the seeded 4% of its RUNNING
tasks that ``cache/synth.pick_churn(pack, 0.04, e)`` draws complete, so
only the changed rows reach the resident pack.  Each epoch prints its
upload mode, bytes, upload ms and cycle ms.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .cache.arena import SnapshotArena
from .cache.decode import decode_binds
from .cache.fakeapi import FakeApiServer
from .cache.live import LiveCache
from .cache.sim import generate_cluster
from .cache.synth import build_synthetic_arrays, epoch_stream
from .cache.snapshot import from_numpy
from .device import resolve_device
from .framework import LeaderElector, Scheduler, SchedulerConfig, TorchDecider
from .framework.conf import load_conf_file
from .options import options, set_options
from .utils import locking
from .utils.flightrec import FlightRecorder
from .utils.metrics import metrics
from .utils.profiling import profiler
from .utils.timeseries import CycleSampler
from .utils.tracing import tracer
from .ops.cycle import schedule_cycle
from .ops.ordering import DEFAULT_ACTIONS, NODE_ORDER_POLICIES, with_node_order

CHURN = 0.04  # the reference bench's BENCH_PIPE_CHURN default (bench.py:866)
__version__ = "0.1.0"  # the reference package's version


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decide_world(
    tasks: int,
    nodes: int,
    queues: int = 8,
    tasks_per_job: int = 100,
    seed: int = 42,
    running_fraction: float = 0.0,
    fit_fraction: float = 1.2,
    device=None,
    actions: Tuple[str, ...] = DEFAULT_ACTIONS,
    node_order: str = "first_fit",
    pod_affinity: bool = False,
    priority_mix: bool = False,
) -> Dict:
    """Build one synthetic world, decide it on ``device`` with ``actions``
    under the default tiers with ``node_order``, and decode its binds.
    Returns the decisions, the decoded bind column, the rounds and stage
    times (``stats``) and timings."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    arrays, index = build_synthetic_arrays(
        tasks, nodes, queues, tasks_per_job, seed,
        running_fraction=running_fraction, fit_fraction=fit_fraction, pod_affinity=pod_affinity,
        priority_mix=priority_mix,
    )
    st = from_numpy(arrays, dev)
    _sync(dev)
    t1 = time.perf_counter()
    stats: Dict[str, float] = {}
    dec = schedule_cycle(st, tiers=with_node_order(node_order), actions=tuple(actions),
                         stats=stats)
    _sync(dev)
    t2 = time.perf_counter()
    binds = decode_binds(index, dec)
    pairs = binds.pairs()
    t3 = time.perf_counter()
    return dict(
        pack=st, decisions=dec, binds=binds, pairs=pairs, stats=stats,
        rounds={k: v for k, v in stats.items()
                if k.startswith(("rounds.", "rounds_gated.", "claim_conflicts."))},
        setup_ms=(t1 - t0) * 1e3, cycle_ms=(t2 - t1) * 1e3, decode_ms=(t3 - t2) * 1e3,
    )


def serve_world(
    tasks: int,
    nodes: int,
    epochs: int,
    queues: int = 8,
    tasks_per_job: int = 100,
    seed: int = 42,
    running_fraction: float = 0.0,
    fit_fraction: float = 1.2,
    device=None,
    actions: Tuple[str, ...] = DEFAULT_ACTIONS,
    node_order: str = "first_fit",
    priority_mix: bool = False,
) -> List[Dict]:
    """Serve one synthetic world for ``epochs`` epochs through a
    TorchDecider on ``device``, completing ``CHURN`` of the running tasks
    before each epoch after the first.  One row per epoch: upload mode,
    bytes and ms, cycle ms, decide ms, binds and evicts."""
    arrays, _ = build_synthetic_arrays(tasks, nodes, queues, tasks_per_job, seed,
                                       running_fraction=running_fraction,
                                       fit_fraction=fit_fraction, priority_mix=priority_mix)
    decider = TorchDecider(device)
    conf = SchedulerConfig(actions=tuple(actions), tiers=with_node_order(node_order))
    out = []
    for e, pack, meta in epoch_stream(arrays, epochs, CHURN):
        dec, ms = decider.decide(pack, conf, meta)
        out.append(dict(epoch=e, mode=decider.last_mode, upload_bytes=decider.last_upload_bytes,
                        upload_ms=decider.last_upload_ms, cycle_ms=decider.last_cycle_ms,
                        decide_ms=ms, binds=int(dec.bind_count), evicts=int(dec.evict_count)))
    return out


def serve_backend(
    backend,
    cycles: int = 0,
    config: Optional[SchedulerConfig] = None,
    device=None,
    elector: Optional[LeaderElector] = None,
    arena=True,
    pipeline: bool = False,
    ingest_cap: int = 64,
    on_start=None,
    **planes,
) -> Tuple[Scheduler, List[Dict]]:
    """The port's ``Scheduler(backend, arena=arena, **planes)`` on
    ``device`` (under ``elector`` when given) -> ``run(max_cycles=cycles)``,
    or ``run_pipelined`` with ``pipeline``.  ``planes`` are the
    Scheduler's observability arguments (``flight``, ``cycle_slo_ms``,
    ``timeseries``, ``profile_dir``); ``on_start`` is called with the
    scheduler before its first cycle.  Returns the scheduler and one row
    per completed cycle: its CycleStats, upload mode and bytes included."""
    sched = Scheduler(backend, config=config, decider=TorchDecider(device), arena=arena,
                      elector=elector, **planes)
    if on_start is not None:
        on_start(sched)
    if pipeline:
        sched.run_pipelined(max_cycles=cycles, max_ingest_per_wait=ingest_cap)
    else:
        sched.run(max_cycles=cycles)
    rows = [dict(cycle=i + 1, **dataclasses.asdict(st)) for i, st in enumerate(sched.history)]
    return sched, rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_arbitrator_tpu_torch", description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--queues", type=int, default=8)
    ap.add_argument("--tasks-per-job", type=int, default=100)
    ap.add_argument("--cycles", type=int, default=None,
                    help="worlds to decide (default 3); with --sim-nodes, scheduler cycles "
                         "(default 0: until a cycle binds and evicts nothing)")
    ap.add_argument("--sim-nodes", type=int, default=None,
                    help="run the port's Scheduler over a generated cluster of this many nodes")
    ap.add_argument("--sim-jobs", type=int, default=None, help="with --sim-nodes (default 20)")
    ap.add_argument("--sim-tasks-per-job", type=int, default=None,
                    help="with --sim-nodes (default 50)")
    ap.add_argument("--sim-queues", type=int, default=None, help="with --sim-nodes (default 4)")
    ap.add_argument("--sim-seed", type=int, default=None, help="with --sim-nodes (default 0)")
    ap.add_argument("--scheduler-conf", default=None,
                    help="with --sim-nodes or --watch-stream: the YAML action / tier "
                         "configuration file")
    ap.add_argument("--watch-stream", default=None,
                    help="schedule against a recorded apiserver watch stream (JSONL from "
                         "FakeApiServer.dump_stream) through the live-cluster plane")
    ap.add_argument("--enable-leader-election", action="store_true",
                    help="with --sim-nodes or --watch-stream: gate scheduling on holding "
                         "the leader lease")
    ap.add_argument("--lock-object-namespace", default="",
                    help="directory of the leader-election lock file")
    ap.add_argument("--schedule-period", type=float, default=1.0,
                    help="sets ServerOptions.schedule_period_s; the loop runs its cycles "
                         "back to back")
    ap.add_argument("--enable-namespace-as-queue", action="store_true",
                    help="treat namespaces as queues instead of Queue objects")
    ap.add_argument("--metrics-file", default="",
                    help="write Prometheus-text metrics here after the run")
    ap.add_argument("--scheduler-name", default="kube-batch", help="scheduler identity")
    ap.add_argument("--default-queue", default="default", help="queue for jobs that name none")
    ap.add_argument("--print-version", action="store_true")
    ap.add_argument("--sanitize", action="store_true",
                    help="run under the concurrency sanitizer shim (witnessed locks, "
                         "guarded-state checks; same as KAT_SANITIZE=1)")
    # the incremental snapshot plane and the pipelined executor
    ap.add_argument("--arena", action="store_true",
                    help="with --sim-nodes or --watch-stream: maintain the pack incrementally "
                         "(SnapshotArena) instead of a full rebuild per cycle")
    ap.add_argument("--arena-verify-every", type=int, default=64, metavar="N",
                    help="with --arena: every N-th pack rebuilt from scratch and compared "
                         "(0 = never)")
    ap.add_argument("--pipeline", action="store_true",
                    help="run cycles through the pipelined executor: one epoch decides on a "
                         "worker thread while the next ingests, with commit-time "
                         "revalidation (implies --arena)")
    ap.add_argument("--pipeline-ingest-cap", type=int, default=64, metavar="N",
                    help="with --pipeline: watch pumps per in-flight decide before ingest "
                         "blocks (backpressure; default 64)")
    # the observability planes
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of each cycle into this directory")
    ap.add_argument("--profile-kernels", action="store_true",
                    help="kernel cost attribution: staged cycles, measured stage times and "
                         "profiled device time per stage and shape at /debug/kernels")
    ap.add_argument("--trace-sample-rate", type=float, default=1.0, metavar="RATE",
                    help="fraction of cycles span-traced (deterministic stride; default 1.0)")
    ap.add_argument("--flight-dump-dir", default="",
                    help="flight recorder: dump the last --flight-ring cycles' digests here "
                         "as JSON whenever an anomaly fires")
    ap.add_argument("--flight-ring", type=int, default=64,
                    help="flight-recorder ring capacity in cycles (default 64)")
    ap.add_argument("--cycle-slo-ms", type=float, default=0.0,
                    help="cycle-latency SLO in ms: a slower cycle dumps the flight ring, and "
                         "the time series burns its error budget over it (0 = off)")
    ap.add_argument("--starvation-slo-s", type=float, default=0.0,
                    help="accepted for the reference's flag set; its check waits for the "
                         "decision audit plane (it turns the observability planes on)")
    ap.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="serve the observability plane on this port (0 = ephemeral)")
    ap.add_argument("--obs-host", default="127.0.0.1",
                    help="bind address for --obs-port (default 127.0.0.1)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--running-fraction", type=float, default=0.0,
                    help="fraction of jobs pre-placed RUNNING (the evictive actions' victims)")
    ap.add_argument("--fit-fraction", type=float, default=1.2,
                    help="node capacity as a multiple of the total demand")
    ap.add_argument("--actions", default=",".join(DEFAULT_ACTIONS),
                    help="comma list of actions, e.g. reclaim,allocate,backfill,preempt "
                         "(reclaim_optimistic: reclaim through the optimistic engine)")
    ap.add_argument("--node-order", default="first_fit", choices=NODE_ORDER_POLICIES,
                    help="the nodeorder plugin's policy")
    ap.add_argument("--pod-affinity", action="store_true",
                    help="topology labels and the pod-(anti-)affinity mix of cache/synth.py")
    ap.add_argument("--priority-mix", action="store_true",
                    help="priorities 1-3 and pending tails on running jobs (cache/synth.py)")
    ap.add_argument("--epochs", type=int, default=1,
                    help="serve each world for this many epochs through the TorchDecider, "
                         f"completing {CHURN:.0%} of its running tasks between epochs")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the GPU)")
    ap.add_argument("--json", action="store_true", help="one JSON object per cycle")
    a = ap.parse_args(argv)
    if a.print_version:
        print(f"kube-arbitrator-tpu {__version__}")
        return 0
    if a.sanitize:
        # before any plane constructs its locks
        locking.force_sanitize(True)
    sim_flags = (a.sim_jobs, a.sim_tasks_per_job, a.sim_queues, a.sim_seed)
    if a.sim_nodes is None and any(f is not None for f in sim_flags):
        ap.error("--sim-jobs, --sim-tasks-per-job, --sim-queues and --sim-seed need --sim-nodes")
    if a.sim_nodes is not None and a.watch_stream is not None:
        ap.error("--sim-nodes and --watch-stream exclude each other")
    loop = a.sim_nodes is not None or a.watch_stream is not None
    obs_enabled = bool(a.obs_port is not None or a.flight_dump_dir or a.cycle_slo_ms
                       or a.profile_kernels or a.starvation_slo_s)
    if not loop and (a.scheduler_conf or a.enable_leader_election
                     or a.enable_namespace_as_queue or a.metrics_file or a.arena
                     or a.pipeline or a.profile_dir or obs_enabled):
        ap.error("--scheduler-conf, --enable-leader-election, --enable-namespace-as-queue, "
                 "--metrics-file, --arena, --pipeline, --profile-dir and the observability "
                 "flags need --sim-nodes or --watch-stream")
    actions = tuple(x.strip() for x in a.actions.split(",") if x.strip())
    if loop:
        # CheckOptionOrDie before anything touches the device
        # (server.go:58-66)
        opts = dataclasses.replace(
            options(), scheduler_name=a.scheduler_name, default_queue=a.default_queue,
            schedule_period_s=a.schedule_period,
            namespace_as_queue=a.enable_namespace_as_queue,
            scheduler_conf=a.scheduler_conf or "",
            enable_leader_election=a.enable_leader_election,
            lock_object_namespace=a.lock_object_namespace,
        )
        try:
            opts.check()
        except ValueError as e:
            ap.error(str(e))
        set_options(opts)
    dev = resolve_device(a.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if loop:
        config = load_conf_file(a.scheduler_conf) if a.scheduler_conf else None
        elector = None
        if opts.enable_leader_election:
            elector = LeaderElector(
                lock_path=f"{opts.lock_object_namespace}/{opts.scheduler_name}.lock",
                identity=opts.scheduler_name,
            )
        if a.watch_stream is not None:
            try:
                api = FakeApiServer.from_stream(FakeApiServer.load_stream(a.watch_stream))
            except (OSError, ValueError, KeyError) as e:
                print(f"error: invalid watch stream {a.watch_stream}: {e}", file=sys.stderr)
                return 1
            backend = LiveCache(api)
        else:
            backend = generate_cluster(
                num_nodes=a.sim_nodes, num_jobs=20 if a.sim_jobs is None else a.sim_jobs,
                tasks_per_job=50 if a.sim_tasks_per_job is None else a.sim_tasks_per_job,
                num_queues=4 if a.sim_queues is None else a.sim_queues, seed=a.sim_seed or 0)
        planes = dict(profile_dir=a.profile_dir or None)
        if obs_enabled:
            tracer().enable()
            tracer().sample_rate = a.trace_sample_rate
            flight = FlightRecorder(capacity=a.flight_ring, dump_dir=a.flight_dump_dir or None)
            planes.update(flight=flight, cycle_slo_ms=a.cycle_slo_ms or None,
                          timeseries=CycleSampler(slo_ms=a.cycle_slo_ms or None, flight=flight))
        if a.profile_kernels:
            profiler().enable()
        servers, on_start = [], None
        if a.obs_port is not None:
            def on_start(sched):
                from .obs import scheduler_status_fn, serve_obs

                server, _thread, url = serve_obs(
                    host=a.obs_host, port=a.obs_port, flight=planes.get("flight"),
                    status_fn=scheduler_status_fn(sched), timeseries=planes.get("timeseries"))
                servers.append(server)
                print(f"observability plane on {url}", file=sys.stderr, flush=True)

        arena = (SnapshotArena(backend, verify_every=a.arena_verify_every)
                 if a.arena or a.pipeline else None)
        try:
            sched, rows = serve_backend(backend, a.cycles or 0, config, dev, elector, arena=arena,
                                        pipeline=a.pipeline, ingest_cap=a.pipeline_ingest_cap,
                                        on_start=on_start, **planes)
        finally:
            for server in servers:
                server.shutdown()
                server.server_close()
        for row in rows:
            if a.json:
                print(json.dumps(dict(row, device=name)), flush=True)
            else:
                print(f"cycle {row['cycle']} on {name}: {row['binds']} binds, {row['evicts']} "
                      f"evicts, {row['pending_before']} pending; snapshot "
                      f"{row['snapshot_ms']:.1f} ms, upload {row['upload_mode']} "
                      f"{row['upload_bytes']} bytes in {row['upload_ms']:.1f} ms, kernel "
                      f"{row['kernel_ms']:.1f} ms, decode {row['decode_ms']:.1f} ms, close "
                      f"{row['close_ms']:.1f} ms, actuate {row['actuate_ms']:.1f} ms, cycle "
                      f"{row['cycle_ms']:.1f} ms", flush=True)
        print(json.dumps(dict(cycles=len(rows), binds=sum(r["binds"] for r in rows),
                              evicts=sum(r["evicts"] for r in rows))), flush=True)
        if a.metrics_file:
            with open(a.metrics_file, "w") as f:
                f.write(metrics().render())
        return 0
    if a.cycles is None:
        a.cycles = 3
    if a.epochs < 1:
        ap.error("--epochs must be at least 1")
    if a.epochs > 1 and a.pod_affinity:
        ap.error("--epochs serves worlds without pod affinity")
    for c in range(a.cycles):
        if a.epochs > 1:
            for row in serve_world(a.tasks, a.nodes, a.epochs, a.queues, a.tasks_per_job,
                                   a.seed + c, running_fraction=a.running_fraction,
                                   fit_fraction=a.fit_fraction, device=dev,
                                   actions=actions, node_order=a.node_order,
                                   priority_mix=a.priority_mix):
                row = dict(cycle=c, seed=a.seed + c, device=name, **row)
                if a.json:
                    print(json.dumps(row), flush=True)
                else:
                    print(f"world {c} seed {a.seed + c} epoch {row['epoch']} on {name}: upload "
                          f"{row['mode']} {row['upload_bytes']} bytes in {row['upload_ms']:.1f} "
                          f"ms, cycle {row['cycle_ms']:.1f} ms, decide {row['decide_ms']:.1f} ms, "
                          f"{row['binds']} binds, {row['evicts']} evicts", flush=True)
            continue
        r = decide_world(a.tasks, a.nodes, a.queues, a.tasks_per_job, a.seed + c,
                         running_fraction=a.running_fraction, fit_fraction=a.fit_fraction,
                         device=dev, actions=actions,
                         node_order=a.node_order, pod_affinity=a.pod_affinity,
                         priority_mix=a.priority_mix)
        dec = r["decisions"]
        row = dict(
            cycle=c, seed=a.seed + c, device=name, binds=len(r["binds"]),
            evicts=int(dec.evict_count),
            evicts_by_phase=torch.bincount(dec.evict_phase[dec.evict_mask].cpu().long(),
                                           minlength=4).tolist(),
            dense_fallback=r["binds"].overflowed, rounds=r["rounds"],
            stages_ms={k[3:]: v for k, v in r["stats"].items() if k.startswith("ms.")},
            cycle_ms=r["cycle_ms"], decode_ms=r["decode_ms"], setup_ms=r["setup_ms"],
        )
        if a.json:
            print(json.dumps(row), flush=True)
        else:
            print(
                f"cycle {c} seed {a.seed + c} on {name}: {row['binds']} binds, "
                f"{row['evicts']} evicts, "
                f"rounds {r['rounds']}, cycle {r['cycle_ms']:.1f} ms, "
                f"decode {r['decode_ms']:.1f} ms", flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
