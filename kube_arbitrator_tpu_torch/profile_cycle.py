"""Where a cycle's time goes on the card: one synthetic world decided
under ``torch.profiler``.

    python -m kube_arbitrator_tpu_torch.profile_cycle [--tasks 100000]
        [--nodes 10000] [--seed 42] [--running-fraction 0.0]
        [--actions allocate,backfill] [--node-order first_fit] [--pod-affinity]
        (e.g. --tasks 50000 --nodes 5000 --queues 512 --running-fraction 0.5
         --actions reclaim_optimistic,allocate,backfill,preempt)
        [--out profile_out]

A first cycle (seed - 1) warms up the kernel builds and the allocator;
the profiled cycle then runs alone.  Prints the stage times, the top
operations by device time, the device-busy share of the cycle's wall
time (the union of kernel intervals on the card over the wall clock) and
the count of kernel launches and of the library sort and search calls
(``aten::sort``, ``aten::argsort``, ``aten::searchsorted``; K19 took
over the port's sorts), and writes ``profile_cycle.json`` and a gzipped
Chrome trace to ``--out``.  A last, unprofiled pass runs the same world
action by action under ``torch.cuda.set_sync_debug_mode("warn")`` and
counts each action's host syncs beside its rounds, gated rounds, claim
conflicts and (``reclaim_optimistic``) speculation windows, per round
and per window.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from .cache.snapshot import from_numpy
from .cache.synth import build_synthetic_arrays
from .cli import decide_world
from .ops import kernels
from .ops.cycle import ACTION_KERNELS, open_session
from .ops.ordering import NODE_ORDER_POLICIES, with_node_order


def sync_counts(tasks, nodes, queues, tasks_per_job, seed, running_fraction, actions,
                node_order="first_fit", pod_affinity=False):
    """{action: {syncs, rounds, rounds_gated, claim_conflicts, windows,
    syncs_per_round, syncs_per_window}}: each action of one cycle run
    alone with every synchronising CUDA call reported as a warning
    (windows: the optimistic reclaim engine's; 0 for the others)."""
    arrays, _ = build_synthetic_arrays(tasks, nodes, queues, tasks_per_job, seed,
                                       running_fraction=running_fraction,
                                       pod_affinity=pod_affinity)
    st = from_numpy(arrays, "cuda")
    tiers = with_node_order(node_order)
    sess, state = open_session(st, tiers)
    torch.cuda.synchronize()
    out = {}
    for action in actions:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state = ACTION_KERNELS[action](st, sess, state, tiers)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n = sum(1 for w in caught if "synchroniz" in str(w.message))
        windows = state.windows if action.startswith("reclaim") else 0
        out[action] = dict(
            syncs=n, rounds=state.rounds, rounds_gated=state.rounds_gated,
            claim_conflicts=state.claim_conflicts, windows=windows,
            syncs_per_round=n / max(state.rounds, 1),
            syncs_per_window=n / windows if windows else None,
        )
    return out


LIBRARY_OPS = ("aten::sort", "aten::argsort", "aten::searchsorted")


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_arbitrator_tpu_torch.profile_cycle")
    ap.add_argument("--tasks", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--queues", type=int, default=8)
    ap.add_argument("--tasks-per-job", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--running-fraction", type=float, default=0.0)
    ap.add_argument("--actions", default="allocate,backfill")
    ap.add_argument("--node-order", default="first_fit", choices=NODE_ORDER_POLICIES)
    ap.add_argument("--pod-affinity", action="store_true")
    ap.add_argument("--out", default="profile_out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cycle: needs a CUDA card", file=sys.stderr)
        return 2
    world = dict(tasks=a.tasks, nodes=a.nodes, queues=a.queues, tasks_per_job=a.tasks_per_job,
                 running_fraction=a.running_fraction,
                 actions=tuple(x for x in a.actions.split(",") if x),
                 node_order=a.node_order, pod_affinity=a.pod_affinity)
    decide_world(seed=a.seed - 1, device="cuda", **world)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = decide_world(seed=a.seed, device="cuda", **world)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [
        e for e in prof.events()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = _busy_us((e.time_range.start, e.time_range.end) for e in dev_events) / 1e3
    span_ms = 0.0
    if dev_events:
        span_ms = (max(e.time_range.end for e in dev_events)
                   - min(e.time_range.start for e in dev_events)) / 1e3
    rows = []
    library = dict.fromkeys(LIBRARY_OPS, 0)
    for ev in prof.key_averages():
        if ev.key in library:
            library[ev.key] = ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append(dict(name=ev.key, device_ms=dev_us / 1e3, count=ev.count))
    rows.sort(key=lambda x: -x["device_ms"])
    launches = kernels.counts()
    syncs = sync_counts(seed=a.seed, **world)
    report = dict(
        device=torch.cuda.get_device_name(0), world=dict(seed=a.seed, **world),
        profiled_wall_ms=wall_ms, cycle_ms=r["cycle_ms"], decode_ms=r["decode_ms"],
        stages_ms={k[3:]: v for k, v in r["stats"].items() if k.startswith("ms.")},
        rounds=r["rounds"], device_busy_ms=busy_ms, device_span_ms=span_ms,
        device_kernels=len(dev_events), port_kernel_launches=launches, library_ops=library,
        host_syncs=syncs, top=rows[:30],
    )
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_cycle.json").write_text(json.dumps(report, indent=1))
    prof.export_chrome_trace(str(out / "profile_cycle_trace.json.gz"))
    print(json.dumps({k: v for k, v in report.items() if k != "top"}))
    for row in rows[:15]:
        print(f"{row['device_ms']:10.3f} ms  x{row['count']:<7d} {row['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
