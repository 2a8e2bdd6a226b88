"""Where a cycle's time goes on the card: one synthetic world decided
under ``torch.profiler``.

    python -m kube_arbitrator_tpu_torch.profile_cycle [--tasks 100000]
        [--nodes 10000] [--seed 42] [--out profile_out]

A first cycle (seed - 1) warms up the kernel builds and the allocator;
the profiled cycle then runs alone.  Prints the stage times, the top
operations by device time, the device-busy share of the cycle's wall
time (the union of kernel intervals on the card over the wall clock) and
the count of kernel launches, and writes ``profile_cycle.json`` and a gzipped
Chrome trace to ``--out``.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from .cli import decide_world
from .ops import kernels


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
    ap.add_argument("--out", default="profile_out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cycle: needs a CUDA card", file=sys.stderr)
        return 2
    world = dict(tasks=a.tasks, nodes=a.nodes, queues=a.queues, tasks_per_job=a.tasks_per_job)
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
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append(dict(name=ev.key, device_ms=dev_us / 1e3, count=ev.count))
    rows.sort(key=lambda x: -x["device_ms"])
    report = dict(
        device=torch.cuda.get_device_name(0), world=dict(seed=a.seed, **world),
        profiled_wall_ms=wall_ms, cycle_ms=r["cycle_ms"], decode_ms=r["decode_ms"],
        stages_ms={k[3:]: v for k, v in r["stats"].items() if k.startswith("ms.")},
        rounds=r["rounds"], device_busy_ms=busy_ms, device_span_ms=span_ms,
        device_kernels=len(dev_events), port_kernel_launches=kernels.counts(), top=rows[:30],
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
