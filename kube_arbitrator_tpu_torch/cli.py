"""Command line: decide synthetic worlds with the port.

    python -m kube_arbitrator_tpu_torch --tasks 100000 --nodes 10000 \\
        --queues 8 --tasks-per-job 100 --cycles 3 --seed 42 [--device cpu] [--json]

Each cycle decides a fresh world (seed, seed+1, ...) with the default
tiers and actions (allocate, backfill), decodes its binds into
(task uid, node name) pairs, and prints the bind count, the rounds per
action and the wall time.  Building the world and copying it to the
device is set-up and is timed apart from the cycle.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from .cache.decode import decode_binds
from .cache.synth import build_synthetic_arrays
from .cache.snapshot import from_numpy
from .device import resolve_device
from .ops.cycle import schedule_cycle


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
) -> Dict:
    """Build one synthetic world, decide it on ``device`` and decode its
    binds.  Returns the decisions, the decoded bind column, the rounds and
    stage times (``stats``) and timings."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    arrays, index = build_synthetic_arrays(
        tasks, nodes, queues, tasks_per_job, seed,
        running_fraction=running_fraction, fit_fraction=fit_fraction,
    )
    st = from_numpy(arrays, dev)
    _sync(dev)
    t1 = time.perf_counter()
    stats: Dict[str, float] = {}
    dec = schedule_cycle(st, stats=stats)
    _sync(dev)
    t2 = time.perf_counter()
    binds = decode_binds(index, dec)
    pairs = binds.pairs()
    t3 = time.perf_counter()
    return dict(
        pack=st, decisions=dec, binds=binds, pairs=pairs, stats=stats,
        rounds={k: v for k, v in stats.items() if k.startswith("rounds.")},
        setup_ms=(t1 - t0) * 1e3, cycle_ms=(t2 - t1) * 1e3, decode_ms=(t3 - t2) * 1e3,
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_arbitrator_tpu_torch", description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--queues", type=int, default=8)
    ap.add_argument("--tasks-per-job", type=int, default=100)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the GPU)")
    ap.add_argument("--json", action="store_true", help="one JSON object per cycle")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for c in range(a.cycles):
        r = decide_world(a.tasks, a.nodes, a.queues, a.tasks_per_job, a.seed + c, device=dev)
        row = dict(
            cycle=c, seed=a.seed + c, device=name, binds=len(r["binds"]),
            dense_fallback=r["binds"].overflowed, rounds=r["rounds"],
            stages_ms={k[3:]: v for k, v in r["stats"].items() if k.startswith("ms.")},
            cycle_ms=r["cycle_ms"], decode_ms=r["decode_ms"], setup_ms=r["setup_ms"],
        )
        if a.json:
            print(json.dumps(row), flush=True)
        else:
            print(
                f"cycle {c} seed {a.seed + c} on {name}: {row['binds']} binds, "
                f"rounds {r['rounds']}, cycle {r['cycle_ms']:.1f} ms, "
                f"decode {r['decode_ms']:.1f} ms", flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
