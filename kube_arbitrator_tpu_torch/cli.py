"""Command line: decide synthetic worlds with the port.

    python -m kube_arbitrator_tpu_torch --tasks 100000 --nodes 10000 \\
        --queues 8 --tasks-per-job 100 --cycles 3 --seed 42 [--device cpu] [--json]
    python -m kube_arbitrator_tpu_torch --tasks 50000 --nodes 5000 \\
        --running-fraction 0.5 --actions reclaim,allocate,backfill,preempt \\
        [--pod-affinity] [--node-order {first_fit,binpack,spread}]
    python -m kube_arbitrator_tpu_torch --tasks 50000 --nodes 5000 --queues 512 \\
        --running-fraction 0.5 --actions reclaim_optimistic,allocate,backfill,preempt
    python -m kube_arbitrator_tpu_torch --tasks 50000 --nodes 5000 \\
        --running-fraction 0.5 --actions reclaim,allocate,backfill,preempt --epochs 5

Each cycle decides a fresh world (seed, seed+1, ...) with the default
tiers (``--node-order`` sets their nodeorder plugin's policy) and the
``--actions`` list (default allocate, backfill), decodes its binds into
(task uid, node name) pairs, and prints the bind and evict counts, the
rounds per action (with the gated rounds of preempt and the reclaim
actions, and the reclaim actions' claim conflicts) and the wall time.
``reclaim_optimistic`` is reclaim through the optimistic engine.  ``--pod-affinity`` labels the
world's nodes with hostname, rack and zone domains and gives its jobs
the pod-(anti-)affinity mix of cache/synth.py.  Building the world and
copying it to the device is set-up and is timed apart from the cycle.

``--epochs E`` (E > 1) serves each world for E epochs through the
scheduler-facing decider (framework.TorchDecider): epoch 1 uploads the
pack in full, and before each later epoch e the seeded 4% of its RUNNING
tasks that ``cache/synth.pick_churn(pack, 0.04, e)`` draws complete, so
only the changed rows reach the resident pack.  Each epoch prints its
upload mode, bytes, upload ms and cycle ms.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .cache.decode import decode_binds
from .cache.synth import build_synthetic_arrays, epoch_stream
from .cache.snapshot import from_numpy
from .device import resolve_device
from .framework import SchedulerConfig, TorchDecider
from .ops.cycle import schedule_cycle
from .ops.ordering import DEFAULT_ACTIONS, NODE_ORDER_POLICIES, with_node_order

CHURN = 0.04  # the reference bench's BENCH_PIPE_CHURN default (bench.py:866)


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
) -> List[Dict]:
    """Serve one synthetic world for ``epochs`` epochs through a
    TorchDecider on ``device``, completing ``CHURN`` of the running tasks
    before each epoch after the first.  One row per epoch: upload mode,
    bytes and ms, cycle ms, decide ms, binds and evicts."""
    arrays, _ = build_synthetic_arrays(tasks, nodes, queues, tasks_per_job, seed,
                                       running_fraction=running_fraction,
                                       fit_fraction=fit_fraction)
    decider = TorchDecider(device)
    conf = SchedulerConfig(actions=tuple(actions), tiers=with_node_order(node_order))
    out = []
    for e, pack, meta in epoch_stream(arrays, epochs, CHURN):
        dec, ms = decider.decide(pack, conf, meta)
        out.append(dict(epoch=e, mode=decider.last_mode, upload_bytes=decider.last_upload_bytes,
                        upload_ms=decider.last_upload_ms, cycle_ms=decider.last_cycle_ms,
                        decide_ms=ms, binds=int(dec.bind_count), evicts=int(dec.evict_count)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_arbitrator_tpu_torch", description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--queues", type=int, default=8)
    ap.add_argument("--tasks-per-job", type=int, default=100)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--running-fraction", type=float, default=0.0,
                    help="fraction of jobs pre-placed RUNNING (the evictive actions' victims)")
    ap.add_argument("--actions", default=",".join(DEFAULT_ACTIONS),
                    help="comma list of actions, e.g. reclaim,allocate,backfill,preempt "
                         "(reclaim_optimistic: reclaim through the optimistic engine)")
    ap.add_argument("--node-order", default="first_fit", choices=NODE_ORDER_POLICIES,
                    help="the nodeorder plugin's policy")
    ap.add_argument("--pod-affinity", action="store_true",
                    help="topology labels and the pod-(anti-)affinity mix of cache/synth.py")
    ap.add_argument("--epochs", type=int, default=1,
                    help="serve each world for this many epochs through the TorchDecider, "
                         f"completing {CHURN:.0%} of its running tasks between epochs")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the GPU)")
    ap.add_argument("--json", action="store_true", help="one JSON object per cycle")
    a = ap.parse_args(argv)
    actions = tuple(x.strip() for x in a.actions.split(",") if x.strip())
    dev = resolve_device(a.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if a.epochs < 1:
        ap.error("--epochs must be at least 1")
    if a.epochs > 1 and a.pod_affinity:
        ap.error("--epochs serves worlds without pod affinity")
    for c in range(a.cycles):
        if a.epochs > 1:
            for row in serve_world(a.tasks, a.nodes, a.epochs, a.queues, a.tasks_per_job,
                                   a.seed + c, running_fraction=a.running_fraction, device=dev,
                                   actions=actions, node_order=a.node_order):
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
                         running_fraction=a.running_fraction, device=dev, actions=actions,
                         node_order=a.node_order, pod_affinity=a.pod_affinity)
        row = dict(
            cycle=c, seed=a.seed + c, device=name, binds=len(r["binds"]),
            evicts=int(r["decisions"].evict_count),
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
