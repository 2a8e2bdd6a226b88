"""Time the port's cycle on two or more trees in turns, on one card.

    python -m kube_arbitrator_tpu_torch.cycle_turns --parent DIR [--order PCCPCP] \\
        [--tree X=DIR2 ...] \\
        [--worlds allocate,evictive,pa_evict,binpack,q512_evict,priority_mix,serving] \\
        [--cycles N] [--out FILE]

DIR is a second checkout of the repository (for example the parent
commit, unpacked with ``git archive``); each ``--tree X=DIR2`` names one
more, under the letter X (for example a tree with one part of a change
reverted).  For each letter of ``--order`` (P: DIR, C: this tree, X:
DIR2) and each world, one process runs the port's CLI
(``python -m kube_arbitrator_tpu_torch ... --json``) from that tree and
decides ``cycles`` fresh worlds (seeds seed, seed + 1, ...; ``--cycles``
sets their number for every world).  The first
cycle of a process pays for loading the kernels and warming the card, so
only the later ("warm") cycles are compared; in the ``serving`` world a
cycle is a world served five epochs, and its delta epochs' upload times
are summarised too.  Prints one JSON line per
process and, last, per world and tree the median and range of the warm
cycles' wall time and of each stage.  Needs the GPU, as the CLI does.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]

# the worlds of PERF.md section 4, as CLI arguments
WORLDS = {
    "allocate": ["--tasks", "100000", "--nodes", "10000", "--cycles", "4", "--seed", "42"],
    "evictive": ["--tasks", "50000", "--nodes", "5000", "--running-fraction", "0.5",
                 "--actions", "reclaim,allocate,backfill,preempt", "--cycles", "3",
                 "--seed", "42"],
    "pa_evict": ["--tasks", "50000", "--nodes", "5000", "--running-fraction", "0.5",
                 "--actions", "reclaim,allocate,backfill,preempt", "--pod-affinity",
                 "--cycles", "3", "--seed", "42"],
    "binpack": ["--tasks", "100000", "--nodes", "10000", "--node-order", "binpack",
                "--cycles", "3", "--seed", "42"],
    # chip_smoke.py phase 6's q512_evict world under the optimistic engine
    "q512_evict": ["--tasks", "50000", "--nodes", "5000", "--queues", "512",
                   "--running-fraction", "0.5",
                   "--actions", "reclaim_optimistic,allocate,backfill,preempt", "--cycles", "3",
                   "--seed", "42"],
    # chip_smoke.py phase 7's serving path: the evictive world served 5
    # epochs through the TorchDecider (world 0 warms, world 1 is timed)
    "serving": ["--tasks", "50000", "--nodes", "5000", "--running-fraction", "0.5",
                "--actions", "reclaim,allocate,backfill,preempt", "--epochs", "5",
                "--cycles", "2", "--seed", "42"],
    # chip_smoke.py phase 8's priority-mix world (MIX_FULL; seeds 44-46)
    "priority_mix": ["--tasks", "50000", "--nodes", "5000", "--queues", "64",
                     "--running-fraction", "0.5", "--fit-fraction", "1.0", "--priority-mix",
                     "--actions", "reclaim,allocate,backfill,preempt", "--cycles", "3",
                     "--seed", "44"],
}


def run_once(tree: Path, world: str, timeout: float, cycles: int = 0) -> List[Dict]:
    args = list(WORLDS[world])
    if cycles:
        args[args.index("--cycles") + 1] = str(cycles)
    out = subprocess.run([sys.executable, "-m", "kube_arbitrator_tpu_torch", *args, "--json"],
                         cwd=tree, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} {world}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def summary(rows: List[Dict]) -> Dict:
    warm = [r for r in rows if r["cycle"] > 0]
    cyc = [r["cycle_ms"] for r in warm]
    stages = sorted({k for r in warm for k in r.get("stages_ms", {})})
    out = dict(
        runs=len(warm), cycle_ms_median=statistics.median(cyc), cycle_ms_min=min(cyc),
        cycle_ms_max=max(cyc), cycle_ms=cyc,
        stages_ms_median={k: statistics.median(r["stages_ms"].get(k, 0.0) for r in warm)
                          for k in stages},
    )
    delta = [r["upload_ms"] for r in warm if r.get("mode") == "delta"]
    if delta:  # a served world: its delta epochs' uploads
        out.update(upload_ms_median=statistics.median(delta), upload_ms=delta)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kube_arbitrator_tpu_torch.cycle_turns",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other tree's root")
    ap.add_argument("--order", default="PCCPCP")
    ap.add_argument("--tree", action="append", default=[], metavar="X=DIR",
                    help="one more tree, under the letter X")
    ap.add_argument("--worlds", default="allocate,evictive,pa_evict")
    ap.add_argument("--cycles", type=int, default=0,
                    help="cycles a process decides (default: each world's own)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per process")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    a = ap.parse_args(argv)
    trees = {"P": Path(a.parent).resolve(), "C": HERE}
    for spec in a.tree:
        letter, _, path = spec.partition("=")
        if len(letter) != 1 or letter in trees or not path:
            ap.error(f"--tree {spec!r}: want a new letter, '=', a directory")
        trees[letter] = Path(path).resolve()
    if set(a.order) - set(trees):
        ap.error(f"--order {a.order!r} names a tree that is not given")
    worlds = [w for w in a.worlds.split(",") if w]
    rows: Dict[str, Dict[str, List[Dict]]] = {w: {t: [] for t in trees} for w in worlds}
    for turn, which in enumerate(a.order):
        for w in worlds:
            got = run_once(trees[which], w, a.timeout, a.cycles)
            rows[w][which].extend(got)
            print(json.dumps(dict(turn=turn, tree=which, world=w,
                                  cycles=[(r["seed"], round(r["cycle_ms"], 1)) for r in got])),
                  flush=True)
    result = {w: {t: summary(r) for t, r in by.items() if r} for w, by in rows.items()}
    if a.out:
        Path(a.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
