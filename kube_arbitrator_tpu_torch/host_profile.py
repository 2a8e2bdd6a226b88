"""Where a kernel wrapper's host time goes: one cycle under cProfile.

    python -m kube_arbitrator_tpu_torch.host_profile [--tree DIR]
        [--worlds pa_evict,binpack,q512_evict] [--wrappers turn_caps,pa_fit,segment_sum,...]
        [--out FILE]

For each world, a child process run from DIR (a checkout of the
repository, by default this one; for example the parent commit unpacked
with ``git archive``) decides the world once to build the kernels and
warm the card, then decides it again (the next seed) under cProfile.
Prints one JSON line per world: the cycle's wall time under the
profiler, and for each wrapper module named in ``--wrappers``
(``ops/kernels/<name>.py``) its functions' calls and cumulative seconds
and the callees of those functions by cumulative seconds: the host items
that cost most.  cProfile slows every Python call, so compare items
within one run, not with the cycle times of cycle_turns.py.  Needs the
GPU, as the CLI does.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parents[1]

WORLDS = {
    "pa_evict": dict(tasks=50_000, nodes=5_000, running_fraction=0.5, pod_affinity=True,
                     actions=("reclaim", "allocate", "backfill", "preempt")),
    "binpack": dict(tasks=100_000, nodes=10_000, node_order="binpack"),
    # chip_smoke.py phase 6's q512_evict world under the optimistic engine
    "q512_evict": dict(tasks=50_000, nodes=5_000, queues=512, running_fraction=0.5,
                       actions=("reclaim_optimistic", "allocate", "backfill", "preempt")),
}

CHILD = r'''
import cProfile, json, pstats, sys, time
import torch
from kube_arbitrator_tpu_torch.cli import decide_world
world, wrappers, seed = json.loads(sys.argv[1]), sys.argv[2].split(","), int(sys.argv[3])
decide_world(device="cuda", seed=seed - 1, **world)
torch.cuda.synchronize()
prof = cProfile.Profile()
t0 = time.perf_counter()
prof.enable()
decide_world(device="cuda", seed=seed, **world)
torch.cuda.synchronize()
prof.disable()
wall = time.perf_counter() - t0
st = pstats.Stats(prof).stats
out = {"profiled_cycle_s": wall, "wrappers": {}}
for w in wrappers:
    tail = f"ops/kernels/{w}.py"
    own = [k for k in st if k[0].replace("\\", "/").endswith(tail)]
    funcs = {f"{k[2]}:{k[1]}": dict(calls=st[k][1], cum_s=st[k][3], own_s=st[k][2])
             for k in own}
    callees = {}
    for k, (cc, nc, tt, ct, callers) in st.items():
        for c in own:
            if c in callers and k not in own:
                name = f"{k[2]} ({k[0].split('/')[-1]}:{k[1]})"
                prev = callees.get(name, [0, 0.0])
                callees[name] = [prev[0] + callers[c][1], prev[1] + callers[c][3]]
    top = sorted(callees.items(), key=lambda kv: -kv[1][1])[:15]
    out["wrappers"][w] = dict(functions=funcs, callees=[
        dict(name=n, calls=v[0], cum_s=v[1]) for n, v in top])
print(json.dumps(out))
'''


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--worlds", default="pa_evict,binpack")
    ap.add_argument("--wrappers", default="turn_caps,pa_fit")
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    rows = []
    for w in args.worlds.split(","):
        res = subprocess.run([sys.executable, "-c", CHILD, json.dumps(WORLDS[w]), args.wrappers,
                              str(args.seed)], cwd=args.tree, capture_output=True, text=True,
                             timeout=1800)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        row = dict(world=w, tree=str(args.tree), **json.loads(res.stdout.splitlines()[-1]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
