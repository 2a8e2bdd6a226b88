"""Where a kernel wrapper's host time goes: one cycle under cProfile.

    python -m kube_arbitrator_tpu_torch.host_profile [--tree DIR]
        [--worlds pa_evict,binpack,q512_evict,allocate,evictive,priority_mix,resident]
        [--wrappers turn_caps,pa_fit,segment_sum,queue_perm,...] [--out FILE]

For each world, a child process run from DIR (a checkout of the
repository, by default this one; for example the parent commit unpacked
with ``git archive``) decides the world once to build the kernels and
warm the card, then decides it again (the next seed) under cProfile.
Prints one JSON line per world: the cycle's wall time under the
profiler, and for each wrapper module named in ``--wrappers``
(``ops/kernels/<name>.py``; ``queue_perm``: that function of
ops/allocate.py, whose cost includes the queue keys' build;
``safe_share``: that function of ops/common.py; ``select_turns``:
that function of ops/allocate.py and ``_pops`` of ops/preempt.py, the
turn picks with their masks and keys; ``rank_and_cum`` of ops/preempt.py
and ``seg_cumsum`` of ops/common.py, K5's callers; ``mm_cumsum`` of
ops/common.py; ``_reclaim_canon`` and ``_reclaim_fast`` of
ops/preempt.py, the reclaim walks that launch K7 / K8 and K20;
``_reclaim_canon_optimistic`` / ``_reclaim_canon_batched`` of
ops/preempt.py, the opt-in engines that launch K13-K15 and K8;
``_apply_claim`` of ops/preempt.py, a preempt claim turn's tail around
K6, and ``claim_aggregates`` of ops/preempt.py, where an older tree
made the per-node victim sums for K6, which K6 now folds in;
``allocate_action`` of ops/allocate.py, whose callees include K3's
bind and launch, or an older tree's ``_decode_deferred``; ``update`` of
cache/arena.py, the serving path's upload around K18) its
functions' calls and cumulative seconds and the callees of those
functions by cumulative seconds: the host items that cost most.  With
``queue_perm`` among the wrappers, the row also gives the device kernels
one ``queue_perm`` call launches (torch.profiler over 20 calls at the
world's queue count, between entry and return); with
``_reclaim_canon_optimistic``, the device events of one optimistic
reclaim action from the world's open_session state by name, its windows
and the events per window; with ``claim_nodes``, the device events of
one preempt claim turn (:func:`claim_turn_events`).  cProfile slows every
Python call, so compare items within one run, not with the cycle times
of cycle_turns.py.  The ``resident`` world is no cycle: its profiled
run is ``DeviceResident.update`` applied 200 times to the serving
path's first delta epoch of the 50k x 5k evictive pack (chip_smoke.py's
``k18_case`` epoch, each call a new key on the last), after 5 such
calls to warm.  Needs the GPU, as the CLI does.
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
    "allocate": dict(tasks=100_000, nodes=10_000),
    "evictive": dict(tasks=50_000, nodes=5_000, running_fraction=0.5,
                     actions=("reclaim", "allocate", "backfill", "preempt")),
    "pa_evict": dict(tasks=50_000, nodes=5_000, running_fraction=0.5, pod_affinity=True,
                     actions=("reclaim", "allocate", "backfill", "preempt")),
    "binpack": dict(tasks=100_000, nodes=10_000, node_order="binpack"),
    # chip_smoke.py phase 6's q512_evict world under the optimistic engine
    "q512_evict": dict(tasks=50_000, nodes=5_000, queues=512, running_fraction=0.5,
                       actions=("reclaim_optimistic", "allocate", "backfill", "preempt")),
    # chip_smoke.py phase 8's priority-mix world (MIX_FULL)
    "priority_mix": dict(tasks=50_000, nodes=5_000, queues=64, running_fraction=0.5,
                         fit_fraction=1.0, priority_mix=True,
                         actions=("reclaim", "allocate", "backfill", "preempt")),
    # the serving path's upload: DeviceResident.update, not a cycle
    "resident": dict(tasks=50_000, nodes=5_000, epochs=200),
}

CHILD = r'''
import cProfile, json, pstats, sys, time
import numpy as np
import torch
from kube_arbitrator_tpu_torch.cli import decide_world
world, wrappers, seed = json.loads(sys.argv[1]), sys.argv[2].split(","), int(sys.argv[3])
# a wrapper outside ops/kernels/: (file, function)
OTHER = {"queue_perm": ("ops/allocate.py", "queue_perm"),
         "safe_share": ("ops/common.py", "safe_share"),
         "select_turns": ("ops/allocate.py", "select_turns"),
         "_pops": ("ops/preempt.py", "_pops"),
         "rank_and_cum": ("ops/preempt.py", "rank_and_cum"),
         "seg_cumsum": ("ops/common.py", "seg_cumsum"),
         "mm_cumsum": ("ops/common.py", "mm_cumsum"),
         "_reclaim_canon": ("ops/preempt.py", "_reclaim_canon"),
         "_reclaim_canon_optimistic": ("ops/preempt.py", "_reclaim_canon_optimistic"),
         "_reclaim_canon_batched": ("ops/preempt.py", "_reclaim_canon_batched"),
         "_reclaim_fast": ("ops/preempt.py", "_reclaim_fast"),
         "_apply_claim": ("ops/preempt.py", "_apply_claim"),
         "claim_aggregates": ("ops/preempt.py", "claim_aggregates"),
         "allocate_action": ("ops/allocate.py", "allocate_action"),
         "update": ("cache/arena.py", "update")}
if "epochs" in world:
    # the first delta epoch of the evictive pack, as chip_smoke.py's k18_case
    from kube_arbitrator_tpu_torch.cache import arena
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays, epoch_stream
    arrays, _ = build_synthetic_arrays(world["tasks"], world["nodes"], 8, 100, 42,
                                       running_fraction=0.5, fit_fraction=1.2)
    g = epoch_stream(arrays, 2, 0.04, 0.01, 42)
    _, prev, _ = next(g)
    _, new, _ = next(g)
    changed = {n: arena.changed_rows(np.asarray(new[n]), np.asarray(prev[n]))
               for n in arena.changed_fields(prev, new) if n != "rv_window"}
    statics, dev = {"rv_window": int(new.get("rv_window", 0))}, torch.device("cuda")
    res, keys = arena.DeviceResident(), ["e0"]
    res.update(prev, statics, "e0", None, {}, dev)
    def run(calls):
        for _ in range(calls):
            keys.append(f"e{len(keys)}")
            res.update(new, statics, keys[-1], keys[-2], changed, dev)
    warm, timed = (lambda: run(5)), (lambda: run(world["epochs"]))
else:
    warm = lambda: decide_world(device="cuda", seed=seed - 1, **world)
    timed = lambda: decide_world(device="cuda", seed=seed, **world)
warm()
torch.cuda.synchronize()
prof = cProfile.Profile()
t0 = time.perf_counter()
prof.enable()
timed()
torch.cuda.synchronize()
prof.disable()
wall = time.perf_counter() - t0
st = pstats.Stats(prof).stats
out = {"profiled_cycle_s": wall, "wrappers": {}}
for w in wrappers:
    tail, fn = OTHER.get(w, (f"ops/kernels/{w}.py", None))
    own = [k for k in st if k[0].replace("\\", "/").endswith(tail) and fn in (None, k[2])]
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
if "queue_perm" in wrappers:
    # device kernels of one queue_perm call at the world's Q (R = 4; the
    # default tiers' keys: inactive flag, proportion share, uid rank)
    from torch.profiler import ProfilerActivity, profile
    from kube_arbitrator_tpu_torch.ops.allocate import queue_perm
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS
    Q, calls = world.get("queues", 8), 20
    rng = np.random.default_rng(seed)
    args = [torch.from_numpy(a).cuda() for a in (
        rng.random(Q) < 0.6, rng.integers(0, 4, (Q, 4)).astype(np.float32) * 1000,
        rng.integers(1, 4, (Q, 4)).astype(np.float32) * 1000, rng.permutation(Q).astype(np.int32))]
    queue_perm(DEFAULT_TIERS, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            queue_perm(DEFAULT_TIERS, *args)
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    out["queue_perm_device_events_per_call"] = dict(
        Q=Q, kernels=sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev_ev) / calls,
        memsets=sum(e.name.startswith("Memset") for e in dev_ev) / calls,
        names=sorted({e.name[:80] for e in dev_ev}))
if "_reclaim_canon_optimistic" in wrappers:
    from kube_arbitrator_tpu_torch.host_profile import optimistic_events
    out["optimistic_device_events"] = optimistic_events(
        "cuda", world["tasks"], world["nodes"], world.get("queues", 8), seed,
        world["running_fraction"])
if "claim_nodes" in wrappers and "preempt" in world.get("actions", ()):
    from kube_arbitrator_tpu_torch.host_profile import claim_turn_events
    out["claim_turn_events"] = claim_turn_events(world, seed)
print(json.dumps(out))
'''


def optimistic_events(device, tasks: int, nodes: int, queues: int, seed: int,
                      running_fraction: float, tasks_per_job: int = 100,
                      fit_fraction: float = 1.2) -> dict:
    """One optimistic reclaim action of a synthetic world from its
    open_session state, under torch.profiler with ``Tensor.to`` watched:
    its windows and rounds, its device events (all, kernels alone, a
    window, by name), the dtype casts issued from
    ``_reclaim_canon_optimistic``'s own frame, and the launches of K14,
    K15 and K8."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import cycle, kernels, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS

    arrays, _ = build_synthetic_arrays(tasks, nodes, queues, tasks_per_job, seed,
                                       running_fraction=running_fraction,
                                       fit_fraction=fit_fraction)
    st = from_numpy(arrays, device)
    sess, state = cycle.open_session(st, DEFAULT_TIERS)
    own = {"n": 0}
    to = torch.Tensor.to

    def watched(self, *a, **kw):
        out = to(self, *a, **kw)
        if out.dtype != self.dtype and \
                sys._getframe(1).f_code.co_name == "_reclaim_canon_optimistic":
            own["n"] += 1
        return out

    torch.cuda.synchronize()
    before = kernels.counts()
    shadowed = "to" in torch.Tensor.__dict__
    torch.Tensor.to = watched
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r = preempt.reclaim_action(st, sess, state, DEFAULT_TIERS, turn_batch="optimistic")
            torch.cuda.synchronize()
    finally:
        if shadowed:
            torch.Tensor.to = to
        else:
            del torch.Tensor.to
    after = kernels.counts()
    dev_ev = [e for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return dict(
        windows=r.windows, rounds=r.rounds, device_events=len(dev_ev),
        kernels=sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev_ev),
        events_per_window=len(dev_ev) / max(r.windows, 1), casts=own["n"],
        launches={k: after[k] - before[k] for k in ("union_fit", "window_gate", "canon_commit")},
        by_name=dict(Counter(e.name[:90] for e in dev_ev).most_common(40)))


def claim_turn_events(world: dict, seed: int, turn: int = 0) -> dict:
    """One preempt claim turn's tail (ops/preempt.py's ``_apply_claim``:
    K6, the claimant decode and the state scatters), the ``turn``-th of a
    cycle of ``world`` (decide_world's arguments, with ``preempt`` among
    its actions) on the card, under torch.profiler: its device events
    (all, kernels alone, by name), the ``scatter_reduce`` ops it issued,
    and the launches of each port kernel.  A spin kernel runs first
    inside the profile (its record is left out), since the profile can
    lose the record of its first launch."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kube_arbitrator_tpu_torch.cli import decide_world
    from kube_arbitrator_tpu_torch.ops import kernels, preempt

    orig = preempt._apply_claim
    seen, got = [0], {}

    def profiled(*a, **kw):
        seen[0] += 1
        if seen[0] - 1 != turn:
            return orig(*a, **kw)
        torch.cuda.synchronize()
        before = kernels.counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2000)
            torch.cuda.synchronize()
            orig(*a, **kw)
            torch.cuda.synchronize()
        after = kernels.counts()
        dev_ev = [e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        got.update(
            device_events=len(dev_ev),
            kernels=sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev_ev),
            scatter_reduce=sum(e.count for e in prof.key_averages()
                               if "scatter_reduce" in e.key),
            launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
            by_name=dict(Counter(e.name[:90] for e in dev_ev).most_common(40)))

    preempt._apply_claim = profiled
    try:
        decide_world(device="cuda", seed=seed, **world)
        torch.cuda.synchronize()
    finally:
        preempt._apply_claim = orig
    return dict(turn=turn, turns=seen[0], **got)


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
