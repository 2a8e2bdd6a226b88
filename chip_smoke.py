#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; imports nothing of JAX.  Phases (any failure
exits non-zero):

1. kernels — builds K1-K20 from kube_arbitrator_tpu_torch/ops/kernels/csrc
   (one nvcc per source, in parallel) and holds each against its plain
   PyTorch version, requiring equality: K1-K4 on seeded inputs at the
   allocate path's shapes (100k tasks, 10k nodes, 1k groups, 8-slot
   chunks), K5-K8 on the inputs the evictive path gives them in the
   50k-task x 5k-node world (its preempt victim panel, its first preempt
   turn, its first claiming reclaim turn), K9-K10 on the binpack world's
   turns (100k x 10k: the all-idle entry, where the binpack keys tie at
   -0.0, and a turn after two rounds, binpack and spread), K11-K12 on
   the pod-affinity world's groups after reclaim and three allocate
   rounds (50k x 5k), K13-K15 on the optimistic reclaim engine's first
   speculation window of the q512_evict world (50k x 5k, 512 queues),
   K16 on its three callers' shapes (a commit list at T = 102,400 whose
   count passes the cap, allocate's feasibility cells at [K, 10,240],
   preempt's full-width victim panel at 51,200), K17 on the q512_evict
   world's first reclaim round (Q = 512) and on key stacks of ties, -0.0,
   NaN and BIG at Q = 8 / 512 / 4,096, K18 on every field dtype and rank
   with duplicate rows, an empty epoch, and phase 7's first delta epoch of
   the 50k x 5k pack, K19 on preempt's (node, queue) victim lexsort at
   P = 51,200 (negative priorities, INT_MAX padding, ties), the claim-log
   join (J = 512, T = 51,200) and segment_order (102,400 slots -> 1,024
   segments with out-of-range slots, and one segment), K20 on
   _reclaim_fast's cumulatives at [51,200, 3 / 4 / 1] whose totals pass
   2^24.  K17, K19 and K20 are held against their plain versions run on
   the CPU.  Times the kernel, the plain version and, where one PyTorch
   call computes the same function (K4's, K7's, K11's, K12's and K13's
   sums: ``Tensor.index_add_``; K9's order, K17's and K19's:
   ``torch.sort(stable=True)``; K16: ``torch.nonzero`` plus padding; K18:
   ``index_copy_`` per field; K20: ``torch.cumsum``), that call.
2. parity — worlds decided on the card and on the CPU by the port's
   ``schedule_cycle``, every CycleDecisions field equal: 1000 x 100
   (allocate, backfill), 5k x 500 and 20k x 2k under the evictive conf
   (reclaim, allocate, backfill, preempt), at 5k x 500 a pod-affinity
   evictive world, an evictive world without the reclaim canon pack
   (``_reclaim_fast`` with its claim log) and a binpack world, and the
   reference's sequential-vs-batched soak shape at q = 64 under
   ``reclaim_optimistic`` (and its ``reclaim_action(turn_batch=True)``,
   every AllocState field equal).
3. allocate at full width — the ``python -m kube_arbitrator_tpu_torch``
   path on four 100k-task x 10k-node worlds (seeds 42, 43, 44 and one
   capacity-tight world): invariants hold and the integer decisions equal
   the port's CPU run of the same world.
4. the evictive cycle at full width — 50k tasks x 5k nodes, 8 queues,
   half the jobs running, seeds 42 and 43, on the card only: stage times,
   rounds, binds and evictions by phase; invariants; seed 42's counts and
   decision digest equal the JAX package's (EVICT_WORLD_42).
5. the immediate path at full width — the pod-affinity evictive world
   (50k x 5k, seeds 42 and 43: hostname / rack / zone domains and the
   affinity mix of cache/synth.py) and the binpack (seed 42) and spread
   (seed 43) allocate worlds (100k x 10k) on the card: invariants (no
   over-commit, at most one pod of a self-anti-affinity job per node,
   each self-affinity job's pods in one rack); card == CPU on the
   integer fields (the allocate worlds at full width, the pod-affinity
   world at 20k x 2k); seed 42's counts and digests equal the JAX
   package's (PA_WORLD_42, BINPACK_WORLD_42); K9-K12, K19 and K20
   launched, K20 once per ``mm_cumsum`` of each ``_reclaim_fast`` turn
   (one a turn under the default tiers, whose reclaim verdict is gang's;
   two where proportion is a reclaim verdict).
6. the opt-in reclaim engines at full width — q512_evict (50k x 5k, 512
   queues, half the jobs running; seeds 42 and 43) and rounds_q4 (20k x
   2k, 4 queues, 70% running; seed 42): the canon walk, the round-batched
   and the optimistic engine from one open_session state leave the same
   AllocState and round count (stage times, counters and, for seed 42,
   host syncs printed); the cycle under ``reclaim_optimistic, allocate,
   backfill, preempt`` keeps the invariants of phase 4 and counts claim
   conflicts; seed 42's counts, digest and reclaim counters equal the
   JAX package's (Q512_WORLD_42, ROUNDS_Q4_WORLD_42); card == CPU on the
   integer fields (rounds_q4 at full width, the q512 shape at 20k x 2k);
   K13-K16 launched.
7. the serving path at full width — the evictive world (50k x 5k, seed
   42) served for five epochs through ``framework.TorchDecider`` on the
   card: epoch 1 uploads in full and decides like the JAX package
   (EVICT_WORLD_42); before each later epoch 4% of the running tasks
   complete and 1% of the nodes flip their cordon, and the epoch uploads
   only the changed rows (K18).  After every epoch: the resident pack
   equals the host pack bit for bit, the decisions equal a fresh
   upload's, a repeated key reuses with 0 bytes, a delta uploads fewer
   bytes than the full epoch and K18 ran.  The same epochs at 20k x 2k
   decide equal on the card and on the CPU.  Prints each epoch's mode,
   bytes, upload, decide and cycle ms.
8. the evictive cycle under the priority mix at full width — 50k x 5k,
   64 queues, capacity equal to the demand, job / group / task
   priorities 1-3 and pending tails on half the running jobs
   (cache/synth.py ``priority_mix``), seed 45: preempt evicts in phase 2
   and gates at least one round; invariants; the counts and digest equal
   the JAX package's (MIX_WORLD_45); card == CPU in every CycleDecisions
   field at 20k x 2k (seed 43; queue_deserved within its standing rtol
   1e-5).
9. no library sort — the evictive and pod-affinity evictive cycles (50k
   x 5k, seed 42) under torch.profiler: no ``aten::sort`` or
   ``aten::argsort`` event; prints those counts, ``aten::searchsorted``'s
   and the device kernels of each cycle.

Each path's launch counts are taken over its first world (seed 42; the
priority-mix path's over seed 45), with every count set to 0 just
before it.  The kernels line counts K19's launches over the evictive
and the pod-affinity evictive cycles, and K20's over the latter.

Prints each phase's wall time, the card's name and power limit, a JSON
line of per-kernel numbers, and as its last line ``{"ok": true, "device": {...}}``; the
compiler's register and spill report goes to stderr.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

MEM_BW = 3.35e12       # H100 SXM HBM3, bytes/s
F32_PEAK = 67e12       # H100 SXM f32 (non-tensor-core) op/s
INT_MAX = 2**31 - 1
INT_FIELDS = (
    "task_node", "task_status", "bind_mask", "evict_mask", "job_ready",
    "unready_alloc", "node_num_tasks", "node_ports", "evict_claimant",
    "evict_phase", "evict_round", "bind_idx", "bind_node", "evict_idx",
    "bind_count", "evict_count",
)
FULL = dict(tasks=100_000, nodes=10_000, queues=8, tasks_per_job=100)
WORLDS = (
    dict(seed=42, running_fraction=0.0, fit_fraction=1.2),
    dict(seed=43, running_fraction=0.0, fit_fraction=1.2),
    dict(seed=44, running_fraction=0.0, fit_fraction=1.2),
    dict(seed=45, running_fraction=0.3, fit_fraction=0.9),
)
EVICT_ACTIONS = ("reclaim", "allocate", "backfill", "preempt")
EVICT_FULL = dict(tasks=50_000, nodes=5_000, queues=8, tasks_per_job=100,
                  running_fraction=0.5, fit_fraction=1.2)
EVICT_PARITY = (
    dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100, seed=42, running_fraction=0.5),
    dict(tasks=20_000, nodes=2_000, queues=4, tasks_per_job=100, seed=42, running_fraction=0.7),
)
# The 50k x 5k seed-42 world under EVICT_ACTIONS as the JAX package
# decides it, from tests/test_torch_evict_fullwidth.py (the port's CPU run
# equals it in every CycleDecisions field); the digest is decision_digest's.
EVICT_WORLD_42 = dict(binds=23_937, evicts_by_phase=[0, 1139, 0, 426], digest="ef1edee61d169ef5")
# The priority-mix evictive world (cache/synth.py ``priority_mix``: job,
# group and task priorities 1-3, a pending tail on half the running jobs),
# 64 queues at capacity equal to the demand, so preempt evicts in phase 2
# and gates a round; seed 45 under EVICT_ACTIONS as the JAX package
# decides it, from tests/test_torch_evict_fullwidth.py (the port's CPU
# run equals it in every integer CycleDecisions field).
MIX_FULL = dict(tasks=50_000, nodes=5_000, queues=64, tasks_per_job=100,
                running_fraction=0.5, fit_fraction=1.0, priority_mix=True)
MIX_WORLD_45 = dict(binds=26_933, evicts_by_phase=[0, 1524, 24, 549], digest="85cf57ccd87b81bf")
# card vs CPU on the priority-mix world at a size the CPU decides quickly
# (seed 43: both preempt phases evict and a round is gated there too)
MIX_CPU_CHECK = dict(MIX_FULL, tasks=20_000, nodes=2_000, seed=43)
SLICE2_KERNELS = ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum", "seg_scan",
                  "claim_nodes", "canon_pick", "canon_commit")
# The immediate path's full-width worlds as the JAX package decides them,
# from tests/test_torch_immediate_fullwidth.py (the port's CPU run equals
# them in every integer CycleDecisions field): the pod-affinity evictive
# world (EVICT_FULL with pod_affinity, seed 42) and the binpack allocate
# world (FULL, nodeorder binpack, seed 42).
PA_WORLD_42 = dict(binds=19_899, evicts_by_phase=[0, 21, 0, 426], digest="17c5f008e808b91e")
BINPACK_WORLD_42 = dict(binds=96_725, digest="290aa02eea62a7b5")
# card vs CPU on the pod-affinity world at a size the CPU decides quickly
PA_CPU_CHECK = dict(tasks=20_000, nodes=2_000, queues=8, tasks_per_job=100,
                    running_fraction=0.5, fit_fraction=1.2)
# The opt-in reclaim engines' worlds (the reference bench's
# full_actions_q512@50000x5000 and full_actions_rounds_q4@20000x2000) under
# OPT_ACTIONS; seed 42 as the JAX package decides it, from
# tests/test_torch_reclaim_fullwidth.py (the port's CPU run equals it in
# every integer CycleDecisions field and every stage counter).
OPT_ACTIONS = ("reclaim_optimistic", "allocate", "backfill", "preempt")
Q512_EVICT = dict(tasks=50_000, nodes=5_000, queues=512, tasks_per_job=100,
                  running_fraction=0.5, fit_fraction=1.2)
ROUNDS_Q4 = dict(tasks=20_000, nodes=2_000, queues=4, tasks_per_job=100,
                 running_fraction=0.7, fit_fraction=1.2)
Q512_WORLD_42 = dict(binds=24_695, evicts_by_phase=[0, 0, 0, 408], digest="608633b7eb81a733",
                     reclaim_counters=[2, 1, 31_626])
ROUNDS_Q4_WORLD_42 = dict(binds=5_427, evicts_by_phase=[0, 778, 0, 105],
                          digest="9db04e52b1d1becb", reclaim_counters=[19, 1, 84])
# card vs CPU for the q512 shape at a size the CPU decides quickly
Q512_CPU_CHECK = dict(tasks=20_000, nodes=2_000, queues=512, tasks_per_job=100,
                      running_fraction=0.5, fit_fraction=1.2)
# phase 7: the serving path — the evictive world served epoch by epoch
# through the TorchDecider; before each epoch after the first, 4% of the
# running tasks complete (the reference bench's BENCH_PIPE_CHURN default)
# and 1% of the nodes flip their cordon
SERVE_EPOCHS = 5
SERVE_CHURN = 0.04
SERVE_CORDON = 0.01
# card vs CPU for the serving stream at a size the CPU decides quickly
SERVE_CPU_CHECK = dict(tasks=20_000, nodes=2_000, queues=8, tasks_per_job=100,
                       running_fraction=0.5, fit_fraction=1.2)
# phase 2's world of the reference's sequential-vs-batched soak shape at
# q = 64 (few tasks per job, more jobs than queues, oversubscribed)
SOAK_Q64 = dict(tasks=4_000, nodes=400, queues=64, tasks_per_job=20, seed=1,
                running_fraction=0.5, fit_fraction=1.25)
RECLAIM_ENGINES = (None, True, "optimistic")
# phase 2's slice-3 parity worlds: (name, world, canon pack stripped)
PARITY_SLICE3 = (
    ("pod-affinity evictive 5k x 500", dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100,
                                            seed=42, running_fraction=0.5, fit_fraction=1.25,
                                            pod_affinity=True, actions=EVICT_ACTIONS), False),
    ("no canon pack (_reclaim_fast, claim log) 5k x 500",
     dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100, seed=42, running_fraction=0.5,
          fit_fraction=1.25, actions=EVICT_ACTIONS), True),
    ("binpack 5k x 500", dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100, seed=42,
                              node_order="binpack"), False),
)


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 2, setup=None) -> float:
    """Mean device time of ``fn`` between CUDA events; ``setup`` runs
    before each call, outside the timed window."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    total = 0.0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        if setup:
            setup()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def bound_ms(nbytes: float, nops: float) -> tuple:
    tb, to = nbytes / MEM_BW * 1e3, nops / F32_PEAK * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def decision_digest(bind_mask, evict_mask) -> str:
    """sha256[:16] of the bound and evicted task ordinals (the same
    function as tests/test_torch_evict_fullwidth.py's)."""
    h = hashlib.sha256(np.nonzero(bind_mask)[0].astype(np.int32).tobytes())
    h.update(b"|")
    h.update(np.nonzero(evict_mask)[0].astype(np.int32).tobytes())
    return h.hexdigest()[:16]


def to_cpu(x):
    """A copy of ``x`` on the CPU: tensors, tuples and dataclasses of them."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        vals = [to_cpu(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double().cpu() - b.double().cpu()).abs().max())


# ---------------------------------------------------------------- phase 1


def k4_case(dev):
    from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4

    rng = np.random.default_rng(4)
    T, J, C = 102_400, 1024, 4
    val = torch.from_numpy((rng.standard_normal((T, C)) * 1000).astype(np.float32)).to(dev)
    idx = torch.from_numpy((np.arange(T) // 100).astype(np.int32)).to(dev)
    out = k4.segment_sum(val, idx, J)
    ref_cpu = k4.segment_sum_plain(val.cpu(), idx.cpu(), J)
    err = max_err(out, ref_cpu)
    expect(torch.equal(out.cpu(), ref_cpu), "K4 f32 differs from its plain version")
    # out-of-range indices dropped, i32 variant, one long segment
    bad = idx.clone()
    bad[::7] = -1
    bad[3::11] = J + 5
    ival = torch.from_numpy(rng.integers(-50, 50, (T, C)).astype(np.int32)).to(dev)
    expect(torch.equal(k4.segment_sum(val, bad, J).cpu(), k4.segment_sum_plain(val.cpu(), bad.cpu(), J)),
           "K4 out-of-range drop differs")
    expect(torch.equal(k4.segment_sum(ival, bad, J).cpu(), k4.segment_sum_plain(ival.cpu(), bad.cpu(), J)),
           "K4 i32 differs")
    long_v = val[:10_240]
    expect(torch.equal(k4.ordered_sum(long_v).cpu(), k4.segment_sum_plain(
        long_v.cpu(), torch.zeros(10_240, dtype=torch.int32), 1)[0]), "K4 ordered_sum differs")
    ms = cuda_ms(lambda: k4.segment_sum(val, idx, J))
    plain_ms = cuda_ms(lambda: k4.segment_sum_plain(val, idx, J), reps=3)
    lib = torch.zeros((J, C), device=dev)
    lib_ms = cuda_ms(lambda: lib.zero_().index_add_(0, idx, val))
    nbytes = T * C * 4 + T * 4 + J * C * 4
    b, by = bound_ms(nbytes, T * C)
    return dict(name="segment_sum", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib_ms,
                shape=f"val f32[{T},{C}] -> [{J},{C}]")


def k2_case(dev):
    from kube_arbitrator_tpu_torch.ops.kernels import lex_argmin as k2

    rng = np.random.default_rng(2)
    K, M, S = 5, 1024, 8
    keys = rng.integers(0, 3, (K, M)).astype(np.float32)
    keys[3] = rng.random(M).astype(np.float32)          # a share column
    keys[3][rng.random(M) < 0.5] = 0.25                 # with ties
    keys[4] = np.arange(M, dtype=np.float32)            # the creation rank
    mask = rng.random((S, M)) < 0.3
    mask[5] = False                                      # an empty row
    keys_t, mask_t = torch.from_numpy(keys).to(dev), torch.from_numpy(mask).to(dev)
    kt = torch.from_numpy(keys[:4].copy()).to(dev)       # ties reach the index
    got = [k2.lex_argmin(keys_t, mask_t), k2.lex_argmin(kt, mask_t)]
    ref = [k2.lex_argmin_plain(keys_t.cpu(), mask_t.cpu()), k2.lex_argmin_plain(kt.cpu(), mask_t.cpu())]
    err = 0.0
    for (gi, ga), (ri, ra) in zip(got, ref):
        err = max(err, max_err(gi, ri))
        expect(torch.equal(gi.cpu(), ri) and torch.equal(ga.cpu(), ra), "K2 differs from its plain version")
    ms = cuda_ms(lambda: k2.lex_argmin(keys_t, mask_t))
    plain_ms = cuda_ms(lambda: k2.lex_argmin_plain(keys_t, mask_t))
    b, by = bound_ms(K * M * 4 + S * M + S * 5, S * K * M * 2)
    return dict(name="lex_argmin", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                shape=f"keys f32[{K},{M}], mask bool[{S},{M}]")


def k3_case(dev):
    from kube_arbitrator_tpu_torch.ops.kernels import decode_deferred as k3

    rng = np.random.default_rng(3)
    G, N, per = 1024, 10_240, 100
    T = G * per
    tot_a = rng.integers(0, per + 1, G)
    tot_p = np.minimum(rng.integers(0, 20, G), per - np.minimum(tot_a, per))
    gn = []
    for tot in (tot_a, tot_p):
        c = np.zeros((G, N), np.int32)
        rows = np.repeat(np.arange(G), tot)
        np.add.at(c, (rows, rng.integers(0, N, rows.shape[0])), 1)
        gn.append(torch.from_numpy(c).to(dev))
    tg = (np.arange(T) // per).astype(np.int32)
    tg[rng.random(T) < 0.05] = -1
    args = [
        torch.from_numpy(tg).to(dev),
        torch.from_numpy((np.arange(T) % per).astype(np.int32)).to(dev),
        torch.from_numpy(rng.random(T) < 0.98).to(dev),
        torch.from_numpy(rng.integers(0, 5, G).astype(np.int32)).to(dev),
        torch.zeros(T, dtype=torch.int32, device=dev),
        torch.full((T,), -1, dtype=torch.int32, device=dev),
    ]
    err = 0.0
    for gn_p in (gn[1], None):
        s, n = k3.decode_deferred(gn[0], gn_p, *args)
        rs, rn = k3.decode_deferred_plain(gn[0].cpu(), None if gn_p is None else gn_p.cpu(),
                                          *[a.cpu() for a in args])
        err = max(err, max_err(s, rs), max_err(n, rn))
        expect(torch.equal(s.cpu(), rs) and torch.equal(n.cpu(), rn), "K3 differs from its plain version")
    ms = cuda_ms(lambda: k3.decode_deferred(gn[0], gn[1], *args))
    plain_ms = cuda_ms(lambda: k3.decode_deferred_plain(gn[0], gn[1], *args), reps=5)
    # the two count matrices read once, the task arrays read once, status
    # and node written once
    b, by = bound_ms(2 * G * N * 4 + T * (4 * 4 + 1) + G * 4 + T * 8, 2 * G * N)
    return dict(name="decode_deferred", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                shape=f"gn i32[{G},{N}] x2, tasks [{T}]")


def k1_inputs(dev, seed: int):
    rng = np.random.default_rng(seed)
    N, R, W, G, K, S = 10_240, 4, 2, 1024, 3, 8
    idle = rng.uniform(0, 8000, (N, R)).astype(np.float32)
    rel = rng.uniform(0, 4000, (N, R)).astype(np.float32)
    rel[rng.random(N) < 0.1, 0] = 20_000.5                 # the releasing fallback's room
    ports = np.zeros((N, W), np.int32)
    ports[rng.random(N) < 0.1, 0] = 1 << 3
    st = types.SimpleNamespace(
        num_nodes=N,
        group_klass=torch.from_numpy(rng.integers(0, K, G).astype(np.int32)).to(dev),
        class_fit=torch.from_numpy(rng.random((K, 4)) < 0.7).to(dev),
        node_klass=torch.from_numpy(rng.integers(0, 4, N).astype(np.int32)).to(dev),
        node_valid=torch.from_numpy(rng.random(N) < 0.98).to(dev),
        node_unsched=torch.from_numpy(rng.random(N) < 0.02).to(dev),
        node_max_tasks=torch.full((N,), 24, dtype=torch.int32, device=dev),
    )
    g_sel = rng.choice(G, S, replace=False).astype(np.int32)
    req = (rng.uniform(100, 3000, (S, R)) * (rng.random((S, R)) < 0.8)).astype(np.float32)
    req[3] = [9000.25, 10.5, 0.0, 0.0]                   # fits no idle, fits releasing
    budget = rng.integers(0, 600, S).astype(np.int32)
    budget[3], budget[6] = 50, 0
    sports = np.zeros((S, W), np.int32)
    sports[5, 0] = 1 << 3
    state = dict(
        node_idle=torch.from_numpy(idle).to(dev),
        node_releasing=torch.from_numpy(rel).to(dev),
        node_ports=torch.from_numpy(ports).to(dev),
        node_num_tasks=torch.from_numpy(rng.integers(0, 20, N).astype(np.int32)).to(dev),
        gn_a=torch.zeros((G, N), dtype=torch.int32, device=dev),
        gn_p=torch.zeros((G, N), dtype=torch.int32, device=dev),
    )
    slots = dict(
        n_slots=torch.tensor([7], dtype=torch.int32, device=dev),
        g_sel=torch.from_numpy(g_sel).to(dev),
        req_s=torch.from_numpy(req).to(dev),
        budget_s=torch.from_numpy(budget).to(dev),
        ports_s=torch.from_numpy(sports).to(dev),
        has_ports_s=torch.from_numpy((sports != 0).any(1)).to(dev),
    )
    # a pruned panel: each class's feasible nodes, stably compacted to
    # N // 4 slots with padding N past the count
    feas = (st.class_fit[:, st.node_klass.long()] & st.node_valid & ~st.node_unsched).cpu().numpy()
    NC = N // 4
    panel = np.full((K, NC), N, np.int32)
    for k in range(K):
        nodes = np.nonzero(feas[k])[0][: NC - 37]
        panel[k, : len(nodes)] = nodes
    return st, state, slots, torch.from_numpy(panel).to(dev)


def k1_case(dev):
    from kube_arbitrator_tpu_torch.ops.kernels import admit_chunk as k1

    variants = (
        ("allocate, full width", dict(best_effort=False, preds_on=True), False),
        ("allocate, pruned panel", dict(best_effort=False, preds_on=True), True),
        ("allocate, predicates off", dict(best_effort=False, preds_on=False), False),
        ("backfill, full width", dict(best_effort=True, preds_on=True), False),
    )
    err, fallback_seen, timing = 0.0, False, None
    for name, flags, use_panel in variants:
        st, state, slots, panel = k1_inputs(dev, 11)
        pan = panel if use_panel else None
        runs = []
        for fn in (k1.admit_chunk, k1.admit_chunk_plain):
            s = {k: v.clone() for k, v in state.items()}
            if flags["best_effort"]:
                s["gn_p"] = None
            out = fn(st, s["node_idle"], s["node_releasing"], s["node_ports"], s["node_num_tasks"],
                     s["gn_a"], s["gn_p"], slots["n_slots"], slots["g_sel"], slots["req_s"],
                     slots["budget_s"], slots["ports_s"], slots["has_ports_s"], pan, 4096,
                     flags["best_effort"], flags["preds_on"])
            runs.append((s, out))
        (sk, (pk, uk)), (sp, (pp, up)) = runs
        for key in sk:
            if sk[key] is not None:
                err = max(err, max_err(sk[key], sp[key]))
                expect(torch.equal(sk[key], sp[key]), f"K1 {name}: {key} differs from the plain version")
        expect(torch.equal(pk, pp) and torch.equal(uk, up), f"K1 {name}: placed/use_rel differ")
        expect(int(pk.sum()) > 0, f"K1 {name}: placed nothing")
        fallback_seen |= bool(uk.any())
        if timing is None:
            timing = (st, state, slots, pk, uk)
    expect(fallback_seen, "K1 inputs never took the releasing fallback")
    st, state, slots, pk, uk = timing
    work = {}

    def setup():
        for k, v in state.items():
            work.setdefault(k, v.clone()).copy_(v)

    def run(fn):
        return lambda: fn(st, work["node_idle"], work["node_releasing"], work["node_ports"],
                          work["node_num_tasks"], work["gn_a"], work["gn_p"], slots["n_slots"],
                          slots["g_sel"], slots["req_s"], slots["budget_s"], slots["ports_s"],
                          slots["has_ports_s"], None, 4096, False, True)

    ms = cuda_ms(run(k1.admit_chunk), setup=setup)
    plain_ms = cuda_ms(run(k1.admit_chunk_plain), reps=5, setup=setup)
    N, R = state["node_idle"].shape
    W = state["node_ports"].shape[1]
    # node state read once (idle, ports, counts, limits, class/valid
    # flags; releasing only when a slot fell back), placed cells written
    placed = int(pk.sum())
    nbytes = N * (4 * R + 4 * W + 4 + 4 + 4 + 2) + (N * 4 * R if bool(uk.any()) else 0) \
        + placed * (4 * R + 4 + 4 * W + 4)
    ns = int(slots["n_slots"][0])
    b, by = bound_ms(nbytes, ns * N * (3 * R + 10))
    return dict(name="admit_chunk", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                shape=f"N={N}, R={R}, W={W}, {ns} slots")


# ---- K5-K8: the evictive path's own inputs in the 50k x 5k world


def evict_fixture(dev):
    """The 50k x 5k seed-42 world on the card and on the CPU: the reclaim
    entry state (after open_session) and the preempt entry state (after
    reclaim, allocate and backfill), with preempt's victim panel."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import allocate, cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    w = EVICT_FULL
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], 42,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, dev)
    sess, state0 = cycle.open_session(st, tiers)
    state = preempt.reclaim_action(st, sess, state0, tiers)
    state = allocate.allocate_action(st, sess, state, tiers)
    state = allocate.backfill_action(st, sess, state, tiers)
    T = st.num_tasks
    running0 = (state.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (state.task_node >= 0)
    qualify = preempt._entry_qualify(st, sess, state, running0)
    count = int(qualify.sum())
    P = T // 8 if count <= T // 8 else (T // 4 if count <= T // 4 else T)
    view = preempt._build_view(st, state, qualify if P < T else running0, P)
    return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, tiers=tiers,
                                 state0=state0, state=state, view=view)


def k5_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import seg_scan as k5

    view = fx.view
    P, R = view.resreq.shape
    rng = np.random.default_rng(5)
    mask = view.running(fx.state.task_status) & torch.from_numpy(rng.random(P) < 0.7).to(dev)
    err = 0.0
    for name in ("by_job", "by_queue", "by_node_queue"):
        lay = getattr(view.layouts, name)
        got = lay.rank_and_cum(mask)
        want = k5.seg_scan_plain(mask.cpu(), lay.order.cpu(), lay.seg_start.cpu(), lay.res_sorted.cpu())
        for a, b in zip(got, want):
            err = max(err, max_err(a, b))
            expect(torch.equal(a.cpu(), b), f"K5 {name} differs from its plain version")
    lay = view.layouts.by_node_queue
    ms = cuda_ms(lambda: lay.rank_and_cum(mask))
    plain_ms = cuda_ms(lambda: k5.seg_scan_plain(mask, lay.order, lay.seg_start, lay.res_sorted), reps=3)
    # mask, order, seg_start and resreq read once; rank and cum written once
    b, by = bound_ms(P * (1 + 4 + 1 + 4 * R) + P * (4 + 4 * R), P * (R + 1))
    return dict(name="seg_scan", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None,
                shape=f"panel P={P}, R={R} (by_node_queue; by_job and by_queue held too)")


def k6_inputs(fx):
    """The first preempt turn of the preempt entry state: the first
    queue in the round's order, its claimant and its verdict."""
    from kube_arbitrator_tpu_torch.ops import allocate, preempt

    st, sess, state, view, tiers = fx.st, fx.sess, fx.state, fx.view, fx.tiers
    q_active = preempt._round_gate(st, sess, state, "preempt", view)
    _, perm = preempt._queue_perm(st, sess, state, tiers, q_active)
    q = perm[:1]
    shared = allocate._selection_shared(st, sess, state, tiers, None)
    j, g, has_grp, req, budget = allocate.select_turns(st, sess, state, tiers, 4096, "preempt",
                                                       shared, q, st.queue_valid[q] & q_active[q])
    was_ready = shared[3][j]
    need = (sess.min_avail[j] - state.job_ready_cnt[j]).clamp(min=0)
    budget = preempt._phase_budget("preempt", budget, was_ready, need, has_grp, shared[0][g], 4096)
    P = view.idx.shape[0]
    scope = view.running(state.task_status) & (view.job != j) & (view.queue == q)
    victims = preempt._victim_verdict(st, state, sess, tiers, scope, j.expand(P),
                                      req.expand(P, req.shape[1]), view) & has_grp
    node_rank, node_cum = view.layouts.by_node_queue.rank_and_cum(victims)
    return (*preempt.claim_aggregates(st, view, victims), state.node_ports, state.node_num_tasks,
            victims, view.node, view.resreq, node_rank, node_cum, g, req[0].contiguous(), budget,
            has_grp, was_ready, need, 4096, True, True)


def k6_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import claim_nodes as k6

    args = k6_inputs(fx)
    got = k6.claim_nodes(fx.st, *args)
    want = k6.claim_nodes_plain(fx.st_cpu, *to_cpu(args))
    err = 0.0
    for a, b in zip(got, want):
        err = max(err, max_err(a, b))
        expect(torch.equal(a.cpu(), b), "K6 differs from its plain version")
    expect(int(got[3].sum()) > 0 and int(got[2][0]) > 0, "K6 inputs evicted or placed nothing")
    ms = cuda_ms(lambda: k6.claim_nodes(fx.st, *args))
    plain_ms = cuda_ms(lambda: k6.claim_nodes_plain(fx.st, *args), reps=5)
    N, R = args[1].shape
    W = args[4].shape[1]
    P = args[6].shape[0]
    # node aggregates, ports, counts and static flags read once; the
    # panel's victims, nodes, resreq, ranks and cumulatives read once;
    # p, cum and evict written
    nbytes = N * (4 + 12 * R + 4 * W + 4 + 4 + 4 + 2) + P * (1 + 4 + 4 * R + 4 + 4 * R) \
        + N * 8 + P
    b, by = bound_ms(nbytes, N * 12 * R + P * 3 * R)
    return dict(name="claim_nodes", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, shape=f"N={N}, R={R}, panel P={P}")


def canon_inputs(fx):
    """The reclaim entry state and the first turn that claims."""
    from kube_arbitrator_tpu_torch.ops import allocate, preempt
    from kube_arbitrator_tpu_torch.ops.kernels.canon_pick import canon_pick

    st, sess, tiers = fx.st, fx.sess, fx.tiers
    state = allocate._copy(fx.state0)
    state.progress = torch.zeros((), dtype=torch.bool, device=st.device)
    state.rounds = 0
    ctx = preempt._canon_ctx(st, sess)
    carry = preempt._canon_seed(st, state, ctx)
    nq, perm = preempt._canon_round_order(st, sess, tiers, state, carry)
    for qi in range(int(nq)):
        q = perm[qi:qi + 1]
        shared = preempt._reclaim_shared(st, sess, state, tiers, carry.job_consumed)
        j, g, has_grp, req, pop, burn = preempt._reclaim_pop(st, sess, state, tiers, shared, q,
                                                             carry.q_entries[q])
        i32 = torch.int32
        pick_args = (ctx, carry.cand, carry.rank_nj, carry.cum_nq, state.job_ready_cnt,
                     sess.min_avail, state.queue_alloc, state.node_ports, state.node_num_tasks,
                     q.to(i32), g.to(i32), has_grp, pop, req, True, False, True)
        commit_turn = (q.to(i32), j.to(i32), g.to(i32), has_grp, pop, burn, req, True, False)
        if int(canon_pick(st, *pick_args)) < st.num_nodes:
            return ctx, state, carry, pick_args, commit_turn
    raise SmokeFailure("no reclaim turn of the first round claims")


def k7_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import canon_pick as k7

    ctx, state, carry, pick_args, _ = canon_inputs(fx)
    got = k7.canon_pick(fx.st, *pick_args)
    want = k7.canon_pick_plain(fx.st_cpu, *to_cpu(pick_args))
    expect(torch.equal(got.cpu(), want), f"K7 differs: {int(got)} vs {int(want)}")
    ms = cuda_ms(lambda: k7.canon_pick(fx.st, *pick_args))
    plain_ms = cuda_ms(lambda: k7.canon_pick_plain(fx.st, *pick_args), reps=5)
    N = fx.st.num_nodes
    Vp, R = ctx.cres.shape
    F = carry.cum_nq.shape[1]
    mask_v = carry.cand
    stat = torch.cat([mask_v.float()[:, None], torch.where(mask_v[:, None], ctx.cres, 0.0)], 1)
    idx = ctx.cnode.clamp(max=N - 1).long()
    acc = torch.zeros((N, R + 1), device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, stat))
    W = fx.st.node_ports.shape[1]
    nbytes = Vp * (1 + 4 + 4 * F + 4 + 4 + 4 * F + 4 * R) + N * (4 + 4 * W + 4 + 4 + 4 + 3) + 4
    b, by = bound_ms(nbytes, Vp * (2 * F + R + 3) + N * (R + 4))
    return dict(name="canon_pick", max_abs_err=float(abs(int(got) - int(want))), ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms,
                shape=f"Vp={Vp}, N={N}, R={R}")


def k8_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.kernels import canon_commit as k8
    from kube_arbitrator_tpu_torch.ops.kernels.canon_pick import canon_pick

    ctx, state, carry, pick_args, turn = canon_inputs(fx)
    pick = canon_pick(fx.st, *pick_args)
    s_gpu, c_gpu = allocate._copy(state), dataclasses.replace(carry, **{
        f.name: getattr(carry, f.name).clone() for f in dataclasses.fields(carry)})
    s_cpu, c_cpu = to_cpu(state), to_cpu(carry)
    k8.canon_commit(fx.st, ctx, s_gpu, c_gpu, pick, *turn)
    k8.canon_commit_plain(fx.st_cpu, to_cpu(ctx), s_cpu, c_cpu, pick.cpu(), *to_cpu(turn))
    err = 0.0
    for obj_g, obj_c in ((s_gpu, s_cpu), (c_gpu, c_cpu)):
        for f in dataclasses.fields(obj_c):
            a, b = getattr(obj_g, f.name), getattr(obj_c, f.name)
            if isinstance(b, torch.Tensor):
                err = max(err, max_err(a, b))
                expect(torch.equal(a.cpu().reshape(b.shape), b), f"K8 {f.name} differs from its plain version")
    expect(int(c_gpu.evicted_c.sum()) > 0, "K8 inputs evicted nothing")
    work_s, work_c = allocate._copy(state), dataclasses.replace(carry, **{
        f.name: getattr(carry, f.name).clone() for f in dataclasses.fields(carry)})

    def setup():
        for obj, src in ((work_s, state), (work_c, carry)):
            for f in dataclasses.fields(src):
                v = getattr(src, f.name)
                if isinstance(v, torch.Tensor):
                    getattr(obj, f.name).copy_(v)

    ms = cuda_ms(lambda: k8.canon_commit(fx.st, ctx, work_s, work_c, pick, *turn), setup=setup)
    plain_ms = cuda_ms(lambda: k8.canon_commit_plain(fx.st, ctx, work_s, work_c, pick, *turn),
                       reps=5, setup=setup)
    W, R = fx.st.rv_window, ctx.cres.shape[1]
    F = carry.cum_nq.shape[1]
    # the window's canon slots read once and its flags / scans written;
    # the touched job, queue and node rows read and written; the evicted
    # tasks' three audit fields written
    n_ev = int(c_gpu.evicted_c.sum())
    nbytes = W * (1 + 4 + 4 * F + 4 + 4 + 4 * F + 4 * R + 1 + 1 + 4) + W * (1 + 1 + 4 + 4 * F) \
        + 2 * (n_ev + 1) * 2 * (4 * R + 4) + 12 * n_ev + 64
    b, by = bound_ms(nbytes, W * (3 * R + 2 * F + 4))
    return dict(name="canon_commit", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, shape=f"window W={W}, R={R}, {n_ev} evicted")


# ---- K9-K12: the immediate path's own inputs (binpack 100k x 10k, the
# pod-affinity evictive world 50k x 5k)


def first_turn(st, sess, tiers, state):
    """The group, request and budget of the next round's first queue turn,
    selected as ops/allocate._process_queue selects them."""
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.fairness import overused

    over = overused(state.queue_alloc, sess.deserved)
    grp_live = allocate.group_live_mask(st, sess, state.group_placed, state.group_unfit, False)
    q_active = st.queue_valid & allocate.queue_has_live_job(st, grp_live) & ~over
    _, perm = allocate.queue_perm(tiers, q_active, state.queue_alloc, sess.deserved,
                                  st.queue_uid_rank)
    q = perm[:1]
    shared = allocate._selection_shared(st, sess, state, tiers, False)
    _, g, _, req, budget = allocate.select_turns(st, sess, state, tiers, 4096, "allocate", shared,
                                                 q, st.queue_valid[q] & ~over[q])
    return g, req[0].contiguous(), budget


def turn_fixture(dev):
    """The binpack world at full width, seed 42: its entry state (every
    node idle: the binpack keys tie at -0.0) and the state after two
    allocate rounds."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import allocate, cycle
    from kube_arbitrator_tpu_torch.ops.ordering import with_node_order

    arrays, _ = build_synthetic_arrays(FULL["tasks"], FULL["nodes"], FULL["queues"],
                                       FULL["tasks_per_job"], 42)
    st = from_numpy(arrays, dev)
    tiers = with_node_order("binpack")
    sess, state0 = cycle.open_session(st, tiers)
    mid = allocate.allocate_action(st, sess, state0, tiers, max_rounds=2)
    return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, tiers=tiers,
                                 state0=state0, mid=mid)


def turn_caps_args(fx, state, policy):
    g, req, _ = first_turn(fx.st, fx.sess, fx.tiers, state)
    return (state.node_idle, state.node_releasing, state.node_ports, state.node_num_tasks, g, req,
            None, 4096, False, True, policy)


def k9_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9

    err = 0.0
    for state, policy in ((fx.state0, "binpack"), (fx.mid, "binpack"), (fx.mid, "spread")):
        args = turn_caps_args(fx, state, policy)
        k, nperm = k9.turn_caps(fx.st, *args)
        kp, pp = k9.turn_caps_plain(fx.st_cpu, *to_cpu(args))
        err = max(err, max_err(k, kp), max_err(nperm, pp))
        expect(torch.equal(k.cpu(), kp) and torch.equal(nperm.cpu(), pp),
               f"K9 {policy} differs from its plain version")
        expect(int(k[0].sum()) > 0, f"K9 {policy}: no capacity")
    args = turn_caps_args(fx, fx.mid, "binpack")
    ms = cuda_ms(lambda: k9.turn_caps(fx.st, *args))
    plain_ms = cuda_ms(lambda: k9.turn_caps_plain(fx.st, *args), reps=5)
    # the library call for the order: one stable sort of the same keys
    F = 3
    total = fx.st.node_alloc[:, :F]
    used = (total - fx.mid.node_idle[:, :F]).clamp(min=0.0)
    key = torch.where(fx.st.node_valid, -(used / total.clamp(min=1e-30)).amax(dim=-1), 3.0e38)
    lib_ms = cuda_ms(lambda: torch.sort(key, stable=True))
    N, R = fx.mid.node_idle.shape
    W = fx.mid.node_ports.shape[1]
    # idle, releasing and allocatable, ports, counts, limits, class and
    # flags read once; two capacity rows and the order written
    nbytes = N * (3 * 4 * R + 4 * W + 4 + 4 + 4 + 2) + N * 4 * 3
    b, by = bound_ms(nbytes, N * (6 * R + 14))
    return dict(name="turn_caps", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, shape=f"N={N}, R={R}, binpack order")


def k10_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9
    from kube_arbitrator_tpu_torch.ops.kernels import turn_fill as k10

    state = fx.mid
    g, req, budget = first_turn(fx.st, fx.sess, fx.tiers, state)
    k, nperm = k9.turn_caps(fx.st, *turn_caps_args(fx, state, "binpack"))
    names = ("node_idle", "node_releasing", "node_ports", "node_num_tasks", "task_status",
             "task_node")
    base = {n: getattr(state, n) for n in names}
    work = {n: v.clone() for n, v in base.items()}
    cpu = {n: v.cpu() for n, v in base.items()}

    def call(fn, st, tensors, dev_args):
        kk, pp, gg, rr, bb, gp = dev_args
        return fn(st, kk, pp, gg, rr, bb, gp, tensors["node_idle"], tensors["node_releasing"],
                  tensors["node_ports"], tensors["node_num_tasks"], tensors["task_status"],
                  tensors["task_node"], 4096, False, True)

    dev_args = (k, nperm, g, req, budget, state.group_placed)
    placed, use_rel = call(k10.turn_fill, fx.st, work, dev_args)
    pp, up = call(k10.turn_fill_plain, fx.st_cpu, cpu, to_cpu(dev_args))
    err = max_err(placed, pp)
    expect(torch.equal(placed.cpu(), pp) and torch.equal(use_rel.cpu(), up),
           "K10 placed / use_rel differ from the plain version")
    for n in names:
        err = max(err, max_err(work[n], cpu[n]))
        expect(torch.equal(work[n].cpu(), cpu[n]), f"K10 {n} differs from its plain version")
    expect(int(placed) > 0, "K10 inputs placed nothing")

    def setup():
        for n, v in base.items():
            work[n].copy_(v)

    ms = cuda_ms(lambda: call(k10.turn_fill, fx.st, work, dev_args), setup=setup)
    plain_ms = cuda_ms(lambda: call(k10.turn_fill_plain, fx.st, work, dev_args), reps=5,
                       setup=setup)
    N, R = state.node_idle.shape
    W = state.node_ports.shape[1]
    T = state.task_status.shape[0]
    n_nodes = int(((base["node_num_tasks"] != work["node_num_tasks"])).sum())
    # two capacity rows and the order read; the touched node rows read
    # and written; the task axis's group, rank and validity read, the
    # group's placed tasks written
    nbytes = 3 * N * 4 + n_nodes * 2 * (4 * R + 4 + 4 * W) + T * 9 + int(placed) * 8
    b, by = bound_ms(nbytes, N * 4 + T * 3)
    return dict(name="turn_fill", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None,
                shape=f"N={N}, T={T}, {int(placed)} placed on {n_nodes} nodes")


def pa_fixture(dev):
    """The pod-affinity evictive world at full width, seed 42, on the
    card: the cycle's entry state, and the state after reclaim and three
    allocate rounds (pods placed this cycle, so the counts are live)."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import allocate, cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    w = EVICT_FULL
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], 42,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"], pod_affinity=True)
    st = from_numpy(arrays, dev)
    sess, entry = cycle.open_session(st, tiers)
    state = preempt.reclaim_action(st, sess, entry, tiers)
    state = allocate.allocate_action(st, sess, state, tiers, max_rounds=3)
    groups = [g for g in range(int(st.group_valid.sum()))
              if (arrays["group_aff_terms"][g] >= 0).any() or (arrays["group_anti_terms"][g] >= 0).any()
              or (arrays["symm_ok"].shape[0] and not arrays["symm_ok"][arrays["group_pa_class"][g]].all())]
    aff, cls = arrays["group_aff_terms"], arrays["group_pa_class"]
    # self-affinity groups: at the cycle's entry nothing of theirs is
    # placed, so their fit seeds
    self_aff = [g for g in groups if aff.shape[1] and aff[g, 0] >= 0
                and arrays["aff_match"][aff[g, 0], cls[g]]]
    return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, tiers=tiers,
                                 entry=entry, state=state, groups=groups, self_aff=self_aff)


def k11_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11

    st, state = fx.st, fx.state
    err, seeds, caps, blocked, fits = 0.0, [], [], 0, {}
    cases = [(fx.entry, g) for g in fx.self_aff[:4]]
    cases += [(state, g) for g in sorted(set(fx.groups[::4] + fx.groups[1:40:4]))]
    for state, g in cases:
        gt = torch.tensor([g], device=dev)
        got = k11.pa_fit(st, gt, state.task_status, state.task_node)
        want = k11.pa_fit_plain(fx.st_cpu, gt.cpu(), state.task_status.cpu(), state.task_node.cpu())
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            err = max(err, max_err(a, b))
            expect(torch.equal(a.cpu(), b), f"K11 group {g}: {name} differs from its plain version")
        blocked += int((~want.ok).sum())
        if bool(want.seed_flags.any()):
            seeds.append((g, state))
        if bool(want.cap_flags.any()):
            caps.append((g, state))
        fits[g, id(state)] = got
    expect(blocked > 0 and seeds and caps, f"K11 inputs: blocked {blocked}, seeds {seeds}, caps {caps}")
    state = fx.state
    g = torch.tensor([caps[0][0]], device=dev)
    ms = cuda_ms(lambda: k11.pa_fit(st, g, state.task_status, state.task_node))
    plain_ms = cuda_ms(lambda: k11.pa_fit_plain(st, g, state.task_status, state.task_node), reps=5)
    # the library call for the counts: one index_add_ of the placed pods'
    # hostname domains
    placed = k11._placed(st, state.task_status, state.task_node)
    key = int(fits[caps[0][0], id(caps[0][1])].cap_keys[0])
    dom = st.node_dom[key][state.task_node[placed].long()].long()
    ones = torch.ones(dom.shape[0], dtype=torch.int32, device=dev)
    acc = torch.zeros(st.num_domains, dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, dom, ones))
    T, N, K = st.num_tasks, st.num_nodes, st.node_dom.shape[0]
    # per task the snapshot status, status, node, validity, group and
    # class read once; per node its K domains read and ok written
    nbytes = T * (4 * 5 + 1) + N * (4 * K + 1)
    b, by = bound_ms(nbytes, T * 6 + N * 4 * K)
    return dict(name="pa_fit", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, shape=f"T={T}, N={N}, K={K}, D={st.num_domains}"), fits, seeds, caps


def k12_case(dev, fx, fits, seeds, caps):
    from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12
    from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9

    st = fx.st
    err = 0.0
    timing = None
    changed = 0
    for (g, state), policy in ((seeds[0], "first_fit"), (caps[0], "first_fit"),
                               (caps[0], "binpack")):
        gt = torch.tensor([g], device=dev)
        fit = fits[g, id(state)]
        k, nperm = k9.turn_caps(st, state.node_idle, state.node_releasing, state.node_ports,
                                state.node_num_tasks, gt, st.group_resreq[g].contiguous(), fit.ok,
                                4096, False, True, policy)
        got = k12.pa_shape(st, fit, k, nperm)
        want = k12.pa_shape_plain(fx.st_cpu, to_cpu(fit), k.cpu(), None if nperm is None else nperm.cpu())
        err = max(err, max_err(got, want))
        expect(torch.equal(got.cpu(), want), f"K12 group {g} {policy} differs from its plain version")
        changed += int(not torch.equal(got, k))
        if timing is None:
            timing = (fit, k, nperm)
    expect(changed > 0, "K12 inputs: no row was shaped")
    fit, k, nperm = timing
    ms = cuda_ms(lambda: k12.pa_shape(st, fit, k, nperm))
    plain_ms = cuda_ms(lambda: k12.pa_shape_plain(st, fit, k, nperm), reps=5)
    # the library call for the seed's sums: one index_add_ of a row by domain
    ndom = st.node_dom[int(fit.seed_keys[0])].long()
    has = ndom >= 0
    idx, row = ndom[has], k[0][has]
    acc = torch.zeros(st.num_domains, dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, row))
    rows, N = k.shape
    folds = int(fit.seed_flags.sum()) + int(fit.cap_flags.sum())
    nbytes = rows * N * 4 * 2 + folds * N * 4
    b, by = bound_ms(nbytes, rows * folds * N * 3)
    return dict(name="pa_shape", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, shape=f"{rows} rows x N={N}, {folds} fold(s), D={st.num_domains}")


# ---- K13-K16: the opt-in reclaim engines' first window of q512_evict,
# and the three compactions at their callers' shapes


def window_fixture(dev):
    """The q512_evict seed-42 world on the card and on the CPU: the
    reclaim entry state after open_session and the optimistic engine's
    first speculation window (its pops, products and picks)."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import cycle, preempt
    from kube_arbitrator_tpu_torch.ops.kernels.round_products import new_products
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    w = Q512_EVICT
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], 42,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, dev)
    sess, state = cycle.open_session(st, tiers)
    state.progress = torch.zeros((), dtype=torch.bool, device=dev)
    ctx = preempt._canon_ctx(st, sess)
    carry = preempt._canon_seed(st, state, ctx)
    use_gang, use_prop, preds_on = preempt._reclaim_flags(tiers)
    RP = preempt._reclaim_panel(st)
    nq, perm = preempt._canon_round_order(st, sess, tiers, state, carry)
    trip = int(nq.clamp(min=1))
    q_panel = perm[torch.arange(RP, device=dev).clamp(max=st.num_queues - 1)]
    in_window = torch.arange(RP, device=dev) < trip
    shared = preempt._reclaim_shared(st, sess, state, tiers, carry.job_consumed)
    pops = preempt.reclaim_select_turns(st, sess, state, tiers, shared, q_panel, carry.q_entries)
    Vp, R = ctx.cres.shape
    prods = preempt._round_products(st, sess, state, ctx, carry, use_gang, use_prop,
                                    new_products(Vp, st.num_nodes, R, dev))
    return types.SimpleNamespace(
        st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, state=state, ctx=ctx, carry=carry,
        flags=(use_gang, use_prop, preds_on), RP=RP, trip=trip, q_panel=q_panel.to(torch.int32),
        in_window=in_window, pops=pops, prods=prods)


def k13_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import round_products as k13

    use_gang, use_prop, _ = fx.flags
    st, ctx, c, s = fx.st, fx.ctx, fx.carry, fx.state
    Vp, R = ctx.cres.shape
    N = st.num_nodes

    def args(st_, ctx_, c_, s_, sess_, out, dirty=None):
        return (st_, ctx_, c_.cand, c_.rank_nj, c_.cum_nq, s_.job_ready_cnt, sess_.min_avail,
                s_.queue_alloc, use_gang, use_prop, out, dirty)

    got = k13.round_products(*args(st, ctx, c, s, fx.sess, k13.new_products(Vp, N, R, dev)))
    want = k13.round_products_plain(*args(fx.st_cpu, to_cpu(ctx), to_cpu(c), to_cpu(s),
                                          to_cpu(fx.sess), k13.new_products(Vp, N, R, "cpu")))
    err = 0.0
    for name, a, b in zip(("elig", "pn", "segcum"), got, want):
        err = max(err, max_err(a, b))
        expect(torch.equal(a.cpu(), b), f"K13 {name} differs from its plain version")
    expect(int(got[0].sum()) > 0, "K13 inputs: no eligible victim")
    # a clear dirty flag leaves the products as they are
    kept = tuple(x.clone() for x in got)
    k13.round_products(*args(st, ctx, c, s, fx.sess, got, torch.zeros(1, dtype=torch.bool,
                                                                        device=dev)))
    c.cand.logical_not_()
    k13.round_products(*args(st, ctx, c, s, fx.sess, got, torch.zeros(1, dtype=torch.bool,
                                                                        device=dev)))
    c.cand.logical_not_()
    expect(all(torch.equal(a, b) for a, b in zip(kept, got)), "K13 wrote under a clear dirty flag")
    out = k13.new_products(Vp, N, R, dev)
    ms = cuda_ms(lambda: k13.round_products(*args(st, ctx, c, s, fx.sess, out)))
    plain_ms = cuda_ms(lambda: k13.round_products_plain(*args(st, ctx, c, s, fx.sess, out)), reps=3)
    # the library call for the per-node sums: one index_add_ (not in slot order)
    elig = got[0]
    stat = torch.cat([elig.float()[:, None], torch.where(elig[:, None], ctx.cres, 0.0)], 1)
    idx = ctx.cnode.clamp(max=N - 1).long()
    acc = torch.zeros((N, R + 1), device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, stat))
    F = c.cum_nq.shape[1]
    nbytes = Vp * (1 + 4 + 4 * F + 4 + 4 + 4 * F + 4 * R + 1) + (N + 1) * 4 + st.num_jobs * 8 \
        + st.num_queues * 4 * R + Vp * (1 + 4 * (R + 1)) + N * 4 * (R + 1)
    b, by = bound_ms(nbytes, Vp * (2 * (R + 1) + 2 * F + 3))
    return dict(name="round_products", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms,
                shape=f"Vp={Vp}, N={N}, R={R} (q512_evict first window)")


def k14_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14

    _, _, preds_on = fx.flags
    st, ctx, s = fx.st, fx.ctx, fx.state
    jp, gp, hgp, reqp, popp, burnp = fx.pops
    _, pn, segcum = fx.prods
    rows = (fx.q_panel, gp, hgp, popp & fx.in_window)

    def args(st_, ctx_, s_, pn_, seg_, q, g, hg, pp, req):
        return (st_, ctx_.skey, seg_, pn_, q, g, hg, pp, req, s_.node_ports, s_.node_num_tasks,
                preds_on)

    q, g, hg, pp = rows
    got = k14.union_fit(*args(st, ctx, s, pn, segcum, q, g, hg, pp, reqp))
    want = k14.union_fit_plain(*args(fx.st_cpu, to_cpu(ctx), to_cpu(s), pn.cpu(), segcum.cpu(),
                                     q.cpu(), g.cpu(), hg.cpu(), pp.cpu(), reqp.cpu()))
    expect(torch.equal(got.cpu(), want), "K14 differs from its plain version")
    N = st.num_nodes
    n_claim = int((got < N).sum())
    expect(n_claim > 1 and int((got == N).sum()) > 0, f"K14 inputs: {n_claim} rows claim")
    ms = cuda_ms(lambda: k14.union_fit(*args(st, ctx, s, pn, segcum, q, g, hg, pp, reqp)))
    plain_ms = cuda_ms(lambda: k14.union_fit_plain(*args(st, ctx, s, pn, segcum, q, g, hg, pp,
                                                         reqp)), reps=3)
    RP = q.shape[0]
    Vp, R = ctx.cres.shape
    W = s.node_ports.shape[1]
    nbytes = Vp * 4 + Vp * 4 * (R + 1) + N * 4 * (R + 1) + N * (4 + 4 * W + 4 + 4 + 3) \
        + RP * (4 + 4 + 2 + 4 * R) + RP * 4
    nops = RP * N * (int(np.ceil(np.log2(Vp))) + 2 * (R + 1) + 8)
    b, by = bound_ms(nbytes, nops)
    return dict(name="union_fit", max_abs_err=float((got.cpu() - want).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                shape=f"RP={RP} rows x N={N}, Vp={Vp}, {n_claim} rows claim (q512_evict first "
                      f"window); library: none, no PyTorch call searches and screens per cell")


def k15_case(dev, fx):
    from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
    from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15

    _, _, preds_on = fx.flags
    st, ctx, s, c = fx.st, fx.ctx, fx.state, fx.carry
    jp, gp, hgp, reqp, popp, burnp = fx.pops
    _, pn, segcum = fx.prods
    N, R = st.num_nodes, ctx.cres.shape[1]
    pick = k14.union_fit(st, ctx.skey, segcum, pn, fx.q_panel, gp, hgp, popp & fx.in_window, reqp,
                         s.node_ports, s.node_num_tasks, preds_on)
    base = dict(q_entries=c.q_entries, job_consumed=c.job_consumed, progress=s.progress)
    rows = (pick, N, fx.q_panel, jp, gp, hgp, reqp, popp, burnp)

    def run(fn, dev_, t):
        ctl, sel = k15.new_gate(R, dev_)
        ctl[k15.TRIP] = fx.trip
        fn(*[r.to(dev_) if isinstance(r, torch.Tensor) else r for r in rows], ctl,
           t["q_entries"], t["job_consumed"], t["progress"], sel)
        return ctl, sel

    g_t = {k: v.clone() for k, v in base.items()}
    c_t = {k: v.cpu() for k, v in base.items()}
    g_ctl, g_sel = run(k15.window_gate, dev, g_t)
    c_ctl, c_sel = run(k15.window_gate_plain, "cpu", c_t)
    for name, a, b in [("ctl", g_ctl, c_ctl)] + list(zip(("sel_i", "sel_b", "sel_req"), g_sel, c_sel)) \
            + [(k, g_t[k], c_t[k]) for k in base]:
        expect(torch.equal(a.cpu(), b), f"K15 {name} differs from its plain version")
    conflicts = int(g_ctl[k15.CONFLICTS])
    expect(bool(g_sel[1][3]) and conflicts > 0, f"K15 inputs: no claim or no conflict ({conflicts})")
    work = {k: v.clone() for k, v in base.items()}
    ctl, sel = k15.new_gate(R, dev)

    def setup():
        for k, v in base.items():
            work[k].copy_(v)
        ctl.zero_()
        ctl[k15.TRIP] = fx.trip

    def gate(fn):
        return lambda: fn(*rows, ctl, work["q_entries"], work["job_consumed"], work["progress"], sel)

    ms = cuda_ms(gate(k15.window_gate), setup=setup)
    plain_ms = cuda_ms(gate(k15.window_gate_plain), reps=5, setup=setup)
    RP = pick.shape[0]
    first = int((pick.cpu() < N).nonzero()[0, 0])
    nbytes = RP * (4 * 4 + 3 + 4 * R) + first * (4 + 1) + 64
    b, by = bound_ms(nbytes, RP * 8)
    return dict(name="window_gate", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None,
                shape=f"RP={RP}, first claim at row {first}, {conflicts} conflicts (q512_evict "
                      f"first window); library: none, the gate is a chain of dependent scalar "
                      f"decisions")


def k17_case(dev, fx):
    """K17 at one round's queue order of the q512_evict world (Q = 512,
    three keys, built as ops/allocate.queue_perm builds them; the case
    timed, and ``queue_perm`` card == CPU), and on key stacks of ties,
    -0.0 beside +0.0, NaN and BIG at Q = 8 / 512 / 4,096 against the plain
    version on the CPU (the card's own sort need not order -0.0 and NaN
    the way jnp.lexsort does)."""
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.fairness import queue_shares
    from kube_arbitrator_tpu_torch.ops.kernels import queue_order as k17
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers
    from kube_arbitrator_tpu_torch.ops.ordering import queue_order_keys

    st, s, sess = fx.st, fx.state, fx.sess
    q_active = st.queue_valid & (fx.carry.q_entries > 0)
    args = (q_active, s.queue_alloc, sess.deserved, st.queue_uid_rank)
    _, perm = allocate.queue_perm(tiers, *args)
    _, perm_cpu = allocate.queue_perm(tiers, *[a.cpu() for a in args])
    expect(torch.equal(perm.cpu(), perm_cpu), "K17: the card's queue order differs from the CPU's")
    q_share = queue_shares(s.queue_alloc, sess.deserved)
    keys = [torch.where(q_active, k, 3.0e38) for k in queue_order_keys(tiers, q_share, st.queue_uid_rank)]
    keys = torch.stack([torch.where(q_active, 0.0, 1.0)] + [k.to(torch.float32) for k in keys])
    got = k17.queue_order(keys, q_active)
    want = k17.queue_order_plain(keys.cpu(), q_active.cpu())
    expect(torch.equal(got[0].cpu(), want[0]) and int(got[1]) == int(want[1]),
           "K17 differs from its plain version at the q512 round")
    pool = np.array([0.0, -0.0, 1.0, 0.5, -2.0, np.nan, 3.0e38, 3.0], np.float32)
    rng = np.random.default_rng(17)
    for Q in (8, 512, 4096):
        for _ in range(3):
            kk = pool[rng.integers(0, len(pool), (3, Q))]
            kk[0] = rng.random(Q) < 0.3
            act = torch.from_numpy(kk[0] == 0)
            g = k17.queue_order(torch.from_numpy(kk).to(dev), act.to(dev))
            w = k17.queue_order_plain(torch.from_numpy(kk), act)
            expect(torch.equal(g[0].cpu(), w[0]) and int(g[1]) == int(w[1]),
                   f"K17 differs from its plain version on ties / -0.0 / NaN keys at Q = {Q}")
    zeros = torch.tensor([[0.0, -0.0, float("nan"), 1.0, -0.0, 0.0]], device=dev)
    order = k17.queue_order(zeros, torch.ones(6, dtype=torch.bool, device=dev))[0].tolist()
    expect(order == [0, 1, 4, 5, 3, 2], f"K17 orders [0, -0, nan, 1, -0, 0] as {order}")
    ms = cuda_ms(lambda: k17.queue_order(keys, q_active))
    plain_ms = cuda_ms(lambda: k17.queue_order_plain(keys, q_active))
    lib_ms = cuda_ms(lambda: torch.sort(keys[0], stable=True))
    K, Q = keys.shape
    b, by = bound_ms(K * Q * 4 + Q + Q * 8 + 4, K * Q * Q)
    return dict(name="queue_order", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms,
                shape=f"[K, Q] = [{K}, {Q}] (q512_evict's first reclaim round); ties / -0.0 / NaN "
                      f"keys at Q = 8, 512, 4096; library: torch.sort(stable=True) of one key")


def delta_plan(prev, new):
    """The rows a DeviceResident scatters for the epoch ``prev`` ->
    ``new`` (fields changed in at most half their rows): (names, indices,
    rows)."""
    from kube_arbitrator_tpu_torch.cache.arena import changed_fields, changed_rows

    names, idxs, rows = [], [], []
    for name in changed_fields(prev, new):
        if name == "rv_window":
            continue
        r = changed_rows(new[name], prev[name])
        if isinstance(r, str) or 2 * len(r) > max(new[name].shape[0], 1):
            continue
        names.append(name)
        idxs.append(r.astype(np.int32))
        rows.append(new[name][r])
    return names, idxs, rows


def k18_case(dev):
    """K18 on every field dtype and rank with duplicate rows and on an
    empty epoch, and at the serving path's shapes: the rows phase 7's
    first delta epoch scatters into the 50k x 5k evictive pack (4% of
    the running tasks completed, 1% of the nodes cordoned) — the case
    timed."""
    from kube_arbitrator_tpu_torch.ops.kernels import row_scatter as k18

    rng = np.random.default_rng(18)
    bufs, idxs, rows = [], [], []
    for dtype, shape in ((np.bool_, (97,)), (np.int32, (97,)), (np.float32, (97,)),
                         (np.bool_, (97, 3)), (np.bool_, (97, 8)), (np.int32, (97, 2)),
                         (np.float32, (97, 4))):
        bufs.append((rng.random(shape) * 100).astype(dtype))
        i = np.sort(rng.choice(97, 20, replace=False)).astype(np.int32)
        i = np.concatenate([i, i[-3:]])
        r = (rng.random((len(i),) + shape[1:]) * 100).astype(dtype)
        r[-3:] = r[-6:-3]
        idxs.append(i)
        rows.append(r)
    card = [torch.from_numpy(b.copy()).to(dev) for b in bufs]
    host = [torch.from_numpy(b.copy()) for b in bufs]
    n0 = k18.row_scatter.launches
    k18.row_scatter(card, idxs, rows)
    k18.row_scatter_plain(host, idxs, rows)
    expect(k18.row_scatter.launches == n0 + 1, "K18: one launch for seven fields")
    expect(all(torch.equal(a.cpu(), b) for a, b in zip(card, host)),
           "K18 differs from its plain version (field dtypes, ranks, duplicate rows)")
    k18.row_scatter(card, [np.zeros(0, np.int32)] * len(card), [r[:0] for r in rows])
    expect(k18.row_scatter.launches == n0 + 1 and all(torch.equal(a.cpu(), b) for a, b in zip(card, host)),
           "K18: an empty epoch launched or wrote")

    prev, new, _ = serve_epoch_pair()
    names, idxs, rows = delta_plan(prev, new)
    base = [torch.from_numpy(np.array(prev[n])).to(dev) for n in names]
    card = [b.clone() for b in base]
    plain = [b.clone() for b in base]
    k18.row_scatter(card, idxs, rows)
    k18.row_scatter_plain(plain, idxs, rows)
    want = [torch.from_numpy(np.array(new[n])) for n in names]
    expect(all(torch.equal(a.cpu(), w) and torch.equal(p.cpu(), w)
               for a, p, w in zip(card, plain, want)), "K18 at the serving epoch differs")
    ms = cuda_ms(lambda: k18.row_scatter(card, idxs, rows))
    plain_ms = cuda_ms(lambda: k18.row_scatter_plain(plain, idxs, rows))
    idx_dev = [torch.from_numpy(i.astype(np.int64)).to(dev) for i in idxs]
    rows_dev = [torch.from_numpy(np.ascontiguousarray(r)).to(dev) for r in rows]

    def library():
        for c, i, r in zip(card, idx_dev, rows_dev):
            c.index_copy_(0, i, r)

    lib_ms = cuda_ms(library)
    nrows = sum(len(i) for i in idxs)
    rbytes = sum(r.nbytes for r in rows)
    ibytes = sum(i.nbytes for i in idxs)
    b, by = bound_ms(2 * rbytes + ibytes, 0)
    return dict(name="row_scatter", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms,
                shape=f"{len(names)} fields, {nrows} rows, {rbytes + ibytes} bytes (the 50k x 5k "
                      f"evictive pack's first delta epoch: {', '.join(names)}); library: one "
                      f"index_copy_ per field with rows and indices already on the card")


def k19_case(dev, fx):
    """K19 at its three callers' shapes in the 50k x 5k evictive world,
    each against its plain version run on the CPU (never against the
    card's own torch.sort): preempt's (node, queue) victim lexsort over
    the full-width panel, P = 51,200 (uid, priority, queue, node; seeded
    priorities in -3..3 on the real slots, INT_MAX on the padding; the
    case timed); the claim-log join, J = 512 claims sorted and T = 51,200
    task keys looked up; segment_order at 102,400 slots -> 1,024 segments
    with out-of-range slots, and the one-segment case of ordered_sum."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.ops import preempt
    from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4
    from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19

    st, s = fx.st, fx.state
    T = st.num_tasks
    rng = np.random.default_rng(19)
    running0 = (s.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (s.task_node >= 0)
    view = preempt._build_view(st, s, running0, T)
    idx = view.idx.clamp(max=T - 1).to(torch.int64)
    uid = torch.where(view.valid, st.task_uid_rank[idx], INT_MAX).to(torch.int32)
    prio = torch.from_numpy(rng.integers(-3, 4, T).astype(np.int32)).to(dev)
    prio = torch.where(view.valid, prio, INT_MAX).to(torch.int32)
    keys = (uid, prio, view.queue, view.node)
    got = k19.stable_sort(keys, want_sorted=True)
    want = k19.stable_sort_plain([k.cpu() for k in keys], want_sorted=True)
    expect(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
           "K19 victim lexsort differs from its plain version")
    expect(bool((prio < 0).any()) and bool((prio == INT_MAX).any()), "K19 keys lack negatives / padding")
    # the claim-log join: one claim per job, 3/4 of the rows used
    J = 512
    G = int(st.group_valid.sum())
    n = min(J, G) * 3 // 4
    log_g = np.full(J, -1, np.int64)
    log_g[:n] = rng.permutation(G)[:n]
    size = st.group_size.cpu().numpy()
    log_r = np.where(log_g >= 0, rng.integers(0, np.maximum(size[np.maximum(log_g, 0)], 1)), 0)
    claim_key = torch.from_numpy(np.where(log_g >= 0, log_g * (T + 1) + log_r, INT_MAX)
                                 .astype(np.int32)[rng.permutation(J)]).to(dev)
    task_key = (st.task_group.clamp(0, st.num_groups - 1) * (T + 1) + st.task_group_rank).to(torch.int32)

    def join(ck, tk, sort, lookup):
        order, ks = sort((ck,), want_sorted=True)
        return (order, ks) + tuple(lookup(ks, tk))

    gj = join(claim_key, task_key, k19.stable_sort, k19.sorted_lookup)
    wj = join(claim_key.cpu(), task_key.cpu(), k19.stable_sort_plain, k19.sorted_lookup_plain)
    expect(all(torch.equal(a.cpu(), b) for a, b in zip(gj, wj)), "K19 claim join differs from its plain version")
    expect(int(gj[3].sum()) > 0, "K19 claim join found no task")
    # segment_order: out-of-range slots, then one segment (ordered_sum's)
    S, Ts = 1024, 102_400
    sidx = torch.from_numpy(rng.integers(-3, S + 4, Ts).astype(np.int32))
    for ix, nseg in ((sidx, S), (torch.zeros(Ts, dtype=torch.int32), 1)):
        a, b = k4.segment_order(ix.to(dev), nseg), k4.segment_order(ix, nseg)
        expect(torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1]),
               f"K19 segment_order differs from its plain version at S = {nseg}")
    sidx_d = sidx.to(dev)
    ms = cuda_ms(lambda: k19.stable_sort(keys))
    join_ms = cuda_ms(lambda: join(claim_key, task_key, k19.stable_sort, k19.sorted_lookup))
    seg_ms = cuda_ms(lambda: k4.segment_order(sidx_d, S))
    plain_ms = cuda_ms(lambda: k19.stable_sort_plain(keys), reps=5)
    lib_ms = cuda_ms(lambda: torch.sort(view.node, stable=True))
    b, by = bound_ms(len(keys) * T * 4 + T * 4, 0)
    print(f"kernel stable_sort: claim join (J={J} sort + T={T} lookups) {join_ms:.4f} ms, "
          f"segment_order {Ts} -> {S} {seg_ms:.4f} ms", flush=True)
    return dict(name="stable_sort", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, join_ms=join_ms, segment_order_ms=seg_ms,
                shape=f"4 keys i32[{T}] (preempt's by_node_queue victim layout); library: "
                      f"torch.sort(stable=True) of one key")


def k20_case(dev):
    """K20 at _reclaim_fast's cumulative shapes, [51,200, 3] (the fair
    resources, the case timed) and [51,200, 4], and a [V] column, on
    fractional values whose totals pass 2^24 with -0.0 among them:
    bit for bit its plain version run on the CPU."""
    from kube_arbitrator_tpu_torch.ops import common
    from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20

    rng = np.random.default_rng(20)
    V = 51_200
    err = 0.0
    for C in (3, 4, 1):
        x = (rng.integers(1, 64_000, (V, C)) * rng.random((V, C))).astype(np.float32)
        x[rng.random((V, C)) < 0.02] = -0.0
        xc = torch.from_numpy(x)
        want = k20.ordered_scan_plain(xc)
        got = (k20.ordered_scan(xc.to(dev)) if C > 1 else common.mm_cumsum(xc[:, 0].to(dev))[:, None]).cpu()
        err = max(err, max_err(got, want))
        expect(torch.equal(got.view(torch.int32), want.view(torch.int32)),
               f"K20 differs from its plain version at [{V}, {C}]")
        expect(float(want[-1, 0]) > 2**24, "K20 inputs: the total does not pass 2^24")
    x = torch.from_numpy((rng.integers(1, 64_000, (V, 3)) * rng.random((V, 3))).astype(np.float32)).to(dev)
    ms = cuda_ms(lambda: k20.ordered_scan(x))
    plain_ms = cuda_ms(lambda: k20.ordered_scan_plain(x), reps=5)
    lib_ms = cuda_ms(lambda: torch.cumsum(x, dim=0))
    b, by = bound_ms(2 * V * 3 * 4, V * 3)
    return dict(name="ordered_scan", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms,
                shape=f"f32[{V},3] (_reclaim_fast's proportion cumulative); library: "
                      f"torch.cumsum (another add order)")


def k16_case(dev, efx, tfx):
    """B7 at T = 102,400 (the case timed), B4 on the allocate world's
    feasibility cells at [K, 10,240], B11 on the evictive world's running
    tasks at P = T = 51,200."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.cycle import decode_caps
    from kube_arbitrator_tpu_torch.ops.kernels import stable_compact as k16
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    rng = np.random.default_rng(16)
    T = 102_400
    cap = decode_caps(T)[0]
    mask = torch.from_numpy(rng.random(T) < 0.6).to(dev)  # more set than cap
    cells = allocate._prune_cells(tfx.st, tfx.state0, tiers, False)
    N = tfx.st.num_nodes
    st_e = efx.st
    running0 = (efx.state.task_status == int(TaskStatus.RUNNING)) & st_e.task_valid \
        & (efx.state.task_node >= 0)
    Te = st_e.num_tasks
    cases = (("B7", mask[None, :], cap, -1), ("B4", cells, N // 4, N),
             ("B11", running0[None, :], Te, Te))
    err, times = 0.0, {}
    for name, m, cp, pad in cases:
        gi, gc = k16.stable_compact(m, cp, pad)
        m_cpu = m.mask().cpu() if isinstance(m, k16.FeasCells) else m.cpu()
        pi, pc = k16.stable_compact_plain(m_cpu, cp, pad)
        err = max(err, max_err(gi, pi), max_err(gc, pc))
        expect(torch.equal(gi.cpu(), pi) and torch.equal(gc.cpu(), pc),
               f"K16 {name} differs from its plain version")
        times[name] = cuda_ms(lambda: k16.stable_compact(m, cp, pad))
    expect(int(mask.sum()) > cap, "K16 B7 inputs: the count does not pass cap")

    def nonzero_pad():
        idx = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        nz = torch.nonzero(mask).reshape(-1)[:cap]
        idx[:nz.numel()] = nz
        return idx, mask.sum()

    ms = times["B7"]
    plain_ms = cuda_ms(lambda: k16.stable_compact_plain(mask[None, :], cap, -1), reps=5)
    lib_ms = cuda_ms(nonzero_pad)
    b, by = bound_ms(T + cap * 4 + 4, T * 2)
    print(f"kernel stable_compact: B4 [{cells.shape[0]},{N}] cap {N // 4} {times['B4']:.4f} ms, "
          f"B11 T={Te} {times['B11']:.4f} ms", flush=True)
    return dict(name="stable_compact", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, b4_ms=times["B4"], b11_ms=times["B11"],
                shape=f"B7 mask bool[{T}] -> i32[{cap}] (count past cap); library: "
                      f"torch.nonzero + pad (a host sync)")


def pa_invariants(st, dec, seed) -> dict:
    """The pod-affinity world's own guarantees: every self-anti-affinity
    job holds at most one placed pod per node (hostname domain), every
    self-affinity job's placed pods lie in one rack; returns counts."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.cache import synth

    tj = st.task_job.cpu().numpy()
    valid = st.task_valid.cpu().numpy()
    J = int(tj[valid].max()) + 1
    running_job = np.zeros(J, bool)
    running_job[tj[valid & (st.task_status.cpu().numpy() == int(TaskStatus.RUNNING))]] = True
    _, pending_terms, _ = synth.pa_world_labels(seed, J, running_job)
    status, node = dec.task_status.cpu().numpy(), dec.task_node.cpu().numpy()
    placed = valid & ((status == int(TaskStatus.ALLOCATED)) | (status == int(TaskStatus.PIPELINED))) \
        & (node >= 0)
    n_anti = n_aff = 0
    for k, terms in pending_terms.items():
        term = terms[0]
        if term.label != ("app", f"job-{k}"):
            continue
        nodes = node[placed & (tj == k)]
        if not len(nodes):
            continue
        if term.anti:
            n_anti += 1
            expect(len(np.unique(nodes)) == len(nodes), f"self-anti job {k} shares a node")
        else:
            n_aff += 1
            racks = np.unique(synth.node_label_value(synth.RACK_KEY, nodes))
            expect(len(racks) == 1, f"self-affinity job {k} spans racks {racks.tolist()}")
    expect(n_anti > 0 and n_aff > 0, "no self-(anti-)affinity job placed")
    return dict(self_anti_jobs=n_anti, self_aff_jobs=n_aff)


# ---------------------------------------------------------------- phases 2-4


def decide_pack(device, w, stripped: bool) -> dict:
    """decide_world's cycle on a pack whose reclaim canon pack is
    stripped when ``stripped`` (reclaim then runs _reclaim_fast)."""
    from kube_arbitrator_tpu_torch.cli import decide_world
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops.cycle import schedule_cycle

    if not stripped:
        return decide_world(device=device, **w)
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"],
                                       w["seed"], running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    for k in ("rv_idx", "rv_valid", "rv_nj_start", "rv_nq_start", "rv_block_start"):
        arrays[k] = arrays[k][:0]
    arrays["rv_window"] = 0
    stats = {}
    dec = schedule_cycle(from_numpy(arrays, device), actions=w["actions"], stats=stats)
    return dict(decisions=dec, rounds={k: v for k, v in stats.items() if k.startswith("rounds")})


def compare(a, b, fields) -> dict:
    """Per field of ``fields``: equal in shape, dtype and value (tensor or
    host numpy fields)."""
    out = {}
    for f in fields:
        x, y = torch.as_tensor(getattr(a, f)).cpu(), torch.as_tensor(getattr(b, f)).cpu()
        out[f] = x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
    return out


def invariants(st, dec, binds) -> None:
    from kube_arbitrator_tpu_torch.cache.snapshot import DEVICE_EPSILON

    valid = st.node_valid.cpu()
    idle0, idle = st.node_idle.cpu()[valid], dec.node_idle.cpu()[valid]
    # a world may start over-committed in a dim (running tasks placed
    # round-robin); the cycle must not take any dim it draws on below -EPS
    drawn = idle != idle0
    expect(bool((idle[drawn] >= -DEVICE_EPSILON).all()), "the cycle took a node's idle below -EPS")
    tj = st.task_job.cpu().long()
    bind = dec.bind_mask.cpu()
    expect(bool(dec.job_ready.cpu()[tj][bind].all()), "a bind of a job that is not gang-ready")
    nodes = dec.task_node.cpu()[bind].long()
    expect(bool(((nodes >= 0) & (nodes < st.num_nodes)).all()), "a bind off the node axis")
    expect(bool(valid[nodes].all()), "a bind on an invalid node")
    expect(len(binds) == int(dec.bind_count), "decoded bind count disagrees")


def evict_invariants(st, dec) -> None:
    """Every committed eviction was a RUNNING task at the snapshot, has a
    claimant, and is of another queue (reclaim), another job of the same
    queue (preempt phase 1) or the claimant's own job (phase 2); no node
    holds more pods than its limit."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus

    ev = dec.evict_mask.cpu()
    running = int(TaskStatus.RUNNING)
    expect(bool((st.task_status.cpu()[ev] == running).all()), "an eviction of a task that was not RUNNING")
    claimant = dec.evict_claimant.cpu()[ev].long()
    phase = dec.evict_phase.cpu()[ev]
    expect(bool((claimant >= 0).all()), "a committed eviction without a claimant")
    tj = st.task_job.cpu()[ev].long()
    jq = st.job_queue.cpu().long()
    expect(bool(((phase >= 1) & (phase <= 3)).all()), "an eviction without a phase")
    rec, pre, intra = phase == 3, phase == 1, phase == 2
    expect(bool((jq[tj][rec] != jq[claimant][rec]).all()), "a reclaim eviction within its own queue")
    expect(bool(((tj[pre] != claimant[pre]) & (jq[tj][pre] == jq[claimant][pre])).all()),
           "a preempt eviction outside the claimant's queue or of its own job")
    expect(bool((tj[intra] == claimant[intra]).all()), "an intra-job eviction of another job")
    valid = st.node_valid.cpu()
    expect(bool((dec.node_num_tasks.cpu()[valid] <= st.node_max_tasks.cpu()[valid]).all()),
           "a node over its pod limit")


def serve_epochs(w, seed: int, n: int):
    """Epochs 1..n of the serving stream on world ``w``: (epoch, host
    pack, PackMeta), from cache/synth.epoch_stream with SERVE_CHURN of the
    running tasks completing and SERVE_CORDON of the nodes flipping their
    cordon before each epoch after the first."""
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays, epoch_stream

    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], seed,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    return epoch_stream(arrays, n, SERVE_CHURN, SERVE_CORDON, seed)


def serve_epoch_pair():
    """(epoch 1's pack, epoch 2's pack, epoch 2's PackMeta) of the
    serving stream on the 50k x 5k evictive world, seed 42."""
    g = serve_epochs(EVICT_FULL, 42, 2)
    _, prev, _ = next(g)
    _, new, meta = next(g)
    return prev, new, meta


def differing(a, b) -> list:
    """The CycleDecisions fields where ``a`` and ``b`` differ."""
    return [f for f, ok in compare(a, b, [f.name for f in dataclasses.fields(a)]).items() if not ok]


def reclaim_once(device, w, turn_batch, count_syncs=False):
    """(state, ms, syncs): one reclaim_action of world ``w`` from its
    open_session state on ``device``; syncs counted under the CUDA sync
    debug mode when asked (None otherwise)."""
    import warnings

    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"],
                                       w["seed"], running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, device)
    sess, state = cycle.open_session(st, tiers)
    from kube_arbitrator_tpu_torch.ops.kernels.canon_commit import canon_commit

    out = {}
    for tb in RECLAIM_ENGINES if turn_batch == "all" else (turn_batch,):
        syncs = None
        if str(device) != "cpu":
            torch.cuda.synchronize()
        k8_before = canon_commit.launches
        t0 = time.perf_counter()
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    r = preempt.reclaim_action(st, sess, state, tiers, turn_batch=tb)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = sum(1 for x in caught if "synchroniz" in str(x.message))
        else:
            r = preempt.reclaim_action(st, sess, state, tiers, turn_batch=tb)
        if str(device) != "cpu":
            torch.cuda.synchronize()
        out[tb] = (r, (time.perf_counter() - t0) * 1e3, syncs, canon_commit.launches - k8_before)
    return out if turn_batch == "all" else out[turn_batch][0]


def compare_states(a, b) -> list:
    """The AllocState fields (tensors and counters) where ``a`` and
    ``b`` differ."""
    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor) else x == y
        if not same:
            diff.append(f.name)
    return diff


def engines_once(dev, w, count_syncs):
    """The three reclaim engines (canon walk, round-batched, optimistic)
    from one open_session state on the card: every AllocState tensor
    field and the round count equal; per engine its stage time, rounds,
    gated rounds, conflicts, windows, K8 launches (turns; windows for the
    optimistic engine) and (when counted, in a second pass) host syncs."""
    runs = reclaim_once(dev, w, "all")
    base = runs[None][0]
    names = {None: "canon", True: "batched", "optimistic": "optimistic"}
    row = dict(ms={}, counters={}, windows=runs["optimistic"][0].windows, k8_launches={})
    for tb, (r, ms, _, k8) in runs.items():
        diff = [f for f in compare_states(base, r)
                if f not in ("rounds_gated", "claim_conflicts", "windows")]
        expect(not diff, f"{w}: reclaim engine {names[tb]} differs from the canon walk in {diff}")
        row["ms"][names[tb]] = ms
        row["counters"][names[tb]] = [r.rounds, r.rounds_gated, r.claim_conflicts]
        # K8 commits every turn of the canon and batched engines, one
        # claim per window of the optimistic one
        row["k8_launches"][names[tb]] = k8
    expect(row["counters"]["optimistic"][2] > 0, f"{w}: the optimistic engine had no conflict")
    if count_syncs:
        synced = reclaim_once(dev, w, "all", count_syncs=True)
        row["syncs"] = {names[tb]: x[2] for tb, x in synced.items()}
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from kube_arbitrator_tpu_torch.cli import decide_world
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.cycle import CycleDecisions
    from kube_arbitrator_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()

    # ---- phase 1: kernels against their plain versions
    t0 = time.perf_counter()
    built = build.build_all()
    for k, v in build.BUILD_LOG.items():
        print(f"== ptxas {k}\n{v[1][-2000:]}", file=sys.stderr)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s", flush=True)
    rows = {}

    def report(r):
        rows[r["name"]] = r
        print(f"kernel {r['name']}: equal to plain; {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library {r['library_ms']}) "
              f"at {r['shape']}", flush=True)

    fx = evict_fixture(dev)
    for case in (k1_case, k2_case, k3_case, k4_case, k5_case, k6_case, k7_case, k8_case):
        report(case(dev, fx) if case in (k5_case, k6_case, k7_case, k8_case) else case(dev))
    tfx = turn_fixture(dev)
    report(k9_case(dev, tfx))
    report(k10_case(dev, tfx))
    report(k16_case(dev, fx, tfx))
    report(k19_case(dev, fx))
    report(k20_case(dev))
    del fx, tfx
    fx = window_fixture(dev)
    for case in (k13_case, k14_case, k15_case):
        report(case(dev, fx))
    report(k17_case(dev, fx))
    del fx
    report(k18_case(dev))
    fx = pa_fixture(dev)
    r, fits, seeds, caps = k11_case(dev, fx)
    report(r)
    report(k12_case(dev, fx, fits, seeds, caps))
    del fx, fits
    print(f"phase 1 (kernels) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2: whole-cycle parity, card vs CPU, at a size whose
    # totals stay under 2^24
    t0 = time.perf_counter()
    small = dict(tasks=1000, nodes=100, queues=8, tasks_per_job=50, seed=7,
                 running_fraction=0.2, fit_fraction=1.2)
    gpu = decide_world(device=dev, **small)
    cpu = decide_world(device="cpu", **small)
    st_small = cpu["pack"]
    mem_total = float(st_small.node_alloc[st_small.node_valid][:, 1].double().sum())
    expect(mem_total < 2**24, f"phase 2 memory total {mem_total} MiB is not under 2^24")
    fields = [f.name for f in dataclasses.fields(CycleDecisions)]
    eq = compare(gpu["decisions"], cpu["decisions"], fields)
    expect(all(eq.values()), f"card vs CPU cycle differs: {[f for f, ok in eq.items() if not ok]}")
    print(f"parity 1000x100: all {len(fields)} CycleDecisions fields equal (card vs CPU), "
          f"{len(gpu['binds'])} binds", flush=True)
    for w in EVICT_PARITY:
        gpu = decide_world(device=dev, actions=EVICT_ACTIONS, **w)
        cpu = decide_world(device="cpu", actions=EVICT_ACTIONS, **w)
        eq = compare(gpu["decisions"], cpu["decisions"], fields)
        expect(all(eq.values()),
               f"evictive {w}: card vs CPU differs: {[f for f, ok in eq.items() if not ok]}")
        expect(gpu["rounds"] == cpu["rounds"], f"evictive {w}: rounds {gpu['rounds']} vs {cpu['rounds']}")
        n_ev = int(gpu["decisions"].evict_count)
        expect(n_ev > 0, f"evictive {w}: no evictions")
        print(f"parity evictive {w['tasks']}x{w['nodes']} q{w['queues']} running "
              f"{w['running_fraction']}: all {len(fields)} fields equal (card vs CPU), "
              f"{len(gpu['binds'])} binds, {n_ev} evicts, rounds {gpu['rounds']} "
              f"(card {gpu['cycle_ms']:.0f} ms, CPU {cpu['cycle_ms']:.0f} ms)", flush=True)

    for name, w, stripped in PARITY_SLICE3:
        t1 = time.perf_counter()
        gpu = decide_pack(dev, w, stripped)
        cpu = decide_pack("cpu", w, stripped)
        eq = compare(gpu["decisions"], cpu["decisions"], fields)
        expect(all(eq.values()), f"{name}: card vs CPU differs: {[f for f, ok in eq.items() if not ok]}")
        expect(gpu["rounds"] == cpu["rounds"], f"{name}: rounds {gpu['rounds']} vs {cpu['rounds']}")
        expect(int(gpu["decisions"].bind_count) > 0, f"{name}: no binds")
        print(f"parity {name}: all {len(fields)} fields equal (card vs CPU), "
              f"{int(gpu['decisions'].bind_count)} binds, {int(gpu['decisions'].evict_count)} evicts, "
              f"rounds {gpu['rounds']} ({time.perf_counter() - t1:.1f} s)", flush=True)
    # the opt-in reclaim engines: the soak shape at q = 64 under
    # reclaim_optimistic, and reclaim_action(turn_batch=True) alone
    w = SOAK_Q64
    gpu = decide_world(device=dev, actions=OPT_ACTIONS, **w)
    cpu = decide_world(device="cpu", actions=OPT_ACTIONS, **w)
    eq = compare(gpu["decisions"], cpu["decisions"], fields)
    expect(all(eq.values()), f"soak q64 reclaim_optimistic: card vs CPU differs: "
           f"{[f for f, ok in eq.items() if not ok]}")
    expect(gpu["rounds"] == cpu["rounds"], f"soak q64: counters {gpu['rounds']} vs {cpu['rounds']}")
    expect(int(gpu["decisions"].evict_count) > 0, "soak q64: no evictions")
    print(f"parity soak shape q64 {w['tasks']}x{w['nodes']} {OPT_ACTIONS}: all {len(fields)} "
          f"fields equal (card vs CPU), {int(gpu['decisions'].evict_count)} evicts, counters "
          f"{gpu['rounds']}", flush=True)
    states = {d: reclaim_once(d, w, True) for d in (dev, "cpu")}
    eq = compare_states(states[dev], states["cpu"])
    expect(not eq, f"soak q64 turn_batch=True: card vs CPU differs: {eq}")
    print(f"parity soak shape q64 reclaim_action(turn_batch=True): every AllocState field equal "
          f"(card vs CPU), rounds {states[dev].rounds}, gated {states[dev].rounds_gated}",
          flush=True)
    print(f"phase 2 (parity) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: the main path at full width
    t0 = time.perf_counter()
    counts = peak = None
    for i, w in enumerate(WORLDS):
        torch.cuda.synchronize()
        if i == 0:
            kernels.reset_counts()
            torch.cuda.reset_peak_memory_stats()
        g = decide_world(device=dev, **FULL, **w)
        if i == 0:
            counts = kernels.counts()
            peak = torch.cuda.max_memory_allocated()
        c = decide_world(device="cpu", **FULL, **w)
        invariants(g["pack"], g["decisions"], g["binds"])
        eq_int = compare(g["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()),
               f"world {w}: card vs CPU integer decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
        eq_f32 = compare(g["decisions"], c["decisions"], ("node_idle", "queue_alloc", "queue_deserved"))
        expect(g["rounds"] == c["rounds"], f"world {w}: rounds differ {g['rounds']} vs {c['rounds']}")
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"full width {FULL['tasks']}x{FULL['nodes']} {w}: {len(g['binds'])} binds "
              f"(dense fallback {g['binds'].overflowed}), rounds {g['rounds']}, card cycle "
              f"{g['cycle_ms']:.1f} ms {stages}, decode {g['decode_ms']:.1f} ms (CPU cycle "
              f"{c['cycle_ms']:.0f} ms); integer decisions equal, f32 {eq_f32}", flush=True)
    print(f"launches on the allocate path (world seed 42): {counts}; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for k in ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum", "queue_order"):
        expect(counts[k] > 0, f"kernel {k} was not launched on the allocate path")
    print(f"phase 3 (allocate, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 4: the evictive cycle at full width, card only
    t0 = time.perf_counter()
    evict_counts = None
    for seed in (42, 43):
        torch.cuda.synchronize()
        if seed == 42:
            kernels.reset_counts()
            torch.cuda.reset_peak_memory_stats()
        g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=seed, **EVICT_FULL)
        if seed == 42:
            evict_counts = kernels.counts()
            epeak = torch.cuda.max_memory_allocated()
        dec = g["decisions"]
        invariants(g["pack"], dec, g["binds"])
        evict_invariants(g["pack"], dec)
        bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
        phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
        digest = decision_digest(bind, ev)
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"evictive full width {EVICT_FULL['tasks']}x{EVICT_FULL['nodes']} seed {seed}: "
              f"{int(bind.sum())} binds, evicts by phase {phases}, digest {digest}, rounds "
              f"{g['rounds']}, card cycle {g['cycle_ms']:.1f} ms {stages}", flush=True)
        expect(phases[1] > 0 and phases[3] > 0, f"seed {seed}: reclaim or preempt evicted nothing")
        if seed == 42:
            want = EVICT_WORLD_42
            got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest)
            expect(got == want, f"seed 42 differs from the JAX package's decisions: {got} vs {want}")
    print(f"launches on the evictive path (50k x 5k, seed 42): {evict_counts}; peak device "
          f"memory {epeak / 2**30:.2f} GiB", flush=True)
    for k in SLICE2_KERNELS + ("queue_order", "stable_sort"):
        expect(evict_counts[k] > 0, f"kernel {k} was not launched on the evictive path")
    print(f"phase 4 (evictive, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 5: the immediate path at full width — the pod-affinity
    # evictive world and the binpack / spread allocate worlds
    t0 = time.perf_counter()
    pa_counts = order_counts = None
    from kube_arbitrator_tpu_torch.ops import preempt as preempt_mod
    reclaim_pop, fast_turns = preempt_mod._reclaim_pop, [0]

    def counting_pop(*a, **kw):  # one call per _reclaim_fast turn
        fast_turns[0] += 1
        return reclaim_pop(*a, **kw)

    for seed in (42, 43):
        torch.cuda.synchronize()
        if seed == 42:
            kernels.reset_counts()
            preempt_mod._reclaim_pop = counting_pop
        try:
            g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=seed, pod_affinity=True,
                             **EVICT_FULL)
        finally:
            preempt_mod._reclaim_pop = reclaim_pop
        if seed == 42:
            pa_counts = kernels.counts()
        dec = g["decisions"]
        invariants(g["pack"], dec, g["binds"])
        evict_invariants(g["pack"], dec)
        pa_ok = pa_invariants(g["pack"], dec, seed)
        bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
        phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
        digest = decision_digest(bind, ev)
        c = decide_world(device="cpu", actions=EVICT_ACTIONS, seed=seed, pod_affinity=True,
                         **PA_CPU_CHECK)
        gs = decide_world(device=dev, actions=EVICT_ACTIONS, seed=seed, pod_affinity=True,
                          **PA_CPU_CHECK)
        eq_int = compare(gs["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()), f"pa world {PA_CPU_CHECK['tasks']} seed {seed}: card vs CPU "
               f"integer decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"pod-affinity full width {EVICT_FULL['tasks']}x{EVICT_FULL['nodes']} seed {seed}: "
              f"{int(bind.sum())} binds, evicts by phase {phases}, digest {digest}, rounds "
              f"{g['rounds']}, card cycle {g['cycle_ms']:.1f} ms {stages}; {pa_ok}; card == CPU on "
              f"the integer fields at {PA_CPU_CHECK['tasks']}x{PA_CPU_CHECK['nodes']}", flush=True)
        expect(phases[1] > 0 and phases[3] > 0, f"pa seed {seed}: reclaim or preempt evicted nothing")
        if seed == 42:
            got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest)
            expect(got == PA_WORLD_42, f"pa seed 42 differs from the JAX package: {got} vs {PA_WORLD_42}")
    for seed, policy in ((42, "binpack"), (43, "spread")):
        torch.cuda.synchronize()
        if seed == 42:
            kernels.reset_counts()
        g = decide_world(device=dev, node_order=policy, seed=seed, **FULL)
        if seed == 42:
            order_counts = kernels.counts()
        c = decide_world(device="cpu", node_order=policy, seed=seed, **FULL)
        invariants(g["pack"], g["decisions"], g["binds"])
        eq_int = compare(g["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()), f"{policy} seed {seed}: card vs CPU integer decisions differ: "
               f"{[f for f, ok in eq_int.items() if not ok]}")
        bind = g["decisions"].bind_mask.cpu().numpy()
        digest = decision_digest(bind, g["decisions"].evict_mask.cpu().numpy())
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"{policy} full width {FULL['tasks']}x{FULL['nodes']} seed {seed}: {int(bind.sum())} "
              f"binds, digest {digest}, rounds {g['rounds']}, card cycle {g['cycle_ms']:.1f} ms "
              f"{stages} (CPU cycle {c['cycle_ms']:.0f} ms); integer decisions equal", flush=True)
        if seed == 42:
            got = dict(binds=int(bind.sum()), digest=digest)
            expect(got == BINPACK_WORLD_42, f"binpack seed 42 differs from the JAX package: "
                   f"{got} vs {BINPACK_WORLD_42}")
    print(f"launches on the pod-affinity path (50k x 5k, seed 42): {pa_counts}; "
          f"_reclaim_fast turns {fast_turns[0]}", flush=True)
    print(f"launches on the binpack path (100k x 10k, seed 42): {order_counts}", flush=True)
    for k in ("pa_fit", "pa_shape", "turn_caps", "turn_fill", "claim_nodes", "seg_scan",
              "segment_sum", "lex_argmin", "queue_order", "stable_sort", "ordered_scan"):
        expect(pa_counts[k] > 0, f"kernel {k} was not launched on the pod-affinity path")
    # one cumulative a turn for the covering prefix, and one for
    # proportion's victim check when proportion is a reclaim verdict
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers
    per_turn = 1 + ("proportion" in preempt_mod._reclaim_verdict_names(tiers))
    expect(pa_counts["ordered_scan"] == per_turn * fast_turns[0],
           f"K20 launched {pa_counts['ordered_scan']} times over {fast_turns[0]} _reclaim_fast "
           f"turns, not {per_turn} a turn")
    for k in ("turn_caps", "turn_fill", "lex_argmin", "queue_order"):
        expect(order_counts[k] > 0, f"kernel {k} was not launched on the binpack path")
    print(f"phase 5 (immediate path, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 6: the opt-in reclaim engines at full width — q512_evict
    # (seeds 42, 43) and rounds_q4 (seed 42)
    t0 = time.perf_counter()
    opt_counts = None
    engine_rows = []
    for name, w, seeds, pins in (("q512_evict", Q512_EVICT, (42, 43), Q512_WORLD_42),
                                 ("rounds_q4", ROUNDS_Q4, (42,), ROUNDS_Q4_WORLD_42)):
        for seed in seeds:
            row = engines_once(dev, dict(w, seed=seed), count_syncs=seed == 42)
            engine_rows.append(dict(world=name, seed=seed, **row))
            print(f"{name} seed {seed}: the three reclaim engines from one state: "
                  f"{json.dumps(row)}", flush=True)
            torch.cuda.synchronize()
            if opt_counts is None:
                kernels.reset_counts()
                g = decide_world(device=dev, actions=OPT_ACTIONS, seed=seed, **w)
                opt_counts = kernels.counts()
                print(f"{name} seed {seed}: queue orders (K17 launches) in the cycle: "
                      f"{opt_counts['queue_order']}", flush=True)
            else:
                g = decide_world(device=dev, actions=OPT_ACTIONS, seed=seed, **w)
            dec = g["decisions"]
            invariants(g["pack"], dec, g["binds"])
            evict_invariants(g["pack"], dec)
            bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
            phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
            digest = decision_digest(bind, ev)
            counters = [g["stats"][f"{k}.reclaim_optimistic"]
                        for k in ("rounds", "rounds_gated", "claim_conflicts")]
            stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
            print(f"{name} full width {w['tasks']}x{w['nodes']} q{w['queues']} seed {seed} "
                  f"{OPT_ACTIONS}: {int(bind.sum())} binds, evicts by phase {phases}, digest "
                  f"{digest}, reclaim (rounds, gated, conflicts) {counters}, rounds {g['rounds']}, "
                  f"card cycle {g['cycle_ms']:.1f} ms {stages}", flush=True)
            expect(phases[3] > 0 and counters[2] > 0,
                   f"{name} seed {seed}: reclaim evicted nothing or no conflict")
            expect(counters == row["counters"]["optimistic"],
                   f"{name} seed {seed}: the cycle's reclaim counters differ from the engine's")
            if seed == 42:
                got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest,
                           reclaim_counters=counters)
                expect(got == pins, f"{name} seed 42 differs from the JAX package: {got} vs {pins}")
        cw = Q512_CPU_CHECK if name == "q512_evict" else w
        gs = decide_world(device=dev, actions=OPT_ACTIONS, seed=42, **cw)
        c = decide_world(device="cpu", actions=OPT_ACTIONS, seed=42, **cw)
        eq_int = compare(gs["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()), f"{name} at {cw['tasks']}x{cw['nodes']}: card vs CPU "
               f"integer decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
        expect(gs["rounds"] == c["rounds"], f"{name}: counters {gs['rounds']} vs {c['rounds']}")
        print(f"{name} card == CPU on the integer fields and counters at {cw['tasks']}x{cw['nodes']} "
              f"q{cw['queues']} seed 42 (card {gs['cycle_ms']:.0f} ms, CPU {c['cycle_ms']:.0f} ms)",
              flush=True)
    print(f"launches on the optimistic reclaim path (q512_evict, seed 42): {opt_counts}", flush=True)
    for k in ("round_products", "union_fit", "window_gate", "stable_compact", "canon_commit",
              "lex_argmin", "segment_sum", "queue_order"):
        expect(opt_counts[k] > 0, f"kernel {k} was not launched on the optimistic reclaim path")
    print(f"phase 6 (opt-in reclaim engines, full width) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 7: the serving path at full width — the evictive world
    # (seed 42) served for SERVE_EPOCHS epochs through the TorchDecider
    t0 = time.perf_counter()
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.framework import SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.ops.cycle import schedule_cycle
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS

    conf = SchedulerConfig(actions=EVICT_ACTIONS, tiers=DEFAULT_TIERS)
    serve_counts = dict.fromkeys(kernels.counts(), 0)
    decider = TorchDecider(dev)
    full_bytes = None
    for e, host, meta in serve_epochs(EVICT_FULL, 42, SERVE_EPOCHS):
        torch.cuda.synchronize()
        kernels.reset_counts()
        dec, decide_ms = decider.decide(host, conf, meta)
        c = kernels.counts()
        for k, v in c.items():
            serve_counts[k] += v
        row = dict(epoch=e, mode=decider.last_mode, upload_bytes=decider.last_upload_bytes,
                   upload_ms=decider.last_upload_ms, decide_ms=decide_ms,
                   cycle_ms=decider.last_cycle_ms, k18_launches=c["row_scatter"],
                   k17_launches=c["queue_order"], changed_fields=len(meta.changed_fields),
                   binds=int(dec.bind_mask.sum()), evicts=int(dec.evict_mask.sum()))
        diff = decider.resident.first_difference(host)
        expect(diff is None, f"serving epoch {e}: the resident {diff} differs from the host pack")
        fresh = schedule_cycle(from_numpy(host, dev), tiers=DEFAULT_TIERS, actions=EVICT_ACTIONS)
        bad = differing(dec, fresh)
        expect(not bad, f"serving epoch {e}: decisions differ from a fresh upload's in {bad}")
        again, _ = decider.decide(host, conf, meta)
        expect(decider.last_mode == "reuse" and decider.last_upload_bytes == 0,
               f"serving epoch {e}: a repeated key gave {decider.last_mode}, "
               f"{decider.last_upload_bytes} bytes")
        expect(not differing(dec, again), f"serving epoch {e}: the reused pack decides otherwise")
        if e == 1:
            expect(row["mode"] == "full", f"serving epoch 1 uploaded {row['mode']}")
            full_bytes = row["upload_bytes"]
            phases = np.bincount(dec.evict_phase[dec.evict_mask], minlength=4).tolist()
            got = dict(binds=row["binds"], evicts_by_phase=phases,
                       digest=decision_digest(dec.bind_mask, dec.evict_mask))
            expect(got == EVICT_WORLD_42, f"serving epoch 1 differs from the JAX package: {got} "
                   f"vs {EVICT_WORLD_42}")
        else:
            expect(row["mode"] == "delta", f"serving epoch {e} uploaded {row['mode']}")
            expect(row["upload_bytes"] < full_bytes,
                   f"serving epoch {e}: {row['upload_bytes']} bytes, not fewer than {full_bytes}")
            expect(row["k18_launches"] > 0, f"serving epoch {e}: K18 was not launched")
        print(f"serving 50k x 5k seed 42 epoch {json.dumps(row)}; resident == host, decisions == "
              f"a fresh upload's, a repeated key reuses", flush=True)
    for k in SLICE2_KERNELS + ("queue_order", "row_scatter"):
        expect(serve_counts[k] > 0, f"kernel {k} was not launched on the serving path")
    print(f"launches on the serving path (50k x 5k, seed 42, {SERVE_EPOCHS} epochs): {serve_counts}",
          flush=True)
    gpu_d, cpu_d = TorchDecider(dev), TorchDecider("cpu")
    for e, host, meta in serve_epochs(SERVE_CPU_CHECK, 42, SERVE_EPOCHS):
        a, _ = gpu_d.decide(host, conf, meta)
        b, _ = cpu_d.decide(host, conf, meta)
        bad = differing(a, b)
        expect(not bad and gpu_d.last_mode == cpu_d.last_mode,
               f"serving {SERVE_CPU_CHECK['tasks']} epoch {e}: card vs CPU differ in {bad} "
               f"({gpu_d.last_mode} / {cpu_d.last_mode})")
        print(f"serving {SERVE_CPU_CHECK['tasks']}x{SERVE_CPU_CHECK['nodes']} epoch {e}: card == CPU in "
              f"every field ({gpu_d.last_mode}, {gpu_d.last_upload_bytes} bytes; card cycle "
              f"{gpu_d.last_cycle_ms:.1f} ms, CPU {cpu_d.last_cycle_ms:.0f} ms)", flush=True)
    print(f"phase 7 (serving path, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 8: the evictive cycle under the priority mix at full width
    # — preempt's phase 2 and the gated round on the card
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_counts()
    g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=45, **MIX_FULL)
    mix_counts = kernels.counts()
    dec = g["decisions"]
    invariants(g["pack"], dec, g["binds"])
    evict_invariants(g["pack"], dec)
    bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
    phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
    digest = decision_digest(bind, ev)
    stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
    gated = g["stats"]["rounds_gated.preempt"]
    print(f"priority-mix full width {MIX_FULL['tasks']}x{MIX_FULL['nodes']} q{MIX_FULL['queues']} "
          f"seed 45: {int(bind.sum())} binds, evicts by phase {phases}, digest {digest}, rounds "
          f"{g['rounds']}, card cycle {g['cycle_ms']:.1f} ms {stages}", flush=True)
    expect(phases[1] > 0 and phases[2] > 0 and phases[3] > 0,
           f"priority-mix world: a phase evicted nothing: {phases}")
    expect(gated > 0, "priority-mix world: preempt gated no round")
    got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest)
    expect(got == MIX_WORLD_45, f"priority-mix seed 45 differs from the JAX package: {got} vs "
           f"{MIX_WORLD_45}")
    print(f"launches on the priority-mix path (50k x 5k, seed 45): {mix_counts}", flush=True)
    for k in SLICE2_KERNELS + ("queue_order", "stable_sort", "stable_compact"):
        expect(mix_counts[k] > 0, f"kernel {k} was not launched on the priority-mix path")
    gs = decide_world(device=dev, actions=EVICT_ACTIONS, **MIX_CPU_CHECK)
    c = decide_world(device="cpu", actions=EVICT_ACTIONS, **MIX_CPU_CHECK)
    fields = [f.name for f in dataclasses.fields(CycleDecisions)]
    eq = compare(gs["decisions"], c["decisions"], fields)
    # the standing tolerance of queue_deserved (ROADMAP queue C): rtol 1e-5
    qd = (gs["decisions"].queue_deserved.cpu(), c["decisions"].queue_deserved.cpu())
    qd_close = torch.allclose(qd[0], qd[1], rtol=1e-5, atol=0.0)
    bad = [f for f, ok in eq.items() if not ok and f != "queue_deserved"]
    expect(not bad and qd_close, f"priority-mix {MIX_CPU_CHECK['tasks']}: card vs CPU differ in "
           f"{bad} (queue_deserved within rtol 1e-5: {qd_close})")
    expect(gs["rounds"] == c["rounds"], f"priority-mix: rounds {gs['rounds']} vs {c['rounds']}")
    cph = np.bincount(c["decisions"].evict_phase.numpy()[c["decisions"].evict_mask.numpy()],
                      minlength=4).tolist()
    print(f"priority-mix {MIX_CPU_CHECK['tasks']}x{MIX_CPU_CHECK['nodes']} seed "
          f"{MIX_CPU_CHECK['seed']}: card == CPU in every field (queue_deserved exactly equal: "
          f"{eq['queue_deserved']}), evicts by phase {cph}, rounds {gs['rounds']} (card "
          f"{gs['cycle_ms']:.0f} ms, CPU {c['cycle_ms']:.0f} ms)", flush=True)
    print(f"phase 8 (priority mix, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 9: no library sort on the evictive paths — the evictive
    # and pod-affinity evictive cycles (50k x 5k, seed 42) under the profiler
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile

    for name, kw in (("evictive", {}), ("pa_evict", dict(pod_affinity=True))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=42, **kw, **EVICT_FULL)
            torch.cuda.synchronize()
        ops = dict.fromkeys(("aten::sort", "aten::argsort", "aten::searchsorted"), 0)
        for e in prof.key_averages():
            if e.key in ops:
                ops[e.key] = e.count
        dev_ev = [e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        n_kern = sum(1 for e in dev_ev if not e.name.startswith(("Memcpy", "Memset")))
        print(f"profiled {name} cycle (50k x 5k, seed 42): {ops}, {n_kern} device kernels "
              f"({len(dev_ev)} device events), profiled cycle {g['cycle_ms']:.1f} ms", flush=True)
        expect(ops["aten::sort"] == 0 and ops["aten::argsort"] == 0,
               f"the {name} cycle ran a library sort: {ops}")
    print(f"phase 9 (profiled, no library sort) {time.perf_counter() - t0:.1f} s", flush=True)

    replaces = {
        "admit_chunk": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/admit_chunk.cu",
                        "kube_arbitrator_tpu/ops/allocate.py:793"),
        "lex_argmin": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/lex_argmin.cu",
                       "kube_arbitrator_tpu/ops/common.py:49"),
        "decode_deferred": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/decode_deferred.cu",
                            "kube_arbitrator_tpu/ops/allocate.py:1059"),
        "segment_sum": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/segment_sum.cu",
                        "kube_arbitrator_tpu/ops/cycle.py:233"),
        "seg_scan": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/seg_scan.cu",
                     "kube_arbitrator_tpu/ops/preempt.py:129"),
        "claim_nodes": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/claim_nodes.cu",
                        "kube_arbitrator_tpu/ops/preempt.py:439"),
        "canon_pick": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/canon_pick.cu",
                       "kube_arbitrator_tpu/ops/preempt.py:2035"),
        "canon_commit": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/canon_commit.cu",
                         "kube_arbitrator_tpu/ops/preempt.py:2080"),
        "turn_caps": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/turn_caps.cu",
                      "kube_arbitrator_tpu/ops/allocate.py:585"),
        "turn_fill": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/turn_fill.cu",
                      "kube_arbitrator_tpu/ops/allocate.py:645"),
        "pa_fit": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/pa_fit.cu",
                   "kube_arbitrator_tpu/ops/podaffinity.py:73"),
        "pa_shape": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/pa_shape.cu",
                     "kube_arbitrator_tpu/ops/podaffinity.py:173"),
        "round_products": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/round_products.cu",
                           "kube_arbitrator_tpu/ops/preempt.py:2582"),
        "union_fit": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/union_fit.cu",
                      "kube_arbitrator_tpu/ops/preempt.py:2609"),
        "window_gate": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/window_gate.cu",
                        "kube_arbitrator_tpu/ops/preempt.py:2735"),
        "stable_compact": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/stable_compact.cu",
                           "kube_arbitrator_tpu/ops/cycle.py:181"),
        "queue_order": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/queue_order.cu",
                        "kube_arbitrator_tpu/ops/allocate.py:1043"),
        "row_scatter": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/row_scatter.cu",
                        "kube_arbitrator_tpu/cache/arena.py:156"),
        "stable_sort": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/stable_sort.cu",
                        "kube_arbitrator_tpu/ops/preempt.py:118"),
        "ordered_scan": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/ordered_scan.cu",
                         "kube_arbitrator_tpu/ops/common.py:102"),
    }
    kline = []
    for k, r in rows.items():
        if k in ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum"):
            n = counts[k]
        elif k in ("turn_caps", "turn_fill"):
            n = order_counts[k]
        elif k in ("pa_fit", "pa_shape"):
            n = pa_counts[k]
        elif k in ("round_products", "union_fit", "window_gate", "stable_compact"):
            n = opt_counts[k]
        elif k in ("queue_order", "row_scatter"):
            n = serve_counts[k]
        elif k == "stable_sort":
            n = evict_counts[k] + pa_counts[k]
        elif k == "ordered_scan":
            n = pa_counts[k]
        else:
            n = evict_counts[k]
        kline.append(dict(name=k, route="cuda", source=replaces[k][0], replaces=replaces[k][1],
                          launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
                          plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"]))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": kline}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
