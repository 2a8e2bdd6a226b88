#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; imports nothing of JAX.  Phases (any failure
exits non-zero):

1. kernels — builds K1-K8 from kube_arbitrator_tpu_torch/ops/kernels/csrc
   (one nvcc per source, in parallel) and holds each against its plain
   PyTorch version, requiring equality: K1-K4 on seeded inputs at the
   allocate path's shapes (100k tasks, 10k nodes, 1k groups, 8-slot
   chunks), K5-K8 on the inputs the evictive path gives them in the
   50k-task x 5k-node world (its preempt victim panel, its first preempt
   turn, its first claiming reclaim turn).  Times the kernel, the plain
   version and, where one PyTorch call computes the same function
   (K4's and K7's sums: ``Tensor.index_add_``), that call.
2. parity — worlds decided on the card and on the CPU by the port's
   ``schedule_cycle``, every CycleDecisions field equal: 1000 x 100
   (allocate, backfill), and 5k x 500 and 20k x 2k under the evictive conf
   (reclaim, allocate, backfill, preempt).
3. allocate at full width — the ``python -m kube_arbitrator_tpu_torch``
   path on four 100k-task x 10k-node worlds (seeds 42, 43, 44 and one
   capacity-tight world): invariants hold and the integer decisions equal
   the port's CPU run of the same world.
4. the evictive cycle at full width — 50k tasks x 5k nodes, 8 queues,
   half the jobs running, seeds 42 and 43, on the card only: stage times,
   rounds, binds and evictions by phase; invariants; seed 42's counts and
   decision digest equal the JAX package's (EVICT_WORLD_42).

Each path's launch counts are taken over its first world (seed 42), with
every count set to 0 just before it.

Prints the card's name and power limit, a JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``; the
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
        return tuple(to_cpu(v) for v in x)
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


# ---------------------------------------------------------------- phases 2-4


def compare(a, b, fields) -> dict:
    out = {}
    for f in fields:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
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
    name = torch.cuda.get_device_name(0)
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
    fx = evict_fixture(dev)
    for case in (k1_case, k2_case, k3_case, k4_case, k5_case, k6_case, k7_case, k8_case):
        r = case(dev, fx) if case in (k5_case, k6_case, k7_case, k8_case) else case(dev)
        rows[r["name"]] = r
        print(f"kernel {r['name']}: equal to plain; {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, library {r['library_ms']}) "
              f"at {r['shape']}", flush=True)
    del fx

    # ---- phase 2: whole-cycle parity, card vs CPU, at a size whose
    # totals stay under 2^24
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

    # ---- phase 3: the main path at full width
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
    for k in ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum"):
        expect(counts[k] > 0, f"kernel {k} was not launched on the allocate path")

    # ---- phase 4: the evictive cycle at full width, card only
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
    for k, n in evict_counts.items():
        expect(n > 0, f"kernel {k} was not launched on the evictive path")

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
    }
    kline = []
    for k, r in rows.items():
        n = counts[k] if k in ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum") \
            else evict_counts[k]
        kline.append(dict(name=k, route="cuda", source=replaces[k][0], replaces=replaces[k][1],
                          launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
                          plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"]))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": kline}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
