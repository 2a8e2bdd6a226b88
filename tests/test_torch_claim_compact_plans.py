"""K6's ``ClaimNodesPlan`` and K16's one-launch compaction on the CPU,
held against the JAX package (the card's twins, which hold each kernel
against its plain version, are in tests/test_torch_claim_compact_card.py).

* Every K6 launch of whole preempt actions (phase 1 and phase 2) through
  the plan each round loop binds, held against ``claim_nodes_plain`` on
  the turn's own inputs, and the action against the reference's
  ``preempt_action`` in every AllocState field: the 5k x 500 evictive and
  priority-mix worlds under the batched ``_rounds_batched`` and the
  sequential ``_rounds``, and a pod-affinity world (sequential, K11 and
  K12 around K6's two launches).
* K6 edges turn by turn against the reference's ``_apply_claim``: i32 and
  i64 g, no victim, the statement gate dropping the claim, budget 0,
  phase 2's mode, claimants with host ports, nodes whose pods are full,
  uniform and mixed victim sizes.
* The aggregates K6 folds: the kernel's walk (csrc/claim_nodes.cu's
  order, mirrored here) against ``claim_aggregates`` (K4's slot order,
  the scatter max / min) and the reference's scatter expression, and
  ``freed`` likewise.
* K16: the one-row, [K, L], cells and two-row commit forms against
  ``stable_compact_plain`` and the reference's ``_compact_indices``,
  ``_compact_rows`` and ``_build_view``; the launch shape and the
  kernel's span / pad arithmetic, mirrored here.
* The plans' ctypes structs against the C structs.

Inputs are made with numpy from a seed.  Every comparison is exact.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.api.types import TaskStatus
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.ops.kernels import claim_nodes as k6
from kube_arbitrator_tpu_torch.ops.kernels import stable_compact as k16
from kube_arbitrator_tpu_torch.ops.kernels.segment_sum import segment_sum_plain

REF_TIERS = ref_ord.DEFAULT_TIERS
TIERS = port_ord.DEFAULT_TIERS
FIELDS = ("task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed", "job_alloc",
          "queue_alloc", "node_num_tasks", "node_releasing", "node_ports", "evict_claimant",
          "evict_phase", "evict_round", "group_unfit")
RUNNING = int(TaskStatus.RUNNING)
BIG = np.float32(3.0e38)
# the priority-mix world of tests/test_torch_priority_mix.py
MIX_5K = dict(num_tasks=5000, num_nodes=500, num_queues=16, tasks_per_job=100, seed=44,
              running_fraction=0.5, fit_fraction=0.75)


def _ref_pack(arrays):
    """The reference's SnapshotTensors of the port generator's arrays."""
    return ref_snapshot.SnapshotTensors(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k != "rv_window"},
        rv_window=arrays["rv_window"])


@functools.lru_cache(maxsize=None)
def _world(name):
    """(numpy arrays) of one 5k x 500 world: integral capacities, so every
    order of adds gives the same bits."""
    if name == "evictive":  # preempt evicts in phase 1 here (seed 43 at capacity 1.0)
        return build_synthetic_arrays(5000, 500, num_queues=8, tasks_per_job=100, seed=43,
                                      running_fraction=0.5, fit_fraction=1.0)[0]
    if name == "priority_mix":
        return build_synthetic_arrays(**MIX_5K, priority_mix=True)[0]
    return build_synthetic_arrays(5000, 500, num_queues=8, tasks_per_job=50, seed=11,
                                  running_fraction=0.5, fit_fraction=1.25, pod_affinity=True)[0]


@functools.lru_cache(maxsize=None)
def _ref_preempt():
    return (jax.jit(lambda s: ref_cycle.open_session(s, REF_TIERS)),
            jax.jit(lambda s, se, a: ref_pre.preempt_action(s, se, a, REF_TIERS)))


@functools.lru_cache(maxsize=None)
def _preempt_entry(world):
    """(port pack, session, state) at a cycle's preempt entry: after the
    port's reclaim, allocate and backfill (each held against the JAX
    package elsewhere)."""
    pst = from_numpy(_world(world), "cpu")
    psess, state = port_cycle.open_session(pst, TIERS)
    state = port_pre.reclaim_action(pst, psess, state, TIERS)
    state = port_alloc.allocate_action(pst, psess, state, TIERS)
    return pst, psess, port_alloc.backfill_action(pst, psess, state, TIERS)


def _ref_state(state):
    """The reference's AllocState holding the port state's values."""
    def val(x):
        return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else jnp.int32(x)
    return ref_alloc.AllocState(**{f.name: val(getattr(state, f.name))
                                   for f in dataclasses.fields(ref_alloc.AllocState)})


# ---------------------------------------------------------------- the walk K6 folds


def _walk(vnode, node_order, vres, mask, N):
    """csrc/claim_nodes.cu's walk of each node's panel slots in slot
    order: (count i32[N], sums f32[N, R] added one after another from
    +0.0 over the masked slots, max, min f32[N, R] (-BIG / BIG where
    none))."""
    perm, seg_start = (x.numpy() for x in node_order)
    v, m = vres.numpy(), mask.numpy()
    R = v.shape[1]
    nv = np.zeros(N, np.int32)
    tot = np.zeros((N, R), np.float32)
    mx = np.full((N, R), -BIG, np.float32)
    mn = np.full((N, R), BIG, np.float32)
    for n in range(N):
        for s in perm[seg_start[n]:seg_start[n + 1]]:
            if m[s]:
                nv[n] += 1
                tot[n] = (tot[n] + v[s]).astype(np.float32)
                mx[n] = np.maximum(mx[n], v[s])
                mn[n] = np.minimum(mn[n], v[s])
    return tuple(torch.from_numpy(x) for x in (nv, tot, mx, mn))


# ---------------------------------------------------------------- every launch of an action


class _CheckedClaim(k6.ClaimNodesPlan):
    """A ClaimNodesPlan that holds every launch against the plain version
    on the turn's own inputs (and its first launches' folded aggregates
    and freed against the kernel's walk)."""

    binds = launches = walked = 0
    modes: set = set()
    g_dtypes: set = set()
    with_pa: set = set()

    def __init__(self, st, view, s_max, preempt_mode, preds_on, pa=None, aggregates=False):
        super().__init__(st, view, s_max, preempt_mode, preds_on, pa, aggregates=True)
        cls = type(self)
        cls.binds += 1
        cls.modes.add(preempt_mode)
        cls.with_pa.add(pa is not None)
        self.seen = 0

    def __call__(self, *turn):
        cls = type(self)
        args = [t.clone() for t in turn]
        pa = None if self.pa is None else (self.pa[0].fit.ok.clone(), self.pa[1])
        want = k6.claim_nodes_plain(self.st, self.vnode, self.node_order, self.vres, *args,
                                    self.s_max, self.preempt_mode, self.preds_on, pa)
        got = super().__call__(*turn)
        assert got[0] is self.p and got[3] is self.evict and got[4] is self.freed
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if self.seen < 2 and int(turn[0].sum()):
            N = len(self.p)
            for a, b in zip(self.aggs, _walk(self.vnode, self.node_order, self.vres, turn[0], N)):
                assert torch.equal(a, b)
            assert torch.equal(got[4], _walk(self.vnode, self.node_order, self.vres, got[3], N)[1])
            cls.walked += 1
        self.seen += 1
        cls.launches += 1
        cls.g_dtypes.add(turn[5].dtype)
        return got


@pytest.fixture
def checked(monkeypatch):
    _CheckedClaim.binds = _CheckedClaim.launches = _CheckedClaim.walked = 0
    _CheckedClaim.modes, _CheckedClaim.g_dtypes, _CheckedClaim.with_pa = set(), set(), set()
    monkeypatch.setattr(port_pre, "ClaimNodesPlan", _CheckedClaim)
    return monkeypatch


@pytest.mark.parametrize("world", ["evictive", "priority_mix", "pod_affinity"])
def test_every_launch_of_a_preempt_action_matches_reference(checked, world):
    """A whole preempt action (both phases) from a cycle's preempt entry,
    under each engine the world takes: every K6 launch equals the plain
    version, one plan a round loop, and the action equals the
    reference's from the same state in every AllocState field."""
    open_ref, pre_ref = _ref_preempt()
    ref_st = _ref_pack(_world(world))
    pst, psess, entry = _preempt_entry(world)
    ref = pre_ref(ref_st, open_ref(ref_st)[0], _ref_state(entry))
    engines = ["sequential"] if world == "pod_affinity" else ["batched", "sequential"]
    for engine in engines:
        _CheckedClaim.binds = _CheckedClaim.launches = 0
        port = port_pre.preempt_action(pst, psess, entry, TIERS, turn_batch=engine == "batched")
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()), \
                (engine, f)
        assert port.rounds == int(ref.rounds)
        if engine == "batched":  # the sequential loop gates no round
            assert port.rounds_gated == int(ref.rounds_gated)
        assert _CheckedClaim.binds == 2, "one plan a phase's round loop"
        assert _CheckedClaim.launches >= port.rounds > 0
    phases = np.bincount(port.evict_phase.numpy(), minlength=3)
    assert phases[1] > 0, phases
    if world == "priority_mix":
        assert phases[2] > 0, phases
    assert _CheckedClaim.modes == {True, False} and _CheckedClaim.walked > 0
    assert _CheckedClaim.with_pa == {world == "pod_affinity"}
    assert torch.int64 in _CheckedClaim.g_dtypes


# ---------------------------------------------------------------- edges, turn by turn


@functools.lru_cache(maxsize=None)
def _ref_apply(mode):
    def apply(st, se, s, view, q, j, g, hg, req, budget, wr, need, victims, nr, nc):
        return ref_pre._apply_claim(st, se, s, REF_TIERS, 4096, mode, view, False, q, j, g, hg,
                                    req, budget, wr, need, victims, nr, nc)
    return jax.jit(apply)


def _edge_arrays(form):
    """A 2k x 200 evictive world (integral capacities), edited for
    ``form``."""
    a = {k: np.copy(v) for k, v in build_synthetic_arrays(
        2000, 200, num_queues=4, tasks_per_job=50, seed=5, running_fraction=0.5,
        fit_fraction=1.0)[0].items()}
    if form == "host ports":  # every claimant holds port 0; every third node has it taken
        a["group_ports"][:, 0] |= 1
        a["node_ports"][::3, 0] |= 1
    elif form == "pods full":  # every other node cannot take a pod
        a["node_max_tasks"][::2] = a["node_num_tasks"][::2]
    elif form == "uniform victims":  # one request for every task
        a["task_resreq"][:] = a["task_resreq"][a["task_valid"]][0]
    elif form == "mixed victims":  # runs of 7 tasks ask 100 more of the first resource
        a["task_resreq"][:, 0] += 100 * ((np.arange(a["task_resreq"].shape[0]) // 7) % 2)
    return a


def _first_turn(st, sess, state, view):
    """The first preempt turn (the first queue with a victim, in the
    round's order): its tensors as ``_apply_claim`` takes them."""
    q_active = port_pre._round_gate(st, sess, state, "preempt", view)
    _, perm = port_pre._queue_perm(st, sess, state, TIERS, q_active)
    shared = port_alloc._selection_shared(st, sess, state, TIERS, None)
    P = view.idx.shape[0]
    for qi in range(st.num_queues):
        q = perm[qi:qi + 1]
        j, g, has_grp, req, budget = port_alloc.select_turns(
            st, sess, state, TIERS, 4096, "preempt", shared, q, st.queue_valid[q] & q_active[q])
        was_ready = shared[3][j]
        need = (sess.min_avail[j] - state.job_ready_cnt[j]).clamp(min=0)
        budget = port_pre._phase_budget("preempt", budget, was_ready, need, has_grp,
                                        shared[0][g], 4096)
        scope = view.running(state.task_status) & (view.job != j) & (view.queue == q)
        victims = port_pre._victim_verdict(st, state, sess, TIERS, scope, j.expand(P),
                                           req.expand(P, req.shape[1]), view) & has_grp
        if int(victims.sum()):
            nr, nc = (x.clone() for x in view.layouts.by_node_queue.rank_and_cum(victims))
            return dict(q=q, j=j, g=g.to(torch.int64), has_grp=has_grp, req=req[0].clone(),
                        budget=budget, was_ready=was_ready, need=need, victims=victims,
                        node_rank=nr, node_cum=nc)
    raise AssertionError("no queue of the round has a victim")


EDGES = ("i64 g", "i32 g", "no victim", "keep false", "budget 0", "preempt_intra",
         "host ports", "pods full", "uniform victims", "mixed victims")
EDITED = ("host ports", "pods full", "uniform victims", "mixed victims")


@pytest.mark.parametrize("form", EDGES)
def test_claim_edges_match_reference_apply_claim(form):
    """One claim turn through ``_apply_claim`` with a bound plan against
    the reference's ``_apply_claim`` on the same turn: every state field."""
    arrays = _edge_arrays(form if form in EDITED else "plain")
    pst = from_numpy(arrays, "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    T = pst.num_tasks
    running0 = (pstate.task_status == RUNNING) & pst.task_valid & (pstate.task_node >= 0)
    pview = port_pre._build_view(pst, pstate, running0, T)
    turn = _first_turn(pst, psess, pstate, pview)
    mode = "preempt_intra" if form == "preempt_intra" else "preempt"
    if form == "i32 g":
        turn["g"] = turn["g"].to(torch.int32)
    elif form == "no victim":
        turn["victims"] = torch.zeros_like(turn["victims"])
    elif form == "keep false":
        turn.update(was_ready=torch.zeros_like(turn["was_ready"]),
                    budget=torch.full_like(turn["budget"], 4096),
                    need=torch.full_like(turn["need"], 4096))
    elif form == "budget 0":
        turn["budget"] = torch.zeros_like(turn["budget"])
    ref_st = _ref_pack(arrays)
    ref_sess, ref_state = _ref_preempt()[0](ref_st)
    ref_view = jax.jit(lambda s, a, r: ref_pre._build_view(s, a, r, T))(
        ref_st, ref_state, jnp.asarray(running0.numpy()))
    a = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    ref = _ref_apply(mode)(
        ref_st, ref_sess, ref_state, ref_view, a(turn["q"][0]).astype(jnp.int32),
        a(turn["j"][0]).astype(jnp.int32), a(turn["g"][0]).astype(jnp.int32),
        a(turn["has_grp"][0]), a(turn["req"]), a(turn["budget"][0]), a(turn["was_ready"][0]),
        a(turn["need"][0]), a(turn["victims"]), a(turn["node_rank"]), a(turn["node_cum"]))
    plan = k6.ClaimNodesPlan(pst, pview, 4096, mode == "preempt", True,
                             port_pre._pa_plan(pst, TIERS), aggregates=True)
    pstate.progress = torch.zeros((), dtype=torch.bool)
    port_pre._apply_claim(pst, psess, pstate, TIERS, 4096, mode, pview, turn["q"], turn["j"],
                          turn["g"], turn["has_grp"], turn["req"], turn["budget"],
                          turn["was_ready"], turn["need"], turn["victims"], turn["node_rank"],
                          turn["node_cum"], claim=plan)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(pstate, f).numpy()), (form, f)
    placed = plan.placed.tolist()
    evicts = int(plan.evict.sum())
    nv, tot, vmax, vmin = plan.aggs
    if form in ("no victim",):
        assert placed == [0, 0] and evicts == 0
    elif form in ("keep false",):
        assert placed[0] == 0 < placed[1] and evicts == 0
    elif form == "budget 0":
        assert placed == [0, 0] and evicts == 0 and int(nv.sum()) > 0
    else:
        assert placed[0] > 0 and evicts > 0, (form, placed)
    if form == "host ports":
        assert int(plan.p.max()) == 1 and bool((plan.p[::3] == 0).all())
    if form == "pods full":
        assert bool((plan.p[::2] == 0).all()) and int(nv[::2].sum()) > 0
    many = nv > 1
    uniform = ((vmax - vmin) <= k6.EPS).all(dim=-1) & many
    if form == "uniform victims":
        assert bool(uniform[many].all()) and int(many.sum()) > 0
    elif form == "mixed victims":
        assert int(uniform.sum()) < int(many.sum()), "some node's victims differ in size"
    walk = _walk(pview.node, pview.node_order, pview.resreq, turn["victims"], pst.num_nodes)
    for x, y in zip(plan.aggs, walk):
        assert torch.equal(x, y)


def test_folded_aggregates_match_k4_order_and_reference():
    """On a real turn's victims: the kernel's walk == ``claim_aggregates``
    (K4's slot-order sums, the scatter max / min) == the reference's
    scatter expression; ``freed``'s walk over the evicted slots == K4."""
    arrays = _edge_arrays("plain")
    pst = from_numpy(arrays, "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    running0 = (pstate.task_status == RUNNING) & pst.task_valid & (pstate.task_node >= 0)
    view = port_pre._build_view(pst, pstate, running0, pst.num_tasks)
    turn = _first_turn(pst, psess, pstate, view)
    N, victims = pst.num_nodes, turn["victims"]
    got = k6.claim_aggregates(view.node, view.node_order, view.resreq, victims, N)
    walk = _walk(view.node, view.node_order, view.resreq, victims, N)
    for a, b in zip(got, walk):
        assert torch.equal(a, b)
    vsel = jnp.asarray(torch.where(victims, view.node, N).numpy())
    vres = jnp.asarray(view.resreq.numpy())
    vm = jnp.asarray(victims.numpy())[:, None]
    R = vres.shape[1]
    ref_tot = jnp.zeros((N + 1, R), jnp.float32).at[vsel].add(jnp.where(vm, vres, 0.0))[:N]
    ref_max = jnp.full((N + 1, R), -BIG).at[vsel].max(jnp.where(vm, vres, -BIG))[:N]
    ref_min = jnp.full((N + 1, R), BIG).at[vsel].min(jnp.where(vm, vres, BIG))[:N]
    ref_nv = jnp.zeros(N + 1, jnp.int32).at[vsel].add(vm[:, 0].astype(jnp.int32))[:N]
    for a, b in zip(got, (ref_nv, ref_tot, ref_max, ref_min)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert int((got[0] > 1).sum()) > 0
    p, cum, placed, evict, freed = k6.ClaimNodesPlan(pst, view, 4096, True, True)(
        turn["victims"], turn["node_rank"], turn["node_cum"], pstate.node_ports,
        pstate.node_num_tasks, turn["g"], turn["req"], turn["budget"], turn["has_grp"],
        turn["was_ready"], turn["need"])
    assert int(evict.sum()) > 0
    k4 = segment_sum_plain(torch.where(evict[:, None], view.resreq, 0.0), view.node, N,
                           order=view.node_order)
    assert torch.equal(freed, k4)
    assert torch.equal(freed, _walk(view.node, view.node_order, view.resreq, evict, N)[1])


def test_claim_plan_owns_its_outputs_and_binds_pa_once():
    """The plan writes every launch into the same tensors (the next turn
    overwrites them, on the CPU too), and ``_claim_plan`` binds K11's and
    K12's plans where pod affinity is on."""
    pst = from_numpy(_world("pod_affinity"), "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    running0 = (pstate.task_status == RUNNING) & pst.task_valid & (pstate.task_node >= 0)
    view = port_pre._build_view(pst, pstate, running0, pst.num_tasks)
    plan = port_pre._claim_plan(pst, TIERS, view, 4096, "preempt")
    assert plan.pa is not None and plan.preempt_mode
    assert port_pre._claim_plan(pst, port_ord.DEFAULT_TIERS, view, 4096, "preempt_intra") \
        .preempt_mode is False
    turn = _first_turn(pst, psess, pstate, view)
    plan.pa[0](turn["g"], pstate.task_status, pstate.task_node)
    args = [turn[k] for k in ("victims", "node_rank", "node_cum")] + [
        pstate.node_ports, pstate.node_num_tasks] + [
        turn[k] for k in ("g", "req", "budget", "has_grp", "was_ready", "need")]
    first = [x.clone() for x in plan(*args)]
    again = plan(*args[:5], *args[5:])
    assert again[0] is plan.p and again[3] is plan.evict
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    none = plan(torch.zeros_like(args[0]), *args[1:])
    assert none[0] is plan.p and int(plan.placed[1]) == 0 and int(plan.evict.sum()) == 0


@pytest.mark.parametrize("N", [1, 31, 500, 5120, 20_480, 100_003])
def test_claim_node_split_covers_every_node_once_in_order(N):
    """csrc/claim_nodes.cu's split of N nodes, mirrored: a CTA a balanced
    run of nodes, 60 a round (a half-warp of walking warp w < 30 walks
    node 2 * w + half, capacity lane ci = tid - 960 computes node ci's
    capacity, warp 0's lane l fills nodes 2l and 2l + 1), over the grids
    of one H100 (86 to 132 CTAs) and a small card: each role covers
    [0, N) once, and the fill runs in node order."""
    ROUND = 60
    for capacity in (132, 264, 7):
        grid = min(-(-N // ROUND), capacity)
        walked, capped, filled = [], [], []
        for b in range(grid):
            lo, hi = b * N // grid, (b + 1) * N // grid
            for r0 in range(lo, hi, ROUND):
                rcnt = min(ROUND, hi - r0)
                walked += [r0 + 2 * w + h for w in range(30) for h in range(2)
                           if 2 * w + h < rcnt]
                capped += [r0 + tid - 960 for tid in range(960, 1024) if tid - 960 < rcnt]
                filled += [r0 + i for lane in range(32) for i in (2 * lane, 2 * lane + 1)
                           if i < rcnt]
        assert sorted(walked) == sorted(capped) == list(range(N))
        assert filled == list(range(N))


# ---------------------------------------------------------------- K16


def _mirror_compact(mask, cap, pad, tiles, span):
    """csrc/stable_compact.cu's arithmetic, span by span: each span's
    count, the counts before it, its ranks below cap, and its share of
    the pads [count, cap)."""
    K, L = mask.shape
    idx = np.full((K, cap), 12345, np.int64)
    count = np.zeros(K, np.int64)
    m = mask.numpy()
    for k in range(K):
        counts = [int(m[k, t * span:min(L, (t + 1) * span)].sum()) for t in range(tiles)]
        total = sum(counts)
        ospan = -(-cap // tiles)
        for t in range(tiles):
            base = sum(counts[:t])
            pos = np.nonzero(m[k, t * span:min(L, (t + 1) * span)])[0] + t * span
            for r, i in enumerate(pos):
                if base + r < cap:
                    idx[k, base + r] = i
            idx[k, max(total, t * ospan):min(cap, (t + 1) * ospan)] = pad
        count[k] = total
    return torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(count.astype(np.int32))


@pytest.mark.parametrize("K,L,cap,density", [
    (1, 102_400, 51_200, 0.6), (1, 102_400, 51_200, 0.3), (1, 101_623, 5000, 0.5),
    (2, 30_000, 1, 0.5), (3, 10_240, 2560, 0.9), (1, 5000, 4096, 0.0), (1, 0, 16, 0.5),
    (4, 2049, 3000, 0.7)])
def test_compact_launch_shape_and_span_arithmetic(K, L, cap, density):
    """Each launch shape (capacities of one and four H100-sized grids)
    covers every row with spans that are multiples of the chunk, keeps
    K x tiles within the capacity when a row has more than one span, and
    the kernel's span / pad arithmetic on it gives the plain result."""
    rng = np.random.default_rng(K * 7 + L)
    mask = torch.from_numpy(rng.random((K, L)) < density)
    want = k16.stable_compact_plain(mask, cap, -1)
    for capacity in (1056, 132, 3):
        tiles, span = k16.launch_shape(K, L, capacity)
        assert span % k16.CHUNK == 0 and span >= k16.CHUNK and tiles * span >= L
        assert tiles == 1 or (K * tiles <= capacity and (tiles - 1) * span < L)
        got = _mirror_compact(mask, cap, -1, tiles, span)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cap", [1, 37, 200, 512, 1000])
def test_compact_pair_matches_reference_compact_indices(cap):
    """The commit's two lists from one call (``stable_compact_pair``, as
    ``commit_cycle`` calls it) against the reference's
    ``_compact_indices`` of each: -1 padded, the full count past cap, both
    views of one buffer (or of ``out``)."""
    rng = np.random.default_rng(cap)
    bind, evict = rng.random(700) < 0.4, rng.random(700) < 0.05
    ref = jax.jit(lambda m, c: ref_cycle._compact_indices(m, c, False), static_argnums=1)
    (bi, bc), (ei, ec) = k16.stable_compact_pair(torch.from_numpy(bind), cap, -1,
                                                 torch.from_numpy(evict), cap // 2 + 1, -1)
    for (i, c), m, cp in (((bi, bc), bind, cap), ((ei, ec), evict, cap // 2 + 1)):
        wi, wc = ref(jnp.asarray(m), cp)
        assert np.array_equal(np.asarray(wi), i.numpy()) and int(wc) == int(c) == int(m.sum())
        assert i.dtype == c.dtype == torch.int32 and c.dim() == 0 and i.shape == (cp,)
    assert bi.untyped_storage().data_ptr() == ei.untyped_storage().data_ptr()
    out = tuple(t for row in k16._outputs(((1, cap), (1, 9)), "cpu") for t in row)
    (oi, oc), _ = k16.stable_compact_pair(torch.from_numpy(bind), cap, -1,
                                          torch.from_numpy(evict), 9, -1, out=out)
    assert oi.data_ptr() == out[0].data_ptr() and torch.equal(oi, bi)


def test_compact_rows_and_cells_match_reference_with_k_rows():
    """B4 with K > 1 request classes: ``_compact_rows`` of the cells
    (FeasCells, evaluated in the launch) against the reference's
    ``_compact_rows`` of its ``_prune_feasible`` mask, with ``out=``."""
    arrays = {k: np.copy(v) for k, v in build_synthetic_arrays(
        3000, 300, num_queues=4, tasks_per_job=20, seed=9, running_fraction=0.3,
        fit_fraction=1.0)[0].items()}
    # three request classes over one more predicate class, held by every
    # third node: the first fits every node class, the second all but the
    # new one, the third none
    CN = arrays["class_fit"].shape[1] + 1
    arrays["node_klass"][::3] = CN - 1
    arrays["class_fit"] = np.stack([np.ones(CN, bool), np.arange(CN) != CN - 1,
                                    np.zeros(CN, bool)])
    G = arrays["group_klass"].shape[0]
    arrays["group_klass"] = (np.arange(G) % 3).astype(np.int32)
    pst = from_numpy(arrays, "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    ref_st = _ref_pack(arrays)
    ref_sess, ref_state = _ref_preempt()[0](ref_st)
    N = pst.num_nodes
    for best_effort in (False, True):
        cells = port_alloc._prune_cells(pst, pstate, TIERS, best_effort)
        feas = ref_alloc._prune_feasible(ref_st, ref_state, REF_TIERS, best_effort)
        assert cells.shape[0] == 3 and np.array_equal(np.asarray(feas), cells.mask().numpy())
        for NC in (N // 8, N // 4, N):
            want = np.asarray(ref_alloc._compact_rows(feas, NC))
            out = k16._outputs(((3, NC),), "cpu")[0]
            idx, count = k16.stable_compact(cells, NC, N, out=out)
            assert idx is out[0] and np.array_equal(want, idx.numpy()), (best_effort, NC)
            assert np.array_equal(np.asarray(feas).sum(1), count.numpy())
        counts = np.asarray(feas).sum(1)
        assert counts[2] == 0 and counts[0] > counts[1] > 0


@pytest.mark.parametrize("P_div", [1, 2])
def test_compact_view_panel_matches_reference_build_view(P_div):
    """B11: the preempt view's panel of the running tasks (P = T) and of a
    thinned qualifying mask (P = T // 2) against the reference's
    ``_build_view``."""
    arrays = _edge_arrays("plain")
    pst = from_numpy(arrays, "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    ref_st = _ref_pack(arrays)
    _, ref_state = _ref_preempt()[0](ref_st)
    T = pst.num_tasks
    running0 = (pstate.task_status == RUNNING) & pst.task_valid & (pstate.task_node >= 0)
    qualify = running0 & (torch.arange(T) % 2 == 0) if P_div == 2 else running0
    P = T // P_div
    assert int(qualify.sum()) <= P
    view = jax.jit(lambda s, a, q: ref_pre._build_view(s, a, q, P))(
        ref_st, ref_state, jnp.asarray(qualify.numpy()))
    pview = port_pre._build_view(pst, pstate, qualify, P)
    for f in ("idx", "valid", "job", "queue", "node", "priority", "resreq"):
        assert np.array_equal(np.asarray(getattr(view, f)), getattr(pview, f).numpy()), f


# ---------------------------------------------------------------- the structs


def _c_struct(source: str, struct: str):
    """[(name, is_pointer)] of ``struct <struct>`` in csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            m = re.match(r"([\w\s]+?)(\**)\s*(\w+(?:\s*,\s*\w+)*)$", decl)
            fields += [(n.strip(), bool(m.group(2))) for n in m.group(3).split(",")]
    return fields


@pytest.mark.parametrize("mod,source,struct", [
    (k6, "claim_nodes", "Static"), (k6, "claim_nodes", "Call"),
    (k16, "stable_compact", "Static"), (k16, "stable_compact", "Call")])
def test_plan_structs_mirror_the_c_structs(mod, source, struct):
    got = [(name, typ is ctypes.c_void_p) for name, typ in getattr(mod, f"_{struct}")._fields_]
    assert got == _c_struct(source, struct)
