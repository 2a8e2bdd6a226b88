"""K14's ``UnionFitPlan`` and K15's ``WindowGatePlan`` on the CPU, held
against the JAX package (the card's twins, which hold each kernel
against its plain version, are in tests/test_torch_gate_fit_card.py).

* Every launch of a whole optimistic action and a whole round-batched
  action (5k tasks x 500 nodes, 64 queues), through the plans the
  engines bind: each pick against the plain version and the reference's
  ``_union_minus_own`` + ``_fit_feasible`` first fit, the kernel's
  block-restricted search against the whole-``skey`` search on the
  launch's rows, and each gate against the reference's gate; each engine
  binds each plan once and decides as the reference's engine.
* Edge cases: rows at or past the trip through ``ctl``; a first claim at
  row 0, only at the last row, and none; every pick at the last
  schedulable node; i32 and i64 q; one row (RP = 1).
* The block search (csrc/union_fit.cu's, step for step) against the
  whole-``skey`` search on real packs and on hand-made keys: empty
  blocks, a queue absent from a block, the first and the last node, the
  padding.
* The plans' ctypes structs against the C structs.

Inputs are made with numpy from a seed.  Every comparison is exact.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15

REF_TIERS = ref_ord.DEFAULT_TIERS
TIERS = port_ord.DEFAULT_TIERS
FIELDS = ("task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed", "job_alloc",
          "queue_alloc", "node_num_tasks", "node_releasing", "node_ports", "evict_claimant",
          "evict_phase", "evict_round")
ENGINES = {"batched": ("_reclaim_canon_batched", True),
           "optimistic": ("_reclaim_canon_optimistic", "optimistic")}


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


@functools.lru_cache(maxsize=None)
def _world():
    """The reference pack of a 5k x 500 world with 64 queues, half its
    tasks running (integral capacities, so every sum is exact)."""
    return ref_synth(num_tasks=5000, num_nodes=500, num_queues=64, tasks_per_job=20, seed=3,
                     running_fraction=0.5, fit_fraction=1.25).tensors


def _port(st):
    pst = from_numpy(pack_arrays(st), "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    return pst, psess, pstate


# ---------------------------------------------------------------- reference pieces


@functools.lru_cache(maxsize=None)
def _ref_first_fit(preds_on):
    """The reference's first fit of each row: ``_union_minus_own`` then
    ``_fit_feasible``, the lowest feasible node (N where none)."""

    def picks(st, node_ports, node_num_tasks, skey, segcum, pn, q, g, hg, req, pop):
        N = pn.shape[0]
        Q = st.queue_valid.shape[0]
        nd_keys = jnp.arange(N, dtype=jnp.int32) * (Q + 1)
        ctx = types.SimpleNamespace(skey=skey)
        state = types.SimpleNamespace(node_ports=node_ports, node_num_tasks=node_num_tasks)

        def one(q_, g_, hg_, rq, pp):
            vc, vr = ref_pre._union_minus_own(ctx, nd_keys, segcum, pn, q_, skey.shape[0])
            feas = ref_pre._fit_feasible(st, state, preds_on, g_, hg_, rq, pp, vc, vr)
            return jnp.where(jnp.any(feas), jnp.argmin(jnp.where(feas, jnp.arange(N), N)), N)

        return jax.vmap(one)(q, g, hg, req, pop)

    return jax.jit(picks)


def _ref_fit(st, plan, q, g, has_grp, pop, req):
    """The reference's picks for one launch of ``plan`` on its rows."""
    skey, segcum, pn, node_ports, node_num_tasks = plan.state
    a = jnp.asarray
    return np.asarray(_ref_first_fit(plan.preds_on)(
        st, a(node_ports.numpy()), a(node_num_tasks.numpy()), a(skey.numpy()),
        a(segcum.numpy()), a(pn.numpy()), a(q.to(torch.int32).numpy()),
        a(g.to(torch.int32).numpy()), a(has_grp.numpy()), a(req.reshape(plan.rows, -1).numpy()),
        a(pop.numpy())))


def _ref_gate(pick, N, start, trip, q_panel, jp, popp, burnp, q_entries, job_consumed):
    """The reference's commit gate (preempt.py:2737-2800) in jnp."""
    RP = pick.shape[0]
    w_iota = jnp.arange(RP, dtype=jnp.int32)
    in_window = start + w_iota < trip
    claimed_spec = pick < N
    has_claim = jnp.any(claimed_spec)
    first = jnp.where(has_claim, jnp.argmax(claimed_spec).astype(jnp.int32), jnp.int32(RP))
    commit_mask = in_window & (w_iota < first)
    burn_or_fail = commit_mask & (burnp | popp)
    Q, J = q_entries.shape[0], job_consumed.shape[0]
    q_entries = q_entries.at[jnp.where(burn_or_fail, q_panel, Q)].add(-1, mode="drop")
    job_consumed = job_consumed.at[jnp.where(commit_mask & popp, jp, J)].set(True, mode="drop")
    progressed = jnp.any(commit_mask & popp)
    conflicts = jnp.sum((claimed_spec & (w_iota > first)).astype(jnp.int32))
    start_next = start + jnp.sum(commit_mask.astype(jnp.int32)) + has_claim.astype(jnp.int32)
    round_done = start_next >= trip
    gated = round_done & (start == 0) & ~has_claim
    return dict(q_entries=q_entries, job_consumed=job_consumed, progressed=progressed,
                conflicts=conflicts, start=jnp.where(round_done, 0, start_next),
                round_done=round_done, gated=gated, has_claim=has_claim,
                s=jnp.minimum(first, RP - 1))


def _block_search(skey, bstart, q, num_queues):
    """(pos i64[S, N], hit bool[S, N]) of the kernel's search for the
    queues ``q`` i64[S]: a binary search over node n's block
    ``[bstart[n], bstart[n + 1])`` only, for the last slot whose key is at
    most ``n * (Q + 1) + q``, tracking whether that slot's key equals
    (csrc/union_fit.cu, step for step).  ``pos`` is the block start minus
    one where no slot of the block is at most the key."""
    N = bstart.shape[0] - 1
    Vp = skey.shape[0]
    nodes = torch.arange(N, dtype=torch.int64, device=skey.device)
    keys = nodes[None, :] * (num_queues + 1) + q[:, None]
    b = bstart.to(torch.int64)
    lo = b[None, :-1].expand_as(keys).clone()
    length = (b[1:] - b[:-1])[None, :].expand_as(keys).clone()
    right = torch.zeros_like(keys, dtype=torch.bool)
    eq = torch.zeros_like(right)
    while bool((length > 0).any()):
        live = length > 0
        half = length >> 1
        m = lo + half
        v = skey[m.clamp(0, Vp - 1)].to(torch.int64)
        go = live & (v <= keys)
        lo = torch.where(go, m + 1, lo)
        length = torch.where(go, length - half - 1, torch.where(live, half, length))
        right |= go
        eq = torch.where(go, v == keys, eq)
    return lo - 1, right & eq


def _whole_search(skey, q, Q, N):
    """(pos, hit) of the reference's search over the whole skey."""
    keys = torch.arange(N, dtype=torch.int64)[None, :] * (Q + 1) + q[:, None]
    pos = torch.searchsorted(skey, keys.to(torch.int32), right=True) - 1
    hit = (pos >= 0) & (skey[pos.clamp(0, skey.shape[0] - 1)] == keys)
    return pos, hit


def _assert_searches_agree(skey, bstart, q, Q):
    """The kernel's block search finds the whole search's hits, at the
    same slots."""
    N = bstart.shape[0] - 1
    pos_b, hit_b = _block_search(skey, bstart, q.to(torch.int64), Q)
    pos_w, hit_w = _whole_search(skey, q.to(torch.int64), Q, N)
    assert torch.equal(hit_b, hit_w)
    assert torch.equal(pos_b[hit_b], pos_w[hit_w])
    return int(hit_w.sum())


# ---------------------------------------------------------------- checked plans


class _CheckedFit(k14.UnionFitPlan):
    """A K14 plan whose every launch is held against the plain version,
    the kernel's block search and the reference's first fit."""

    ref_st = None
    binds = launches = claims = hits = 0
    q_dtypes = set()

    def __init__(self, *a, **kw):
        type(self).binds += 1
        super().__init__(*a, **kw)

    def __call__(self, q, g, has_grp, pop, req, ctl=None):
        cls = type(self)
        cls.launches += 1
        cls.q_dtypes.add(q.dtype)
        live = pop if ctl is None else pop & k14.in_window(ctl, self.rows)
        skey, segcum, pn, node_ports, node_num_tasks = self.state
        want = k14.union_fit_plain(self.st, skey, segcum, pn, q, g, has_grp, live,
                                   req.reshape(self.rows, -1), node_ports, node_num_tasks,
                                   self.preds_on)
        got = super().__call__(q, g, has_grp, pop, req, ctl)
        assert got is self.pick and torch.equal(got, want)
        assert np.array_equal(_ref_fit(cls.ref_st, self, q, g, has_grp, live, req), got.numpy())
        cls.hits += _assert_searches_agree(skey, self.st.rv_block_start, q, self.st.num_queues)
        cls.claims += int((got < self.st.num_nodes).sum())
        return got


class _CheckedGate(k15.WindowGatePlan):
    """A K15 plan whose every launch is held against the reference's gate
    on the state it found."""

    binds = launches = claims = 0

    def __init__(self, *a, **kw):
        type(self).binds += 1
        super().__init__(*a, **kw)

    def __call__(self, q_panel, reqp, progress):
        cls = type(self)
        cls.launches += 1
        pick, jp, gp, hgp, popp, burnp = self.rows
        q_entries, job_consumed = self.carry
        a = jnp.asarray
        start, trip = int(self.ctl[k15.START]), int(self.ctl[k15.TRIP])
        before = dict(ctl=self.ctl.clone(), progress=bool(progress))
        want = _ref_gate(a(pick.numpy()), self.N, jnp.int32(start), jnp.int32(trip),
                         a(q_panel.to(torch.int32).numpy()), a(jp.numpy()), a(popp.numpy()),
                         a(burnp.numpy()), a(q_entries.numpy()), a(job_consumed.numpy()))
        sel = super().__call__(q_panel, reqp, progress)
        ctl = self.ctl
        assert np.array_equal(np.asarray(want["q_entries"]), q_entries.numpy())
        assert np.array_equal(np.asarray(want["job_consumed"]), job_consumed.numpy())
        assert bool(progress) == (before["progress"] or bool(want["progressed"]))
        s, has_claim = int(want["s"]), bool(want["has_claim"])
        assert int(ctl[k15.START]) == int(want["start"])
        assert int(ctl[k15.ROUND_DONE]) == int(want["round_done"])
        for k, inc in ((k15.ROUNDS, want["round_done"]), (k15.GATED, want["gated"]),
                       (k15.CONFLICTS, want["conflicts"]), (k15.WINDOWS, 1)):
            assert int(ctl[k]) == int(before["ctl"][k]) + int(inc), k
        assert int(ctl[k15.PROGRESS]) == int(bool(progress))
        assert sel[0].tolist() == [int(q_panel[s]), int(jp[s]), int(gp[s]), int(pick[s])]
        assert sel[1].tolist() == [bool(hgp[s]), bool(popp[s]), bool(burnp[s]), has_claim]
        assert torch.equal(sel[2], reqp[s])
        cls.claims += has_claim
        return sel


class _CheckedCommit(port_pre.CanonCommitPlan):
    """A K8 plan that holds the progress word it is given (the window's
    ``ctl[PROGRESS]``) to the round's progress after every launch."""

    words = 0

    def __call__(self, *a, progress_out=None, **kw):
        super().__call__(*a, progress_out=progress_out, **kw)
        if progress_out is not None:
            type(self).words += 1
            assert int(progress_out) == int(bool(self.state.progress))


@pytest.fixture
def checked(monkeypatch):
    for cls in (_CheckedFit, _CheckedGate):
        for name in ("binds", "launches", "claims"):
            monkeypatch.setattr(cls, name, 0)
    monkeypatch.setattr(_CheckedCommit, "words", 0)
    monkeypatch.setattr(port_pre, "CanonCommitPlan", _CheckedCommit)
    monkeypatch.setattr(_CheckedFit, "hits", 0)
    monkeypatch.setattr(_CheckedFit, "q_dtypes", set())
    monkeypatch.setattr(_CheckedFit, "ref_st", _world())
    monkeypatch.setattr(port_pre, "UnionFitPlan", _CheckedFit)
    monkeypatch.setattr(port_pre, "WindowGatePlan", _CheckedGate)


@functools.lru_cache(maxsize=None)
def _ref_engine(name):
    return jax.jit(lambda st, se, s: getattr(ref_pre, name)(st, se, s, REF_TIERS, 100_000))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_every_launch_of_an_engine_matches_reference(checked, engine):
    """A whole action of each opt-in engine through checked plans: every
    K14 launch equals the plain version and the reference's first fit
    (and the block search the whole search), every K15 launch the
    reference's gate; each plan bound once; K14 once a turn (a window),
    K15 once a window; the engine decides as the reference's engine."""
    name, turn_batch = ENGINES[engine]
    st = _world()
    sess, state = jax.jit(lambda s: ref_cycle.open_session(s, REF_TIERS))(st)
    ref = _ref_engine(name)(st, sess, state)
    pst, psess, pstate = _port(st)
    port = port_pre.reclaim_action(pst, psess, pstate, TIERS, turn_batch=turn_batch)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()), f
    assert port.rounds == int(ref.rounds)
    assert port.rounds_gated == int(ref.rounds_gated)
    assert port.claim_conflicts == int(ref.claim_conflicts)
    assert _CheckedFit.binds == 1 and _CheckedFit.claims > 0 and _CheckedFit.hits > 0
    if engine == "optimistic":
        assert _CheckedGate.binds == 1 and _CheckedGate.claims > 0
        assert _CheckedFit.launches == _CheckedGate.launches == port.windows
        assert _CheckedCommit.words == port.windows
        assert port.claim_conflicts > 0
        assert _CheckedFit.q_dtypes == {torch.int64}
    else:
        assert _CheckedGate.binds == 0 and _CheckedFit.launches > port.rounds
        assert _CheckedCommit.words == 0
    assert (port.evict_phase.numpy() == 3).sum() > 0


# ---------------------------------------------------------------- the first window


@functools.lru_cache(maxsize=None)
def _window():
    """The optimistic engine's first window of the 5k x 500 world: its
    pops, products, panel and trip (the plans bind them as the engine
    does)."""
    st = _world()
    pst, psess, pstate = _port(st)
    pstate.progress = torch.zeros((), dtype=torch.bool)
    use_gang, use_prop, preds_on = port_pre._reclaim_flags(TIERS)
    ctx = port_pre._canon_ctx(pst, psess)
    carry = port_pre._canon_seed(pst, pstate, ctx)
    RP = port_pre._reclaim_panel(pst)
    nq, perm = port_pre._canon_round_order(pst, psess, TIERS, pstate, carry)
    pops = port_pre._pick_pops(pst, psess, TIERS)
    shared = port_pre._reclaim_shared(pst, psess, pstate, TIERS, carry.job_consumed)
    q_panel = perm[:RP].clone()
    rows = port_pre.reclaim_select_turns(pst, psess, pstate, TIERS, shared, q_panel,
                                         carry.q_entries, pops)
    products = port_pre._products_plan(pst, psess, pstate, ctx, carry, use_gang, use_prop)
    products()
    return types.SimpleNamespace(st=st, pst=pst, state=pstate, ctx=ctx, carry=carry, RP=RP,
                                 trip=max(int(nq), 1), pops=pops, rows=rows, q_panel=q_panel,
                                 products=products, preds_on=preds_on)


def _fit(w, rows=None, pn=None):
    _, pn0, segcum = w.products.out
    return k14.UnionFitPlan(w.pst, w.ctx.skey, segcum, pn0 if pn is None else pn,
                            w.state.node_ports, w.state.node_num_tasks, w.preds_on,
                            w.RP if rows is None else rows)


def _ctl(start, trip):
    ctl, _ = k15.new_gate(1, "cpu")
    ctl[k15.START], ctl[k15.TRIP] = start, trip
    return ctl


@pytest.mark.parametrize("start_back", [None, 0, 3, 1])
def test_fit_plan_masks_rows_at_or_past_the_trip(start_back):
    """With ``ctl``, row r pops only where START + r < TRIP: the window at
    START 0, wholly past the trip, and 3 / 1 rows before it; the picks
    equal the reference's on the masked pops (N past the trip)."""
    w = _window()
    jp, gp, hgp, reqp, popp, burnp = w.rows
    RP, trip = w.RP, w.trip
    start = 0 if start_back is None else trip - start_back
    ctl = _ctl(start, trip)
    plan = _fit(w)
    got = plan(w.q_panel, gp, hgp, popp, reqp, ctl=ctl).clone()
    live = popp & (torch.arange(RP) + start < trip)
    assert torch.equal(got, _fit(w)(w.q_panel, gp, hgp, live, reqp))
    assert np.array_equal(_ref_fit(w.st, plan, w.q_panel, gp, hgp, live, reqp), got.numpy())
    n_live = max(0, min(RP, trip - start))
    assert (got[n_live:] == w.pst.num_nodes).all()
    if start_back in (None, 3):
        assert (got[:n_live] < w.pst.num_nodes).any()


def test_fit_plan_claims_first_last_and_none():
    """A first claim at row 0 (the first window), a claim only at the last
    row, and none (requests above every node's victims), each against the
    reference; the plan's pick is overwritten by each launch."""
    w = _window()
    jp, gp, hgp, reqp, popp, burnp = w.rows
    N = w.pst.num_nodes
    plan = _fit(w)
    first = plan(w.q_panel, gp, hgp, popp, reqp).clone()
    assert int(first[0]) < N
    c = int((first < N).nonzero()[-1, 0])
    q2, g2, h2, r2 = w.q_panel.clone(), gp.clone(), hgp.clone(), reqp.clone()
    q2[-1], g2[-1], h2[-1], r2[-1] = w.q_panel[c], gp[c], hgp[c], reqp[c]
    p2 = torch.zeros_like(popp)
    p2[-1] = True
    last = plan(q2, g2, h2, p2, r2)
    assert last is plan.pick
    assert (last[:-1] == N).all() and int(last[-1]) == int(first[c])
    assert np.array_equal(_ref_fit(w.st, plan, q2, g2, h2, p2, r2), last.numpy())
    big = torch.full_like(reqp, 3.0e38)
    assert (plan(w.q_panel, gp, hgp, popp, big) == N).all()


def test_fit_plan_picks_the_last_schedulable_node():
    """Every node's union count but the last schedulable node's cleared:
    the rows pick that node, as the reference's first fit does."""
    w = _window()
    jp, gp, hgp, reqp, popp, burnp = w.rows
    st = w.pst
    n_last = int((st.node_valid & ~st.node_unsched).nonzero()[-1, 0])
    _, pn, _ = w.products.out
    pn_last = pn.clone()
    pn_last[:, 0] = 0.0
    pn_last[n_last] = 1.0e9
    plan = _fit(w, pn=pn_last)
    got = plan(w.q_panel, gp, hgp, popp, reqp)
    assert (got == n_last).any() and ((got == n_last) | (got == st.num_nodes)).all()
    assert np.array_equal(_ref_fit(w.st, plan, w.q_panel, gp, hgp, popp, reqp), got.numpy())


@pytest.mark.parametrize("q_dtype,g_dtype", [(torch.int64, torch.int32),
                                             (torch.int32, torch.int32),
                                             (torch.int64, torch.int64)])
def test_fit_plan_reads_i32_and_i64_ordinals(q_dtype, g_dtype):
    w = _window()
    jp, gp, hgp, reqp, popp, burnp = w.rows
    want = _fit(w)(w.q_panel, gp, hgp, popp, reqp).clone()
    got = _fit(w)(w.q_panel.to(q_dtype), gp.to(g_dtype), hgp, popp, reqp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("req_shape", ["[R]", "[1, R]"])
def test_fit_plan_one_row(req_shape):
    """RP = 1, the batched engine's thin turn: each queue's row alone
    picks what it picks among the panel's rows."""
    w = _window()
    jp, gp, hgp, reqp, popp, burnp = w.rows
    want = _fit(w)(w.q_panel, gp, hgp, popp, reqp).clone()
    one = _fit(w, rows=1)
    for r in range(w.RP):
        req = reqp[r] if req_shape == "[R]" else reqp[r:r + 1]
        got = one(w.q_panel[r:r + 1], gp[r:r + 1], hgp[r:r + 1], popp[r:r + 1], req)
        assert got.shape == (1,) and int(got) == int(want[r]), r


# ---------------------------------------------------------------- the gate


def _gate_case(w, pick, start):
    """One WindowGatePlan launch over ``pick`` on copies of the carry,
    against the reference's gate."""
    jp, gp, hgp, reqp, popp, burnp = w.rows
    q_entries, job_consumed = w.carry.q_entries.clone(), w.carry.job_consumed.clone()
    progress = torch.zeros((), dtype=torch.bool)
    plan = k15.WindowGatePlan(pick, w.pst.num_nodes, jp, gp, hgp, popp, burnp, q_entries,
                              job_consumed, reqp.shape[1])
    plan.ctl[k15.START], plan.ctl[k15.TRIP] = start, w.trip
    a = jnp.asarray
    want = _ref_gate(a(pick.numpy()), w.pst.num_nodes, jnp.int32(start), jnp.int32(w.trip),
                     a(w.q_panel.to(torch.int32).numpy()), a(jp.numpy()), a(popp.numpy()),
                     a(burnp.numpy()), a(q_entries.numpy()), a(job_consumed.numpy()))
    sel = plan(w.q_panel, reqp, progress)
    assert np.array_equal(np.asarray(want["q_entries"]), q_entries.numpy())
    assert np.array_equal(np.asarray(want["job_consumed"]), job_consumed.numpy())
    assert bool(progress) == bool(want["progressed"])
    ctl = plan.ctl
    assert int(ctl[k15.START]) == int(want["start"])
    assert int(ctl[k15.ROUND_DONE]) == int(ctl[k15.ROUNDS]) == int(want["round_done"])
    assert int(ctl[k15.GATED]) == int(want["gated"])
    assert int(ctl[k15.CONFLICTS]) == int(want["conflicts"]) and int(ctl[k15.WINDOWS]) == 1
    s = int(want["s"])
    assert bool(sel[1][3]) == bool(want["has_claim"])
    assert int(ctl[k15.PROGRESS]) == int(bool(progress))
    assert sel[0].tolist() == [int(w.q_panel[s]), int(jp[s]), int(gp[s]), int(pick[s])]
    return ctl


@pytest.mark.parametrize("case", ["row 0", "last row", "none", "past the trip"])
def test_gate_plan_matches_reference(case):
    """K15's plan on the first window's rows: a first claim at row 0 (and
    conflicts), a claim only at the last row, no claim (a gated round),
    and a window 3 rows before the trip."""
    w = _window()
    jp, gp, hgp, reqp, popp, burnp = w.rows
    N = w.pst.num_nodes
    pick = _fit(w)(w.q_panel, gp, hgp, popp, reqp, ctl=_ctl(0, w.trip)).clone()
    start = 0
    if case == "last row":
        pick = torch.full_like(pick, N)
        pick[-1] = 1
    elif case == "none":
        pick = torch.full_like(pick, N)
    elif case == "past the trip":
        start = w.trip - 3
        pick = _fit(w)(w.q_panel, gp, hgp, popp, reqp, ctl=_ctl(start, w.trip)).clone()
    ctl = _gate_case(w, pick, start)
    if case == "row 0":
        assert int(pick[0]) < N and int(ctl[k15.CONFLICTS]) > 0
    if case == "none":
        assert int(ctl[k15.GATED]) == int(w.trip <= w.RP)


def test_gate_plan_binds_k2_own_pop_rows():
    """The optimistic engine's gate binds K2's plan-owned pop rows: the
    tensors a pop of RP rows returns are ``pop_rows(RP)``'s."""
    w = _window()
    assert all(a is b for a, b in zip(w.pops.pop_rows(w.RP),
                                      (w.rows[0], w.rows[1], w.rows[2], w.rows[4], w.rows[5])))


# ---------------------------------------------------------------- the block search


def test_block_search_matches_whole_search_on_real_packs():
    """Every queue of the 5k x 500 world's canon pack, at every node: the
    block search's hits and slots are the whole search's."""
    w = _window()
    st = w.pst
    hits = _assert_searches_agree(w.ctx.skey, st.rv_block_start,
                                  torch.arange(st.num_queues), st.num_queues)
    assert hits > 0


@pytest.mark.parametrize("seed", range(4))
def test_block_search_matches_whole_search_on_made_keys(seed):
    """Hand-made canon keys: empty blocks (the first node's among them),
    queues absent from a block, the last node with only the last queue,
    segments of one and of several slots, the padding sentinel past the
    last block."""
    rng = np.random.default_rng(seed)
    N, Q = 13, 6
    keys, bstart = [], [0]
    for n in range(N):
        if n in (0, 4, 5) or (n != N - 1 and rng.random() < 0.15):
            queues = []
        elif n == N - 1:
            queues = [Q - 1]
        else:
            queues = sorted(rng.choice(Q, int(rng.integers(1, Q)), replace=False))
        for q in queues:
            keys += [n * (Q + 1) + int(q)] * int(rng.integers(1, 5))
        bstart.append(len(keys))
    pad = 32
    skey = torch.tensor(keys + [N * (Q + 1) + Q] * pad, dtype=torch.int32)
    hits = _assert_searches_agree(skey, torch.tensor(bstart, dtype=torch.int32),
                                  torch.arange(Q), Q)
    assert hits > 0


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
    (k14, "union_fit", "Static"), (k14, "union_fit", "Call"),
    (k15, "window_gate", "Static"), (k15, "window_gate", "Call")])
def test_plan_structs_mirror_the_c_structs(mod, source, struct):
    got = [(name, typ is ctypes.c_void_p) for name, typ in getattr(mod, f"_{struct}")._fields_]
    assert got == _c_struct(source, struct)
